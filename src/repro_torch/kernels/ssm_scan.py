"""Mamba-1 selective scan, forward and backward: wrappers of the CUDA
kernels in ``csrc/ssm_scan.cu`` (the forward ports the JAX package's
Pallas kernel ``repro.kernels.ssm_scan``, K5; the backward computes the
gradient the JAX package takes with ``jax.vjp`` of ``selective_scan``).

u, dt ``[B, S, D]``, b, c ``[B, S, N]`` in one dtype (float32 or
bfloat16); a ``[G, D, N]`` and d ``[G, D]`` float32, where batch row i
uses group ``i // (B // G)`` (the client ``vmap`` folds each client's
own ``a``/``d`` into the groups; G = 1 shares them) -> y ``[B, S, D]`` in
u's dtype, any N >= 1.  The forward also returns the state after every
``CHUNK`` steps (and after the last step), ``[B, ceil(S / CHUNK), D, N]``
fp32, from which the backward kernel recomputes each tile instead of
walking the sequence again.

On a CPU tensor a wrapper computes the plain version in ``kernels/ref.py``;
on a ``meta`` tensor it returns empty outputs and counts nothing; on a CUDA
tensor it launches the kernels or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

CHUNK = 128         # steps between saved states: the kernels' time tile
SLAB = 32           # channels of a block: db/dc partials per slab
NG = 32             # states the kernels stage at a time; past it, fp32 sums
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset_launches(), counted where a wrapper
# launches them: ``ssm_scan`` the forward; ``ssm_scan_bwd`` the backward's
# scan kernel and ``ssm_scan_bwd_sum`` the kernel that adds its partials
# (``sum_partials``), one each per backward call.
LAUNCHES = {"ssm_scan": 0, "ssm_scan_bwd": 0, "ssm_scan_bwd_sum": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _shapes(u, dt, a, b, c, d):
    if u.dim() != 3 or a.dim() != 3 or d.dim() != 2:
        raise ValueError(f"need u [B,S,D], a [G,D,N], d [G,D]; got "
                         f"{tuple(u.shape)}, {tuple(a.shape)}, "
                         f"{tuple(d.shape)}")
    bsz, s, dim = u.shape
    g, n = a.shape[0], a.shape[2]
    if (dt.shape != u.shape or tuple(b.shape) != (bsz, s, n)
            or c.shape != b.shape or a.shape[1] != dim
            or tuple(d.shape) != (g, dim) or g == 0 or bsz % g):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, d "
                         f"{tuple(d.shape)}")
    return bsz, s, dim, n, g


def states_shape(bsz: int, s: int, dim: int, n: int) -> tuple:
    """The boundary states' shape: one ``[D, N]`` state per ``CHUNK``
    steps of each batch row."""
    return bsz, _cdiv(s, CHUNK), dim, n


def check_states(n: int) -> int:
    """The kernels take any state count N >= 1; returns the number of
    state groups they walk (more than one: fp32 sums across groups)."""
    if n < 1:
        raise ValueError(f"ssm_scan needs N >= 1 states, got {n}")
    return _cdiv(n, NG)


def _check_cuda(u, dt, a, b, c, d, gy=None):
    """Raises unless the kernels take these operands (and the cotangent
    ``gy``): one dtype for u, dt, b, c and gy, float32 a and d, contiguous,
    on u's device."""
    bsz, s, dim, n, g = _shapes(u, dt, a, b, c, d)
    acts = (u, dt, b, c) + (() if gy is None else (gy,))
    if u.dtype not in DTYPE_CODES or any(t.dtype != u.dtype for t in acts):
        raise ValueError(f"u, dt, b, c (and gy) must share a dtype in "
                         f"float32/bfloat16, got {[t.dtype for t in acts]}")
    if a.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError(f"a and d must be float32, got {a.dtype}, "
                         f"{d.dtype}")
    check_states(n)
    if bsz > 65535 or s == 0 or dim == 0:
        raise ValueError(f"B={bsz}, S={s}, D={dim} outside the launch grid")
    for t in acts + (a, d):
        if not t.is_contiguous() or t.device != u.device:
            raise ValueError(f"every operand must be contiguous on "
                             f"{u.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ssm_scan_fwd(u, dt, a, b, c, d):
    """``(y, states)`` of the Mamba-1 recurrence, state in fp32 (K5):
    ``states`` holds the state after every ``CHUNK`` steps and after the
    last, the residual :func:`ssm_scan_bwd` starts its tiles from."""
    bsz, s, dim, n, g = _shapes(u, dt, a, b, c, d)
    if u.device.type == "cpu":
        return ref.ssm_scan(u, dt, a, b, c, d, CHUNK)
    if u.device.type == "meta":
        return torch.empty_like(u), torch.empty(
            states_shape(bsz, s, dim, n), dtype=torch.float32,
            device="meta")
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, not {u.device}")
    _check_cuda(u, dt, a, b, c, d)
    groups = check_states(n)
    from repro_torch.kernels._build import load
    y = torch.empty_like(u)
    hs = torch.empty(states_shape(bsz, s, dim, n), dtype=torch.float32,
                     device=u.device)
    yacc = torch.empty(u.shape, dtype=torch.float32, device=u.device) \
        if groups > 1 else None
    err = load("ssm_scan").ssm_scan_fwd(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), y.data_ptr(), _ptr(yacc), hs.data_ptr(),
        bsz, s, dim, n, bsz // g, DTYPE_CODES[u.dtype], _stream(u))
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err}")
    LAUNCHES["ssm_scan"] += 1
    return y, hs


def _ptr(t):
    return None if t is None else t.data_ptr()


def ssm_scan_bwd(u, dt, a, b, c, d, gy, states, chunk: int = CHUNK):
    """Gradients ``(du, ddt, da, db, dc, dd)`` of :func:`ssm_scan_fwd` for
    the output cotangent ``gy``, in the inputs' dtypes, ``da`` and ``dd``
    summed over each group's batch rows.  On a CUDA tensor the kernels
    start each ``CHUNK``-step tile from ``states`` (the forward's); the
    plain version recomputes them in blocks of ``chunk`` steps."""
    bsz, s, dim, n, g = _shapes(u, dt, a, b, c, d)
    if gy.shape != u.shape:
        raise ValueError(f"gy {tuple(gy.shape)} must match u "
                         f"{tuple(u.shape)}")
    if u.device.type == "cpu":
        return ref.ssm_scan_bwd(u, dt, a, b, c, d, gy, chunk)
    if u.device.type == "meta":
        return tuple(torch.empty_like(t) for t in (u, dt, a, b, c, d))
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, not {u.device}")
    if tuple(states.shape) != states_shape(bsz, s, dim, n) \
            or states.dtype != torch.float32:
        raise ValueError(f"states must be float32 "
                         f"{states_shape(bsz, s, dim, n)}, got "
                         f"{states.dtype} {tuple(states.shape)}")
    du, ddt, part, rows_a, rows_d = _bwd_partials(u, dt, a, b, c, d, gy,
                                                  states)
    db, dc, da, dd = sum_partials(part, rows_a, rows_d, g, b.dtype)
    return du, ddt, da, db, dc, dd


def _bwd_partials(u, dt, a, b, c, d, gy, states):
    """The backward's scan kernel on CUDA tensors: ``du, ddt`` and the
    fp32 partials ``sum_partials`` adds: ``[2, slabs, B, N, S]`` (db, dc
    of each 32-channel slab, time innermost so a warp's writes coalesce)
    and ``[B, D, N]``, ``[B, D]`` (da, dd of each batch row)."""
    bsz, s, dim, n, g = _shapes(u, dt, a, b, c, d)
    # autograd hands the backward strided views (the vmap fold, gy)
    u, dt, a, b, c, d, gy, states = (t.contiguous() for t in (
        u, dt, a, b, c, d, gy, states))
    _check_cuda(u, dt, a, b, c, d, gy)
    if states.device != u.device:
        raise ValueError(f"states must be on {u.device}")
    from repro_torch.kernels._build import load
    f32 = {"dtype": torch.float32, "device": u.device}
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    part = torch.empty((2, _cdiv(dim, SLAB), bsz, n, s), **f32)
    rows_a = torch.empty((bsz, dim, n), **f32)
    rows_d = torch.empty((bsz, dim), **f32)
    acc = torch.empty((2, bsz, s, dim), **f32) if check_states(n) > 1 \
        else None
    err = load("ssm_scan").ssm_scan_bwd(
        *(t.data_ptr() for t in (u, dt, a, b, c, d, gy, states, du, ddt)),
        _ptr(acc), part[0].data_ptr(), part[1].data_ptr(),
        rows_a.data_ptr(), rows_d.data_ptr(), bsz, s, dim, n, bsz // g,
        DTYPE_CODES[u.dtype], _stream(u))
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd launch failed: cudaError {err}")
    LAUNCHES["ssm_scan_bwd"] += 1
    return du, ddt, part, rows_a, rows_d


def sum_partials(part, rows_a, rows_d, groups: int, dtype):
    """The backward's second step: ``db, dc [B, S, N]`` in ``dtype`` from
    the per-slab partials ``part [2, slabs, B, N, S]`` (summed over the
    slabs), ``da [G, D, N]`` and ``dd [G, D]`` float32 from the per-row
    partials ``rows_a [B, D, N]``, ``rows_d [B, D]`` (summed over each
    group's rows)."""
    _, slabs, bsz, n, s = part.shape
    dim = rows_d.shape[1]
    if (tuple(rows_a.shape) != (bsz, dim, n) or slabs != _cdiv(dim, SLAB)
            or groups < 1 or bsz % groups):
        raise ValueError(f"partials {tuple(part.shape)}, rows "
                         f"{tuple(rows_a.shape)}, {tuple(rows_d.shape)} "
                         f"and {groups} groups do not fit")
    if part.device.type == "cpu":
        return ref.ssm_scan_bwd_sum(part, rows_a, rows_d, groups, dtype)
    outs = (torch.empty((bsz, s, n), dtype=dtype, device=part.device),
            torch.empty((bsz, s, n), dtype=dtype, device=part.device),
            torch.empty((groups, dim, n), dtype=torch.float32,
                        device=part.device),
            torch.empty((groups, dim), dtype=torch.float32,
                        device=part.device))
    if part.device.type == "meta":
        return outs
    if part.device.type != "cuda" or dtype not in DTYPE_CODES:
        raise ValueError(f"sum_partials runs on cpu or cuda in float32/"
                         f"bfloat16, not {part.device} {dtype}")
    for t in (part, rows_a, rows_d):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != part.device:
            raise ValueError("partials must be contiguous float32 on one "
                             "device")
    from repro_torch.kernels._build import load
    err = load("ssm_scan").ssm_scan_bwd_sum(
        part[0].data_ptr(), part[1].data_ptr(), rows_a.data_ptr(),
        rows_d.data_ptr(), *(t.data_ptr() for t in outs), bsz, s, dim, n,
        bsz // groups, DTYPE_CODES[dtype], _stream(part))
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd_sum launch failed: cudaError "
                           f"{err}")
    LAUNCHES["ssm_scan_bwd_sum"] += 1
    return outs
