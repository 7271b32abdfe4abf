"""Mamba-1 selective scan, forward: wrapper of the CUDA kernel in
``csrc/ssm_scan.cu`` (port of the JAX package's Pallas kernel
``repro.kernels.ssm_scan``, K5).

u, dt ``[B, S, D]``, b, c ``[B, S, N]`` in one dtype (float32 or
bfloat16); a ``[G, D, N]`` and d ``[G, D]`` float32, where batch row i
uses group ``i // (B // G)`` (the client ``vmap`` folds each client's
own ``a``/``d`` into the groups; G = 1 shares them) -> y ``[B, S, D]`` in
u's dtype.  N is one of ``STATES``.  On a CPU tensor the wrapper computes
the plain version in ``kernels/ref.py``; on a ``meta`` tensor it returns an
empty output and counts nothing; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

STATES = (4, 8, 16, 32)             # the kernel's template instances (lanes)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset_launches(), one per wrapper call.
LAUNCHES = {"ssm_scan": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def ssm_scan_fwd(u, dt, a, b, c, d):
    """y of the Mamba-1 recurrence, state in fp32 (K5)."""
    bsz, s, dim, n, g = _shapes(u, dt, a, b, c, d)
    if u.device.type == "cpu":
        return ref.ssm_scan(u, dt, a, b, c, d)
    if u.device.type == "meta":
        return torch.empty_like(u)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, not {u.device}")
    if u.dtype not in DTYPE_CODES or any(t.dtype != u.dtype
                                         for t in (dt, b, c)):
        raise ValueError(f"u, dt, b, c must share a dtype in float32/"
                         f"bfloat16, got {u.dtype}, {dt.dtype}, {b.dtype}, "
                         f"{c.dtype}")
    if a.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError(f"a and d must be float32, got {a.dtype}, "
                         f"{d.dtype}")
    if n not in STATES:
        raise ValueError(f"ssm_scan takes N in {STATES}, got {n}")
    if bsz > 65535 or s == 0 or dim == 0:
        raise ValueError(f"B={bsz}, S={s}, D={dim} outside the launch grid")
    for t, what in ((u, "u"), (dt, "dt"), (a, "a"), (b, "b"), (c, "c"),
                    (d, "d")):
        if not t.is_contiguous() or t.device != u.device:
            raise ValueError(f"{what} must be contiguous on {u.device}")
    from repro_torch.kernels._build import load
    y = torch.empty_like(u)
    err = load("ssm_scan").ssm_scan_fwd(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), y.data_ptr(), bsz, s, dim, n, bsz // g,
        DTYPE_CODES[u.dtype], torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err}")
    LAUNCHES["ssm_scan"] += 1
    return y
