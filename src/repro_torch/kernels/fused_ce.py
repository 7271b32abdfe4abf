"""Fused linear + cross-entropy: wrappers of the CUDA kernels in
``csrc/fused_ce.cu`` (port of the JAX package's Pallas kernels
``repro.kernels.fused_ce``: K3 forward, K4a dx, K4b dw).

All are grouped: ``x [G, T, d]``, ``w [G, d, V]`` (a group stride of 0
shares one ``w`` or ``x`` across groups), ``labels [G, T]`` int32; the
client ``vmap`` folds its clients into ``G`` so one launch serves them all.

bf16 runs every logit product in one TMA + wgmma main loop.  The forward
(``launch_plan``): a block owns 128 token rows and one split of the
vocabulary, walks the split's 128-column tiles keeping each row's running
max, sum of exps and picked logit, and writes a partial per row and split;
a second pass combines the splits in order.  The backward walks the
vocabulary in chunks of ``Vc`` columns (``bwd_plan``): per chunk a P pass
writes ``P = (softmax(x w) - onehot) g/T`` in bf16 to a scratch
``[G, T, Vc]`` (at most ``P_CAP`` bytes), then the dx products add
``P w^T`` into fp32 partial sums ``[G, T, d]`` and the dw products write
``x^T P``.  ``fused_ce_bwd`` shares one P pass between dx and dw;
``fused_ce_dx`` and ``fused_ce_dw`` alone each run their own.  The wrapper
allocates the scratch; TMA reads x, w and P, so their rows must be 16-byte
multiples: where d is not a multiple of 8 it zero-pads x's rows and w's d
rows to the next one (zeros add nothing to ``x w``; dx and dw are sliced
back), copies w into rows padded to a multiple of 8 columns where V is not
one (no model's width or vocabulary needs either copy), and raises where a
base is not 16-byte aligned.  fp32 inputs take the CUDA-core kernels: the
forward on 64 x 64 tiles, the backward recomputing the logits per block.

On a CPU tensor a wrapper computes the plain version in ``kernels/ref.py``;
on a ``meta`` tensor it returns empty outputs of the right shapes and
counts nothing; on a CUDA tensor it launches the kernels or raises.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

# Tiles compiled into csrc/fused_ce.cu (the grids are computed here).
TILE = 128              # bf16: rows and columns of a block's output tile
FP32_TILE = 64          # fp32 K3: token rows per block and vocab tile
P_CAP = 256 * 2**20                 # bytes of the P scratch at most
GRID_YZ = 65535                     # CUDA's limit on gridDim.y and .z

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Wrapper calls since the last reset_launches(), counted where the call
# launches its kernels and nowhere else: ``fused_ce_fwd`` one per K3 call
# (its combine pass included); ``fused_ce_dx`` / ``fused_ce_dw`` one per
# call that ran the dx / dw products over every vocabulary chunk
# (``fused_ce_bwd`` counts one of each); ``fused_ce_p`` one per bf16 P pass
# over every chunk (one per ``fused_ce_bwd`` call, one per ``fused_ce_dx``
# or ``fused_ce_dw`` call alone).
LAUNCHES = {"fused_ce_fwd": 0, "fused_ce_dx": 0, "fused_ce_dw": 0,
            "fused_ce_p": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def vocab_splits(g: int, t: int, v: int, sms: int = 132, bf16: bool = True):
    """``(nsplit, tiles_per_split)`` of K3's vocabulary, every split
    non-empty.  bf16: one block (128 rows, 160 KB of shared memory) an SM
    at a time, so the split count that minimises the modelled time,
    ``ceil(blocks / sms)`` waves of ``tiles_per_split + 1`` tile times each
    (the 1: filling the ring and writing the partials), the fewest splits
    on a tie.  fp32: 64 x 64 tiles, about four blocks an SM."""
    if not bf16:
        blocks = g * _cdiv(t, FP32_TILE)
        nv = _cdiv(v, FP32_TILE)
        want = min(nv, max(1, _cdiv(4 * sms, blocks)))
        tps = _cdiv(nv, want)
        return _cdiv(nv, tps), tps
    rows, nv = g * _cdiv(t, TILE), _cdiv(v, TILE)
    best = None
    for want in range(1, nv + 1):
        tps = _cdiv(nv, want)
        ns = _cdiv(nv, tps)
        cost = _cdiv(rows * ns, sms) * (tps + 1)
        if best is None or cost < best[0]:
            best = (cost, ns, tps)
    return best[1], best[2]


def _check_grid(name, grid, g, t, d, v):
    gx, gy, gz = grid
    if gx > 2**31 - 1 or gy > GRID_YZ or gz > GRID_YZ:
        raise ValueError(f"{name}: grid {grid} exceeds CUDA's limits at "
                         f"G={g}, T={t}, d={d}, V={v}")


def _dpad(d: int) -> int:
    """d rounded up to a multiple of 8: 16-byte bf16 rows for TMA."""
    return _cdiv(d, 8) * 8


def bwd_plan(g: int, t: int, d: int, v: int) -> dict:
    """The bf16 backward for ``x [g, t, d]``, ``w [g, d, v]``: the chunk
    width ``vc`` (a multiple of ``TILE``, the largest that keeps the P
    scratch ``[g, t, vc]`` bf16 within ``P_CAP``, at most V rounded up; the
    kernels walk the chunks ``c0 = 0, vc, 2 vc, ...`` in order), w's padded
    row length ``ldw``, ``acc``, whether dx needs fp32 partial sums (more
    than one chunk), and ``dp``, the width the kernels run at (d padded to a
    multiple of 8).  Raises ``ValueError`` where a grid (T, d or vc tiles by
    the others, G groups) exceeds CUDA's limits."""
    dp = _dpad(d)
    vc = min(_cdiv(v, TILE), P_CAP // (2 * g * t) // TILE) * TILE
    if vc < TILE:
        raise ValueError(f"fused_ce bf16 backward: G*T = {g * t} rows leave "
                         f"no {TILE}-column chunk within {P_CAP} bytes")
    tt, dt, vt = _cdiv(t, TILE), _cdiv(dp, TILE), _cdiv(vc, TILE)
    _check_grid("fused_ce bwd", (max(tt, dt), max(dt, vt), g), g, t, d, v)
    return {"vc": vc, "ldw": _cdiv(v, 8) * 8, "acc": v > vc, "dp": dp}


def launch_plan(g: int, t: int, d: int, v: int, sms: int = 132,
                bf16: bool = True) -> dict:
    """K3's vocabulary split, grid ``(row tiles, vocab splits, g)``, w's
    row length ``ldw`` and the width ``dp`` the kernel runs at, for
    ``x [g, t, d]``, ``w [g, d, v]``: 128-row tiles and 128-column
    vocabulary tiles in bf16 (d padded to a multiple of 8), 64 and 64 in
    fp32 (any d).  Raises ``ValueError`` where the grid exceeds CUDA's
    limits."""
    nsplit, tps = vocab_splits(g, t, v, sms, bf16)
    grid = (_cdiv(t, TILE if bf16 else FP32_TILE), nsplit, g)
    _check_grid("fused_ce_fwd", grid, g, t, d, v)
    return {"nsplit": nsplit, "tiles_per_split": tps,
            "ldw": _cdiv(v, 8) * 8 if bf16 else v,
            "dp": _dpad(d) if bf16 else d,
            "grids": {"fused_ce_fwd": grid}}


def _shapes(x, w, labels):
    if x.dim() != 3 or w.dim() != 3 or labels.dim() != 2:
        raise ValueError(f"need x [G,T,d], w [G,d,V], labels [G,T]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}")
    g, t, d = x.shape
    if w.shape[:2] != (g, d) or tuple(labels.shape) != (g, t):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, labels {tuple(labels.shape)}")
    if g == 0 or t == 0 or d == 0 or w.shape[2] == 0:
        raise ValueError("empty fused_ce operands")
    return g, t, d, w.shape[2]


def _group_stride(t: torch.Tensor, what: str) -> int:
    """Elements between groups: 0 (shared) or one whole group."""
    inner = t[0]
    if inner.is_contiguous():
        if t.shape[0] == 1 or t.stride(0) == inner.numel():
            return inner.numel()
        if t.stride(0) == 0:
            return 0
    raise ValueError(f"{what}: each group must be contiguous and groups "
                     f"dense or shared, got strides {t.stride()}")


def _check_cuda(x, w, labels, extra=()):
    dev = x.device
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x and w must share a dtype in float32/bfloat16, "
                         f"got {x.dtype} and {w.dtype}")
    if labels.dtype != torch.int32 or not labels.is_contiguous():
        raise ValueError("labels must be a contiguous int32 tensor")
    for t in (w, labels) + tuple(extra):
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
    for t in extra:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("lse and g must be contiguous float32 tensors")


def fused_ce_fwd(x, w, labels):
    """Per-row ``(lse, picked)`` fp32 ``[G, T]`` of the logits ``x @ w``
    (K3)."""
    g, t, d, v = _shapes(x, w, labels)
    if x.device.type == "cpu":
        return ref.fused_ce_fwd(x, w, labels)
    if x.device.type == "meta":
        out = torch.empty((g, t), dtype=torch.float32, device="meta")
        return out, torch.empty_like(out)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ce_fwd runs on cpu or cuda, not {x.device}")
    from repro_torch.kernels._build import load
    _check_cuda(x, w, labels)
    xg, wg = _group_stride(x, "x"), _group_stride(w, "w")
    bf16 = x.dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = launch_plan(g, t, d, v, sms, bf16)
    nsplit, tps, ldw = plan["nsplit"], plan["tiles_per_split"], plan["ldw"]
    dp = plan["dp"]
    if bf16:
        _aligned(x, "x")
        _aligned(w, "w")
        x, xg = _pad_d(x, xg, 2, dp)
        w, wg = _pad_d(w, wg, 1, dp)
        w, wg = _pad_rows(w, wg, v, ldw)
    lse = torch.empty((g, t), dtype=torch.float32, device=x.device)
    picked = torch.empty_like(lse)
    part = torch.empty((3, g, nsplit, t), dtype=torch.float32,
                       device=x.device)
    err = load("fused_ce").fused_ce_fwd(
        x.data_ptr(), w.data_ptr(), labels.data_ptr(), part.data_ptr(),
        lse.data_ptr(), picked.data_ptr(), g, t, dp, v, ldw, xg, wg, nsplit,
        tps, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd launch failed: cudaError {err}")
    LAUNCHES["fused_ce_fwd"] += 1
    return lse, picked


def _aligned(t: torch.Tensor, what: str):
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: TMA needs a 16-byte aligned base")


def _pad_d(t: torch.Tensor, tg: int, axis: int, dp: int):
    """``(t, group stride)`` with the d axis of ``t`` (``axis`` 2 of x
    ``[G, T, d]``, 1 of w ``[G, d, V]``) zero-padded to ``dp``."""
    d = t.shape[axis]
    if d == dp:
        return t, tg
    pad = (0, dp - d) if axis == 2 else (0, 0, 0, dp - d)
    t = F.pad(t if tg else t[:1], pad)
    return t, t[0].numel() if tg else 0


def _pad_rows(w: torch.Tensor, wg: int, v: int, ldw: int):
    """``(w, group stride)`` with w's rows padded to ``ldw`` columns where
    ``ldw != v`` (16-byte rows for TMA)."""
    if ldw == v:
        return w, wg
    w = F.pad(w if wg else w[:1], (0, ldw - v))
    return w, w[0].numel() if wg else 0


def _bwd(x, w, labels, lse, g, want_dx: bool, want_dw: bool):
    """``(dx or None, dw or None)``: one P pass over every chunk, with the
    dx and / or dw products."""
    gn, t, d, v = _shapes(x, w, labels)
    if tuple(lse.shape) != (gn, t) or tuple(g.shape) != (gn,):
        raise ValueError(f"need lse [G,T] and g [G], got {tuple(lse.shape)} "
                         f"and {tuple(g.shape)}")
    if x.device.type == "cpu":
        return (ref.fused_ce_dx(x, w, labels, lse, g) if want_dx else None,
                ref.fused_ce_dw(x, w, labels, lse, g) if want_dw else None)
    if x.device.type not in ("meta", "cuda"):
        raise ValueError(f"fused_ce backward runs on cpu or cuda, not "
                         f"{x.device}")
    dx = torch.empty((gn, t, d), dtype=x.dtype, device=x.device) \
        if want_dx else None
    dw = torch.empty((gn, d, v), dtype=w.dtype, device=x.device) \
        if want_dw else None
    if x.device.type == "meta":
        return dx, dw
    from repro_torch.kernels._build import load
    _check_cuda(x, w, labels, (lse, g))
    xg, wg = _group_stride(x, "x"), _group_stride(w, "w")
    bf16 = x.dtype == torch.bfloat16
    ldw, vc, p, acc, dp = v, 0, None, None, d
    if bf16:
        plan = bwd_plan(gn, t, d, v)
        _aligned(x, "x")
        _aligned(w, "w")
        ldw, vc, dp = plan["ldw"], plan["vc"], plan["dp"]
        x, xg = _pad_d(x, xg, 2, dp)
        w, wg = _pad_d(w, wg, 1, dp)
        w, wg = _pad_rows(w, wg, v, ldw)
        p = torch.empty((gn, t, vc), dtype=x.dtype, device=x.device)
        if want_dx and plan["acc"]:
            acc = torch.empty((gn, t, dp), dtype=torch.float32,
                              device=x.device)
        if dp != d:             # the kernels write the padded widths
            dx = torch.empty((gn, t, dp), dtype=x.dtype, device=x.device) \
                if want_dx else None
            dw = torch.empty((gn, dp, v), dtype=w.dtype, device=x.device) \
                if want_dw else None
    def ptr(a):
        return None if a is None else a.data_ptr()

    err = load("fused_ce").fused_ce_bwd(
        x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
        g.data_ptr(), ptr(p), ptr(acc), ptr(dx), ptr(dw), gn, t, dp, v, ldw,
        xg, wg, vc, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ce backward launch failed: cudaError {err}")
    LAUNCHES["fused_ce_p"] += bf16
    LAUNCHES["fused_ce_dx"] += want_dx
    LAUNCHES["fused_ce_dw"] += want_dw
    if dp != d:
        dx = None if dx is None else dx[..., :d].contiguous()
        dw = None if dw is None else dw[:, :d].contiguous()
    return dx, dw


def fused_ce_dx(x, w, labels, lse, g):
    """``dx [G,T,d]`` in x's dtype of ``g[G] * mean_t CE`` from the saved
    ``lse`` (K4a: its own P pass, then the dx products)."""
    return _bwd(x, w, labels, lse, g, True, False)[0]


def fused_ce_dw(x, w, labels, lse, g):
    """``dw [G,d,V]`` in w's dtype (K4b: its own P pass, then the dw
    products)."""
    return _bwd(x, w, labels, lse, g, False, True)[1]


def fused_ce_bwd(x, w, labels, lse, g):
    """``(dx, dw)``: K4a and K4b on one shared P pass per chunk."""
    return _bwd(x, w, labels, lse, g, True, True)
