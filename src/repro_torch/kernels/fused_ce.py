"""Fused linear + cross-entropy: wrappers of the CUDA kernels in
``csrc/fused_ce.cu`` (port of the JAX package's Pallas kernels
``repro.kernels.fused_ce``: K3 forward, K4a dx, K4b dw).

All three are grouped: ``x [G, T, d]``, ``w [G, d, V]`` (a group stride of
0 shares one ``w`` or ``x`` across groups), ``labels [G, T]`` int32; the
client ``vmap`` folds its clients into ``G`` so one launch serves them all.
Any d runs: the kernels stream x and w through shared memory in chunks of
d, and K4a/K4b blocks each own a slice of at most ``D_SLICE`` columns of
d (``launch_plan``).

On a CPU tensor a wrapper computes the plain version in ``kernels/ref.py``;
on a ``meta`` tensor it returns empty outputs of the right shapes and
counts nothing; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

# Tiles compiled into csrc/fused_ce.cu (the grids are computed here).
FWD_ROWS, VOCAB_TILE = 64, 64       # K3: token rows per block, vocab tile
DX_ROWS, DW_COLS = 16, 16           # K4a dx rows, K4b dw columns per block
D_SLICE = 1024                      # K4a/K4b: d columns per block (DSW)
GRID_YZ = 65535                     # CUDA's limit on gridDim.y and .z

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset_launches(): one per wrapper call of
# each kernel (K3's combine pass counts within fused_ce_fwd), counted
# nowhere else.
LAUNCHES = {"fused_ce_fwd": 0, "fused_ce_dx": 0, "fused_ce_dw": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vocab_splits(g: int, t: int, v: int, sms: int = 132):
    """``(nsplit, tiles_per_split)`` of K3's vocabulary: enough blocks for
    about four per SM, every split non-empty."""
    blocks = g * _cdiv(t, FWD_ROWS)
    nv = _cdiv(v, VOCAB_TILE)
    want = min(nv, max(1, _cdiv(4 * sms, blocks)))
    tps = _cdiv(nv, want)
    return _cdiv(nv, tps), tps


def launch_plan(g: int, t: int, d: int, v: int, sms: int = 132) -> dict:
    """The three kernels' grids for ``x [g, t, d]``, ``w [g, d, v]``: K3's
    ``(row blocks, vocab splits, g)``, K4a's ``(row blocks, g, d slices)``,
    K4b's ``(vocab blocks, g, d slices)``.  Raises ``ValueError`` where a
    grid exceeds CUDA's limits."""
    nsplit, tps = vocab_splits(g, t, v, sms)
    nds = _cdiv(d, D_SLICE)
    grids = {"fused_ce_fwd": (_cdiv(t, FWD_ROWS), nsplit, g),
             "fused_ce_dx": (_cdiv(t, DX_ROWS), g, nds),
             "fused_ce_dw": (_cdiv(v, DW_COLS), g, nds)}
    for name, (gx, gy, gz) in grids.items():
        if gx > 2**31 - 1 or gy > GRID_YZ or gz > GRID_YZ:
            raise ValueError(f"{name}: grid {(gx, gy, gz)} exceeds CUDA's "
                             f"limits at G={g}, T={t}, d={d}, V={v}")
    return {"nsplit": nsplit, "tiles_per_split": tps, "d_slices": nds,
            "grids": grids}


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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = launch_plan(g, t, d, v, sms)
    nsplit, tps = plan["nsplit"], plan["tiles_per_split"]
    lse = torch.empty((g, t), dtype=torch.float32, device=x.device)
    picked = torch.empty_like(lse)
    part = torch.empty((3, g, nsplit, t), dtype=torch.float32,
                       device=x.device)
    err = load("fused_ce").fused_ce_fwd(
        x.data_ptr(), w.data_ptr(), labels.data_ptr(), part.data_ptr(),
        lse.data_ptr(), picked.data_ptr(), g, t, d, v, xg, wg, nsplit, tps,
        DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd launch failed: cudaError {err}")
    LAUNCHES["fused_ce_fwd"] += 1
    return lse, picked


def _bwd(name, x, w, labels, lse, g):
    """One backward kernel (``fused_ce_dx`` or ``fused_ce_dw``)."""
    gn, t, d, v = _shapes(x, w, labels)
    if tuple(lse.shape) != (gn, t) or tuple(g.shape) != (gn,):
        raise ValueError(f"need lse [G,T] and g [G], got {tuple(lse.shape)} "
                         f"and {tuple(g.shape)}")
    shape, dtype = ((gn, t, d), x.dtype) if name == "fused_ce_dx" \
        else ((gn, d, v), w.dtype)
    if x.device.type == "cpu":
        return getattr(ref, name)(x, w, labels, lse, g)
    if x.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    from repro_torch.kernels._build import load
    _check_cuda(x, w, labels, (lse, g))
    xg, wg = _group_stride(x, "x"), _group_stride(w, "w")
    nds = launch_plan(gn, t, d, v)["d_slices"]
    out = torch.empty(shape, dtype=dtype, device=x.device)
    err = getattr(load("fused_ce"), name)(
        x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
        g.data_ptr(), out.data_ptr(), gn, t, d, v, xg, wg, nds,
        DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def fused_ce_dx(x, w, labels, lse, g):
    """``dx [G,T,d]`` in x's dtype of ``g[G] * mean_t CE`` from the saved
    ``lse`` (K4a)."""
    return _bwd("fused_ce_dx", x, w, labels, lse, g)


def fused_ce_dw(x, w, labels, lse, g):
    """``dw [G,d,V]`` in w's dtype (K4b)."""
    return _bwd("fused_ce_dw", x, w, labels, lse, g)


def fused_ce_bwd(x, w, labels, lse, g):
    """``(dx, dw)``: K4a, then K4b."""
    return (fused_ce_dx(x, w, labels, lse, g),
            fused_ce_dw(x, w, labels, lse, g))
