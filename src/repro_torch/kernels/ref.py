"""Plain PyTorch versions of the port's kernels.

``quantize_2d`` repeats the per-tile quantizer's arithmetic step for step
(``repro.kernels.ref.quantize_2d``): given the same uint32 random bits it
gives the same bytes as the JAX package's kernel and as the CUDA kernels in
``csrc/quantize.cu``.  ``philox_bits`` is the Philox4x32-10 stream the CUDA
kernel draws inside itself, so the CPU path and the card draw the same bits.
These run on the CPU path and in the tests; on a card the wrappers in
``kernels/quantize.py`` launch the kernels instead.

Random bits are carried as uint32 bit patterns in ``torch.int32`` tensors
(the dtype every backend supports); arithmetic on them widens to int64.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BT, BC = 8, 128                  # wire tile; one fp32 scale per tile
INT8_MAX = 127.0
FP8_MAX = 448.0                  # float8_e4m3fn largest finite value
_MANTISSA_DROP = 20              # fp32 (23) -> e4m3 (3) mantissa bits
_SCALE_FLOOR = 1e-12             # all-zero tiles: keep scale finite
_M32 = 0xFFFFFFFF


def _f32(v: float, device) -> torch.Tensor:
    """``v`` rounded to fp32, as the reference's weakly typed Python
    constants are (1/127 -> 0x3c010204, 1/448 -> 0x3b124925)."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def _u32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int64) & _M32


def _tile_view(x: torch.Tensor, bt: int = BT, bc: int = BC):
    """Pad [..., R, C] with zeros to tile multiples -> [..., nR, bt, nC, bc]."""
    r, c = x.shape[-2:]
    rp, cp = -(-r // bt) * bt, -(-c // bc) * bc
    x = F.pad(x, (0, cp - c, 0, rp - r))
    return x.reshape(x.shape[:-2] + (rp // bt, bt, cp // bc, bc))


def _untile(t: torch.Tensor, r: int, c: int) -> torch.Tensor:
    nr, bt, nc, bc = t.shape[-4:]
    return t.reshape(t.shape[:-4] + (nr * bt, nc * bc))[..., :r, :c]


def quantize_2d(x: torch.Tensor, bits=None, *, fmt: str = "int8",
                stochastic: bool = True):
    """Per-(8x128)-tile absmax quantization of ``x [..., R, C]``.

    Returns ``(q, scales)``: ``q [..., R, C]`` int8 or float8_e4m3fn and
    ``scales [..., ceil(R/8), ceil(C/128)]`` fp32.  ``bits`` (uint32
    patterns in int32, shaped like ``x``) drive stochastic rounding and are
    ignored when not ``stochastic``.
    """
    if stochastic and bits is None:
        raise ValueError("stochastic quantize_2d needs bits")
    r, c = x.shape[-2:]
    tiles = _tile_view(x.float())
    qmax = INT8_MAX if fmt == "int8" else FP8_MAX
    absmax = tiles.abs().amax(dim=(-3, -1))
    scales = torch.maximum(absmax, _f32(_SCALE_FLOOR, x.device)) \
        * _f32(1.0 / qmax, x.device)
    y = tiles / scales[..., :, None, :, None]
    if stochastic:
        b = _u32(_tile_view(bits))
    if fmt == "int8":
        if stochastic:
            u = (b >> 8).float() * _f32(1.0 / (1 << 24), x.device)
            q = torch.floor(y + u)
        else:
            q = torch.round(y)                   # half to even, like jnp
        q = q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        if stochastic:
            yb = y.view(torch.int32).to(torch.int64) & _M32
            keep = (_M32 << _MANTISSA_DROP) & _M32
            yb = (yb + (b & ((1 << _MANTISSA_DROP) - 1))) & keep
            yb = torch.where(yb >= 1 << 31, yb - (1 << 32), yb)
            y = yb.to(torch.int32).view(torch.float32)
        q = y.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return _untile(q, r, c), scales


def dequantize_2d(q: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_2d``'s scaling: q * scale of its tile."""
    r, c = q.shape[-2:]
    y = _tile_view(q.float()) * scales[..., :, None, :, None]
    return _untile(y, r, c).to(dtype)


# ---------------------------------------------------------------------------
# Philox4x32-10 (Salmon et al., SC'11), the stream of the quantize_philox
# CUDA kernel.  Layout, per tile (i, j) of the [R, C] payload and element
# (r, c) of the 8x128 tile, with p = r * 128 + c:
#   key     = the 64-bit seed (low word, high word)
#   counter = (j, i, p // 4, 0)
#   bits    = word p % 4 of the output
# ---------------------------------------------------------------------------

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the uint32 values ``b``, in int64 without overflow: b is split into 16-bit
    halves so every partial product stays below 2^49."""
    bl, bh = b & 0xFFFF, b >> 16
    t = a * bl                       # < 2^48
    u = a * bh + (t >> 16)           # < 2^49; product = u * 2^16 + t_lo
    lo = ((u & 0xFFFF) << 16) | (t & 0xFFFF)
    return u >> 16, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 words.  ``ctr`` is four
    broadcastable counter words, ``key`` two key words; returns four words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + PHILOX_W0) & _M32
            k1 = (k1 + PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seeds, r: int, c: int) -> torch.Tensor:
    """Random bits ``[*seeds.shape, r, c]`` (uint32 patterns in int32) of
    the per-tile Philox layout above; ``seeds`` is an int or an int64 tensor
    of 64-bit seeds.  Computed on the CPU."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64).cpu()
    nr, nc = -(-r // BT), -(-c // BC)
    lead = seeds.shape
    s = seeds.reshape(-1, 1, 1, 1)
    k0, k1 = s & _M32, (s >> 32) & _M32
    ti = torch.arange(nr, dtype=torch.int64).reshape(1, nr, 1, 1)
    tj = torch.arange(nc, dtype=torch.int64).reshape(1, 1, nc, 1)
    call = torch.arange(BT * BC // 4, dtype=torch.int64).reshape(1, 1, 1, -1)
    zero = torch.zeros((), dtype=torch.int64)
    words = philox4x32_10((tj, ti, call, zero), (k0, k1))
    # [S, nR, nC, calls, 4] -> element p = 4 * call + word of each tile
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    w = w.reshape(-1, nr, nc, BT, BC).permute(0, 1, 3, 2, 4)
    w = w.reshape(-1, nr * BT, nc * BC)[:, :r, :c]
    w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    return w.reshape(tuple(lead) + (r, c))
