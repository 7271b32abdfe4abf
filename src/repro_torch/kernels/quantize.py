"""Per-tile quantization for the wire codecs: wrappers of the CUDA kernels
in ``csrc/quantize.cu`` (port of the JAX package's Pallas kernel
``repro.kernels.quantize``).

``quantize_2d`` takes a client-stacked payload ``x [n, R, C]`` (or one
``[R, C]``) and codes all clients in one launch.  Randomness, when
``stochastic``: EITHER ``bits`` — caller uint32 bits shaped like ``x``
(kernel ``quantize_bits``) — OR ``seeds`` — one 64-bit seed per client
driving the in-kernel Philox stream (kernel ``quantize_philox``), which
never builds a bits tensor.  Deterministic rounding goes through
``quantize_bits`` with no bits.

On a CPU tensor the wrapper computes the plain version in
``kernels/ref.py`` (with ``ref.philox_bits`` for ``seeds``, the same bits
the card draws).  On a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import BC, BT

FMTS = {"int8": 0, "fp8": 1}
_OUT_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

# Kernel launches since the last reset_launches(): one per launch, counted
# nowhere else, so a run can show which kernels its main path went through.
LAUNCHES = {"quantize_bits": 0, "quantize_philox": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t: torch.Tensor, what: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{what}: need a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _launch(x, bits, seeds, fmt: str, stochastic: bool):
    """One launch over x [n, R, C] on x's device and current stream."""
    from repro_torch.kernels._build import load
    n, r, c = x.shape
    nr, nc = -(-r // BT), -(-c // BC)
    if nr > 65535 or n > 65535:
        raise ValueError(f"payload [{n}, {r}, {c}] exceeds the launch grid "
                         "(at most 65535 clients and 65535 tile rows)")
    _check(x, "x", torch.float32, x.shape, x.device)
    q = torch.empty((n, r, c), dtype=torch.uint8, device=x.device)
    scales = torch.empty((n, nr, nc), dtype=torch.float32, device=x.device)
    lib = load("quantize")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if seeds is not None:
        _check(seeds, "seeds", torch.int64, (n,), x.device)
        err = lib.quantize_philox(x.data_ptr(), seeds.data_ptr(),
                                  q.data_ptr(), scales.data_ptr(), n, r, c,
                                  FMTS[fmt], stream)
        name = "quantize_philox"
    else:
        if bits is not None:
            _check(bits, "bits", torch.int32, x.shape, x.device)
        err = lib.quantize_bits(x.data_ptr(),
                                bits.data_ptr() if bits is not None else None,
                                q.data_ptr(), scales.data_ptr(), n, r, c,
                                FMTS[fmt], int(stochastic), stream)
        name = "quantize_bits"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return q.view(_OUT_DTYPE[fmt]), scales


def quantize_2d(x: torch.Tensor, bits=None, *, seeds=None,
                fmt: str = "int8", stochastic: bool = True):
    """Per-(8x128)-tile absmax quantization of ``x [n, R, C]`` or ``[R, C]``
    fp32.  Returns ``(q, scales)``: ``q`` like ``x`` in int8 or
    float8_e4m3fn, ``scales [n, ceil(R/8), ceil(C/128)]`` fp32 (no ``n``
    for a 2D ``x``).  ``bits`` are uint32 patterns in an int32 tensor shaped
    like ``x``; ``seeds`` an int64 ``[n]`` tensor (``[1]`` for a 2D ``x``).
    """
    if fmt not in FMTS:
        raise ValueError(f"unknown quantize format {fmt!r}")
    if not stochastic:
        bits = seeds = None
    elif (bits is None) == (seeds is None):
        raise ValueError("stochastic quantize_2d needs exactly one of "
                         "bits=<uint32 bits like x> or seeds=<int64 [n]>")
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
        bits = bits[None] if bits is not None else None
    if x.dim() != 3:
        raise ValueError(f"x must be [n, R, C] or [R, C], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        if seeds is not None:
            bits = ref.philox_bits(seeds, *x.shape[1:])
        q, scales = ref.quantize_2d(x, bits, fmt=fmt, stochastic=stochastic)
    elif x.device.type == "cuda":
        q, scales = _launch(x, bits, seeds, fmt, stochastic)
    else:
        raise ValueError(f"quantize_2d runs on cpu or cuda, not {x.device}")
    return (q[0], scales[0]) if squeeze else (q, scales)


def dequantize_2d(q: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Exact inverse map of ``quantize_2d``'s scaling (a plain elementwise
    multiply on every device, as in the JAX package)."""
    return ref.dequantize_2d(q, scales, dtype=dtype)
