"""Causal sliding-window attention, forward: wrappers of the CUDA kernels
in ``csrc/swa_attention.cu`` (port of the JAX package's Pallas kernel
``repro.kernels.swa_attention``, K6).

q ``[B, S, H, hd]``, k/v ``[B, S, KH, hd]`` -> ``[B, S, H, hd]`` in q's
dtype; hd in {16, 32, 64, 112, 128}.  Two hand-written kernels, chosen up
front from dtype and hd (``kernel_for``): bf16 at hd 64 or 128 (the dense
models' main paths) takes the tensor-core kernel (TMA + wgmma, P rounded
to bf16 before ``P v``), fp32 and hd 16, 32 or 112 (zamba2's heads) the
CUDA-core one (fp32 products and sums).  On a CPU tensor the wrapper
computes the plain version in ``kernels/ref.py``; on a ``meta`` tensor it
returns an empty output and counts nothing; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

HEAD_DIMS = (16, 32, 64, 112, 128)  # the CUDA-core kernel's instances
TC_HEAD_DIMS = (64, 128)            # the tensor-core kernel's (bf16)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset_launches(), one per wrapper call
# that launched: ``swa_attention`` the CUDA-core kernel,
# ``swa_attention_tc`` the tensor-core one.
LAUNCHES = {"swa_attention": 0, "swa_attention_tc": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_for(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA call with q of ``dtype`` and head width ``hd``
    launches (its ``LAUNCHES`` key)."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "swa_attention_tc"
    return "swa_attention"


def swa_attention_fwd(q, k, v, window: int):
    """Sliding-window causal attention over the trailing ``window``
    positions (``window <= 0``: full causal)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"need q [B,S,H,hd], k/v [B,S,KH,hd] with KH | H; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    window = int(window) if window > 0 else s
    if q.device.type == "cpu":
        return ref.swa_attention(q, k, v, window)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention runs on cpu or cuda, not {q.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"swa_attention takes hd in {HEAD_DIMS}, got {hd}")
    if h > 65535 or b > 65535:
        raise ValueError(f"B={b}, H={h} exceed the launch grid")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{what} must be contiguous on {q.device}")
    from repro_torch.kernels._build import load
    o = torch.empty_like(q)
    name = kernel_for(q.dtype, hd)
    lib = load("swa_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            k.shape[2], hd, window, 1.0 / math.sqrt(hd))
    if name == "swa_attention_tc":
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("swa_attention bf16: TMA needs 16-byte aligned "
                             "q, k and v")
        err = lib.swa_attention_tc(*args, stream)
    else:
        err = lib.swa_attention_fwd(*args, DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return o
