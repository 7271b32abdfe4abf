"""Causal sliding-window attention, forward and backward: wrappers of the
CUDA kernels in ``csrc/swa_attention.cu`` (port of the JAX package's Pallas
kernel ``repro.kernels.swa_attention``, K6, and of its gradient, which the
JAX package takes as ``jax.vjp`` of its reference).

q ``[B, S, H, hd]``, k/v ``[B, S, KH, hd]`` -> ``[B, S, H, hd]`` in q's
dtype; hd in {16, 32, 64, 112, 128}.  The forward also gives each row's
log-sum-exp ``lse [B, H, S]`` fp32 in base 2 of the scaled scores
(``log2 sum_k 2^(s_k log2(e) / sqrt(hd))``), the residual the backward
kernels recompute P from.  Two forward kernels, chosen up front from
dtype and hd (``kernel_for``): bf16 at hd 64, 112 (zamba2's heads) or 128
takes the tensor-core kernel (TMA + wgmma, P rounded to bf16 before
``P v``), fp32 and hd 16 or 32 the CUDA-core one (fp32 products and
sums).  The backward (``swa_attention_bwd``, routed by ``bwd_kernel_for``)
runs three kernels for bf16 at the tensor-core widths (delta, dK/dV, dQ)
and the plain backward for fp32 and hd 16 or 32, counted apart.  On a CPU
tensor the wrappers compute the plain versions in ``kernels/ref.py``; on a
``meta`` tensor they return empty outputs and count nothing; on a CUDA
tensor they launch the kernels or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

HEAD_DIMS = (16, 32, 64, 112, 128)  # the CUDA-core kernel's instances
TC_HEAD_DIMS = (64, 112, 128)       # the tensor-core kernels' (bf16)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BWD_KERNELS = ("swa_attention_bwd_delta", "swa_attention_bwd_dkdv",
               "swa_attention_bwd_dq")
BWD_PLAIN = "swa_attention_bwd_plain"

# Launches since the last reset_launches(), one per wrapper call that
# launched: ``swa_attention`` the CUDA-core forward, ``swa_attention_tc``
# the tensor-core one, the three ``BWD_KERNELS`` the backward's; and
# ``swa_attention_bwd_plain`` counts backward calls on the card that run
# the plain backward (fp32, hd 16 or 32).
LAUNCHES = {"swa_attention": 0, "swa_attention_tc": 0,
            **{k: 0 for k in BWD_KERNELS}, BWD_PLAIN: 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_for(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA forward call with q of ``dtype`` and head width
    ``hd`` launches (its ``LAUNCHES`` key)."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "swa_attention_tc"
    return "swa_attention"


def bwd_kernel_for(dtype: torch.dtype, hd: int) -> tuple:
    """The ``LAUNCHES`` keys a CUDA backward call counts: the three
    backward kernels where the forward takes the tensor-core kernel, the
    plain backward elsewhere."""
    if kernel_for(dtype, hd) == "swa_attention_tc":
        return BWD_KERNELS
    return (BWD_PLAIN,)


def _check(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"need q [B,S,H,hd], k/v [B,S,KH,hd] with KH | H; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _check_cuda(dev: torch.device, **ts):
    """``dev`` is a CUDA device and every tensor of ``ts`` contiguous on
    it."""
    if dev.type != "cuda":
        raise ValueError(f"swa_attention runs on cpu or cuda, not {dev}")
    for what, t in ts.items():
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{what} must be contiguous on {dev}")


def swa_attention_fwd(q, k, v, window: int):
    """Sliding-window causal attention over the trailing ``window``
    positions (``window <= 0``: full causal) -> ``(o, lse)``."""
    _check(q, k, v)
    b, s, h, hd = q.shape
    window = int(window) if window > 0 else s
    if q.device.type == "cpu":
        return ref.swa_attention_fwd(q, k, v, window)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty(
            (b, h, s), dtype=torch.float32, device=q.device)
    _check_cuda(q.device, q=q, k=k, v=v)
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"swa_attention takes hd in {HEAD_DIMS}, got {hd}")
    if h > 65535 or b > 65535:
        raise ValueError(f"B={b}, H={h} exceed the launch grid")
    from repro_torch.kernels._build import load
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    name = kernel_for(q.dtype, hd)
    lib = load("swa_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, h, k.shape[2], hd, window,
            1.0 / math.sqrt(hd))
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
    return o, lse


def _launch(name: str, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _bwd_delta(o, g):
    """delta ``[B, H, S]`` fp32 = rowsum(g o) (the first backward kernel)."""
    from repro_torch.kernels._build import load
    b, s, h, hd = o.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=o.device)
    _launch("swa_attention_bwd_delta", load("swa_attention").swa_bwd_delta,
            o.data_ptr(), g.data_ptr(), delta.data_ptr(), b, s, h, hd,
            torch.cuda.current_stream(o.device).cuda_stream)
    return delta


def _bwd_dkdv(q, k, v, g, lse, delta, window: int):
    """``(dk, dv)`` from the residuals (the second backward kernel)."""
    from repro_torch.kernels._build import load
    b, s, h, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("swa_attention_bwd_dkdv", load("swa_attention").swa_bwd_dkdv,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, k.shape[2], hd, window, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


def _bwd_dq(q, k, v, g, lse, delta, window: int):
    """``dq`` from the residuals (the third backward kernel)."""
    from repro_torch.kernels._build import load
    b, s, h, hd = q.shape
    dq = torch.empty_like(q)
    _launch("swa_attention_bwd_dq", load("swa_attention").swa_bwd_dq,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h,
            k.shape[2], hd, window, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def swa_attention_bwd(q, k, v, o, lse, g, window: int):
    """``(dq, dk, dv)`` of :func:`swa_attention_fwd` for the output
    cotangent ``g``, given its output ``o`` and ``lse``.  On the CPU (and
    on the card for fp32 or hd 16/32) the plain ``ref.swa_attention_bwd``,
    which recomputes from q, k, v; on the card in bf16 at hd 64/112/128 the
    delta, dK/dV and dQ kernels."""
    _check(q, k, v)
    b, s, h, hd = q.shape
    if o.shape != q.shape or g.shape != q.shape \
            or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"need o, g {tuple(q.shape)} and lse {(b, h, s)}; "
                         f"got {tuple(o.shape)}, {tuple(g.shape)}, "
                         f"{tuple(lse.shape)}")
    window = int(window) if window > 0 else s
    if q.device.type == "cpu":
        return ref.swa_attention_bwd(q, k, v, g, window)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _check_cuda(q.device)
    if bwd_kernel_for(q.dtype, hd) == (BWD_PLAIN,):
        out = ref.swa_attention_bwd(q, k, v, g, window)
        LAUNCHES[BWD_PLAIN] += 1
        return out
    q, k, v, o, g, lse = (t.contiguous() for t in (q, k, v, o, g, lse))
    _check_cuda(q.device, k=k, v=v, o=o, g=g, lse=lse)
    if any(t.dtype != torch.bfloat16 for t in (k, v, o, g)) \
            or lse.dtype != torch.float32:
        raise ValueError(f"need bf16 q, k, v, o, g and fp32 lse; got "
                         f"{[str(t.dtype) for t in (q, k, v, o, g, lse)]}")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, g)):
        raise ValueError("swa_attention_bwd: TMA needs 16-byte aligned q, "
                         "k, v, o and g")
    delta = _bwd_delta(o, g)
    dk, dv = _bwd_dkdv(q, k, v, g, lse, delta, window)
    return _bwd_dq(q, k, v, g, lse, delta, window), dk, dv
