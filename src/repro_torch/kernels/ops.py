"""Differentiable ops over the port's kernels (``repro.kernels.ops``).

  - ``fused_ce(x [T,d], w [d,V], labels [T])``: mean cross-entropy of
    ``x @ w``; kernels forward (K3) AND backward (K4a dx, K4b dw).
  - ``swa_attention(q, k, v, window)``: sliding-window causal attention;
    kernel forward (K6); the backward recomputes in plain tensor ops from
    q, k, v (``ref.swa_attention_bwd``), as the JAX package's backward
    recomputes through its reference.
  - ``ssm_scan(u, dt, a, b, c, d, chunk)``: the Mamba-1 selective scan;
    kernels forward (K5, which also saves the state every
    ``ssm_scan.CHUNK`` steps) and backward (``ssm_scan.ssm_scan_bwd``,
    which restarts each tile from those states), where the JAX package's
    backward recomputes through ``selective_scan``.  On the CPU the
    backward is the plain ``ref.ssm_scan_bwd``, in blocks of ``chunk``.

All three are ``torch.autograd.Function``s built for ``torch.func``:
``forward`` takes no ``ctx`` (``setup_context`` saves the residuals) and a
``vmap`` staticmethod folds the vmapped dim into the kernels' group /
batch dim, so the client phase's ``vmap(grad_and_value(...))`` makes one
kernel call for all clients.  Each backward is itself such a Function, so
the vmapped backward folds the same way, and ``torch.func.grad``'s
``create_graph=True`` records none of the backward's temporaries.  On CPU
tensors the same Functions run with the plain versions inside; on
``meta`` tensors they produce shapes.

Tile sizes are compiled into the CUDA sources, derived for Hopper's shared
memory and registers (each source's note says how); the sizes chosen per
call are K3's vocabulary split (``fused_ce.launch_plan``) and the bf16
K4a/K4b's vocabulary chunks (``fused_ce.bwd_plan``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_ce as _ce
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import swa_attention as _swa


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` with contiguous groups, either dense or shared (stride 0)."""
    if t[0].is_contiguous() and (t.shape[0] == 1 or t.stride(0) == 0):
        return t
    return t.contiguous()


def _fold(t: torch.Tensor, bdim, n: int) -> torch.Tensor:
    """Move the vmapped dim (or broadcast an unbatched operand) to the
    front and fold it into the leading group dim."""
    t = t.expand((n,) + tuple(t.shape)) if bdim is None else t.movedim(bdim, 0)
    return t.reshape((n * t.shape[1],) + tuple(t.shape[2:]))


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape((n, t.shape[0] // n) + tuple(t.shape[1:]))


# ---------------------------------------------------------------------------
# fused_ce
# ---------------------------------------------------------------------------


class FusedCEBwd(torch.autograd.Function):
    """``(dx, dw)`` of the grouped fused CE (K4a, K4b)."""

    @staticmethod
    def forward(x, w, labels, lse, g):
        return _ce.fused_ce_bwd(_dense(x), _dense(w), labels.contiguous(),
                                lse.contiguous(), g.float().contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, gdx, gdw):
        raise RuntimeError("fused_ce has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, w, labels, lse, g):
        n = info.batch_size
        dx, dw = FusedCEBwd.apply(*(_fold(t, d, n) for t, d in
                                    zip((x, w, labels, lse, g), in_dims)))
        return (_unfold(dx, n), _unfold(dw, n)), (0, 0)


class FusedCE(torch.autograd.Function):
    """Grouped mean CE: x [G,T,d], w [G,d,V], labels [G,T] int32 ->
    ``(loss [G], lse [G,T])``; ``lse`` is the saved residual."""

    @staticmethod
    def forward(x, w, labels):
        lse, picked = _ce.fused_ce_fwd(_dense(x), _dense(w),
                                       labels.contiguous())
        return (lse - picked).mean(-1), lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, labels = inputs
        ctx.save_for_backward(x, w, labels, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, gloss, glse):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = FusedCEBwd.apply(x, w, labels, lse, gloss)
        return dx, dw, None

    @staticmethod
    def vmap(info, in_dims, x, w, labels):
        n = info.batch_size
        loss, lse = FusedCE.apply(*(_fold(t, d, n) for t, d in
                                    zip((x, w, labels), in_dims)))
        return (_unfold(loss, n), _unfold(lse, n)), (0, 0)


def fused_ce(x, w, labels):
    """Mean cross-entropy of ``x @ w`` vs labels.  x: [T,d]; w: [d,V];
    labels: [T] -> fp32 scalar."""
    loss, _ = FusedCE.apply(x[None], w[None], labels.to(torch.int32)[None])
    return loss[0]


# ---------------------------------------------------------------------------
# swa_attention
# ---------------------------------------------------------------------------


class SWAttentionBwd(torch.autograd.Function):
    """``(dq, dk, dv)`` of the sliding-window attention, recomputed in
    plain tensor ops.  A Function of its own so that ``torch.func.grad``
    (which differentiates with ``create_graph=True``) records none of its
    ``[B,H,S,S]`` temporaries."""

    @staticmethod
    def forward(q, k, v, g, window):
        return ref.swa_attention_bwd(q, k, v, g, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, gdq, gdk, gdv):
        raise RuntimeError("swa_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, g, window):
        n = info.batch_size
        out = SWAttentionBwd.apply(*(_fold(t, d, n) for t, d in
                                     zip((q, k, v, g), in_dims[:4])), window)
        return tuple(_unfold(t, n) for t in out), (0, 0, 0)


class SWAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, window):
        return _swa.swa_attention_fwd(q.contiguous(), k.contiguous(),
                                      v.contiguous(), window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window = inputs
        ctx.save_for_backward(q, k, v)
        ctx.window = window

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*SWAttentionBwd.apply(q, k, v, g, ctx.window), None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, window):
        n = info.batch_size
        out = SWAttention.apply(*(_fold(t, d, n) for t, d in
                                  zip((q, k, v), in_dims[:3])), window)
        return _unfold(out, n), 0


def swa_attention(q, k, v, window: int):
    """Sliding-window causal attention.  q: [B,S,H,hd]; k,v: [B,S,KH,hd]."""
    return SWAttention.apply(q, k, v, window)


# ---------------------------------------------------------------------------
# ssm_scan
# ---------------------------------------------------------------------------


class SSMScanBwd(torch.autograd.Function):
    """``(du, ddt, da, db, dc, dd)`` of the grouped scan from the
    forward's boundary states.  A Function of its own so that
    ``torch.func.grad`` (``create_graph=True``) records none of it."""

    @staticmethod
    def forward(u, dt, a, b, c, d, gy, states, chunk):
        return _ssm.ssm_scan_bwd(u, dt, a, b, c, d, gy, states, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("ssm_scan has no second derivative")

    @staticmethod
    def vmap(info, in_dims, u, dt, a, b, c, d, gy, states, chunk):
        n = info.batch_size
        out = SSMScanBwd.apply(*(_fold(t, i, n) for t, i in
                                 zip((u, dt, a, b, c, d, gy, states),
                                     in_dims[:8])), chunk)
        return tuple(_unfold(t, n) for t in out), (0,) * 6


class SSMScan(torch.autograd.Function):
    """Grouped scan: u, dt [B,S,D], a [G,D,N], b, c [B,S,N], d [G,D] ->
    ``(y [B,S,D], states [B, ceil(S/CHUNK), D, N])``; batch row i uses
    group ``i // (B // G)``, so the vmapped clients, each with its own
    ``a``/``d``, fold into one launch.  ``states`` is the saved residual."""

    @staticmethod
    def forward(u, dt, a, b, c, d, chunk):
        return _ssm.ssm_scan_fwd(*(t.contiguous() for t in (u, dt, a, b, c,
                                                            d)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:6], output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.chunk = inputs[6]

    @staticmethod
    def backward(ctx, gy, gstates):
        return (*SSMScanBwd.apply(*ctx.saved_tensors[:6], gy,
                                  ctx.saved_tensors[6], ctx.chunk), None)

    @staticmethod
    def vmap(info, in_dims, u, dt, a, b, c, d, chunk):
        n = info.batch_size
        y, states = SSMScan.apply(*(_fold(t, i, n) for t, i in
                                    zip((u, dt, a, b, c, d), in_dims[:6])),
                                  chunk)
        return (_unfold(y, n), _unfold(states, n)), (0, 0)


def ssm_scan(u, dt, a, b_mat, c_mat, d_vec, chunk: int = 128):
    """Mamba-1 selective scan.  u, dt: [B,S,D]; a: [D,N]; b_mat, c_mat:
    [B,S,N]; d_vec: [D] -> [B,S,D] in u's dtype."""
    cs = chunk if u.shape[1] % chunk == 0 else u.shape[1]
    return SSMScan.apply(u, dt, a[None], b_mat, c_mat, d_vec[None], cs)[0]
