"""Functional neural-net ops shared by the port's models
(``repro.models.layers``).

Pure functions over explicit parameter trees.  Every reduction that affects
numerics (softmax, norms) runs in fp32 whatever the activation dtype, with
the cast back where the reference casts: bf16 parity depends on it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [..., V], labels [...] int (int32 on the wire) -> mean CE (fp32)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


# ---------------------------------------------------------------------------
# Norms and activations
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it:
    ``logaddexp(x, 0)``, with no linear cutoff (``F.softplus`` returns x
    above x = 20; in the 2-round CSE-FSL test on reduced falcon-mamba that
    moves a trained weight past rtol 1e-4 of the reference's)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """Rotate q/k.  x: [B,S,H,hd]; pos: [B,S] integer positions."""
    hd = x.shape[-1]
    inv_freq = rope_inv_freq(hd, theta, x.device)            # [hd/2]
    ang = pos[..., None].float() * inv_freq                  # [B,S,hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd).reshape(
        b, s, kh * n_rep, hd)


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor):
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    e = torch.where(mask, e, 0.0)
    return e / (e.sum(-1, keepdim=True) + 1e-30)


def attention(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
              kv_len=None, chunk: int = 512):
    """Multi-head attention with GQA, causal and sliding-window masks.

    q: [B,Sq,H,hd]; k,v: [B,Skv,KH,hd].  ``q_offset`` is the absolute
    position of q[0].  ``kv_len`` (an int, a 0-d device tensor or None)
    masks out the cache slots at and past it (decode).  Long sequences run
    over q in chunks of ``chunk`` so the score matrix never materializes
    at [Sq, Skv]; a shorter last chunk takes the rows left (the reference
    asserts ``Sq % chunk == 0``: each row's arithmetic is the same).
    """
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kh).float()
    v = _repeat_kv(v, h // kh).float()
    scale = 1.0 / math.sqrt(hd)
    kv_pos = torch.arange(skv, device=q.device)

    def block(qc, off):
        cq = qc.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", qc.float(), k) * scale
        q_pos = off + torch.arange(cq, device=q.device)
        mask = torch.ones((cq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_len is not None:
            mask &= kv_pos[None, :] < kv_len
        w = _masked_softmax(scores, mask[None, None])
        return torch.einsum("bhqk,bkhd->bqhd", w, v).to(q.dtype)

    if sq <= chunk:
        return block(q, q_offset)
    return torch.cat([block(q[:, i:i + chunk], q_offset + i)
                      for i in range(0, sq, chunk)], dim=1)


# ---------------------------------------------------------------------------
# Causal depthwise conv (mamba)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x: [B,S,C]; w: [C,K]; depthwise causal conv + bias.  Cross-correlation
    as JAX's conv (no kernel flip), padded by K-1 on the left only."""
    s, k = x.shape[1], w.shape[-1]
    out = F.conv1d(x.transpose(1, 2), w[:, None, :], padding=k - 1,
                   groups=x.shape[-1])
    return out[..., :s].transpose(1, 2) + b


def conv1d_decode(x: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor):
    """One step of the depthwise conv.  x: [B,C]; state: [B,K-1,C], the
    last K-1 inputs, oldest first -> ``(out [B,C], state)``.  ``state`` is
    shifted in place (the oldest input out, x in) and returned."""
    full = torch.cat([state, x[:, None, :]], dim=1)            # [B,K,C]
    out = torch.einsum("bkc,ck->bc", full, w) + b
    state.copy_(full[:, 1:])
    return out, state


# ---------------------------------------------------------------------------
# Mamba-1 selective scan (the model's path without kernels; K5's backward)
# ---------------------------------------------------------------------------


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along dim 1 from
    ``h_{-1} = 0``: returns ``(prod_{s<=t} a_s, h_t)``.  The combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)`` applied in
    ceil(log2 L) doubling steps (Hillis-Steele), in plain tensor ops."""
    k, n = 1, a.shape[1]
    while k < n:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    return a, b


def selective_scan(u, dt, a, b_mat, c_mat, d_vec, *, chunk: int = 128,
                   h0=None, return_state: bool = False):
    """Mamba-1 scan.  u,dt: [B,S,D]; a: [D,N]; b_mat,c_mat: [B,S,N];
    d_vec: [D] -> y [B,S,D] in u's dtype (and, with ``return_state``, the
    fp32 state after the last step, [B,D,N]).  ``h0``: the state before
    the first step (default zeros).

    h_t = exp(dt_t a) h_{t-1} + dt_t b_t u_t;  y_t = c_t . h_t + d u_t.
    Chunked: a loop over chunks carries h, a doubling scan runs within a
    chunk, so the [B,chunk,D,N] tensors exist one chunk at a time.
    """
    bsz, s, dim = u.shape
    if s % chunk:
        chunk = s                   # small sequences: single chunk
    dtf, uf = dt.float(), u.float()
    bm, cm = b_mat.float(), c_mat.float()
    h = torch.zeros((bsz, dim, a.shape[-1]), dtype=torch.float32,
                    device=u.device) if h0 is None else h0
    ys = []
    for i in range(0, s, chunk):
        dt_c, u_c = dtf[:, i:i + chunk], uf[:, i:i + chunk]
        da = torch.exp(dt_c[..., None] * a)                  # [B,L,D,N]
        db = (dt_c * u_c)[..., None] * bm[:, i:i + chunk, None, :]
        acc_a, acc_b = linear_scan(da, db)
        h_t = acc_a * h[:, None] + acc_b
        ys.append(torch.einsum("bldn,bln->bld", h_t, cm[:, i:i + chunk]))
        h = h_t[:, -1]
    y = (torch.cat(ys, 1) + uf * d_vec).to(u.dtype)
    # h is a view of the last chunk's [B,L,D,N] states: keep only its row
    return (y, h.contiguous()) if return_state else y


def selective_scan_decode(u, dt, a, b_mat, c_mat, d_vec, h):
    """One step.  u,dt: [B,D]; b_mat,c_mat: [B,N]; h: [B,D,N] fp32 ->
    ``(y [B,D] in u's dtype, h)``, in the reference's fp32 order; ``h`` is
    updated in place and returned."""
    dtf, uf = dt.float(), u.float()
    da = torch.exp(dtf[..., None] * a)                          # [B,D,N]
    h.mul_(da).add_(dtf[..., None] * b_mat.float()[:, None, :]
                    * uf[..., None])
    y = torch.einsum("bdn,bn->bd", h, c_mat.float()) + uf * d_vec
    return y.to(u.dtype), h
