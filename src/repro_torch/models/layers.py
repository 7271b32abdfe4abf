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
# RoPE (M-RoPE for qwen2-vl)
# ---------------------------------------------------------------------------


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               mrope_sections=None):
    """Rotate q/k.  x: [B,S,H,hd]; pos: [B,S] integer positions, or
    ``[3,B,S]`` with ``mrope_sections`` (M-RoPE): the hd/2 frequency slots
    split into (t, h, w) sections, section i's angles in fp32 from its own
    stream ``pos[i]``, then concatenated."""
    hd = x.shape[-1]
    inv_freq = rope_inv_freq(hd, theta, x.device)            # [hd/2]
    if mrope_sections is None:
        ang = pos[..., None].float() * inv_freq              # [B,S,hd/2]
    else:
        if sum(mrope_sections) != hd // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not "
                             f"cover head_dim / 2 = {hd // 2}")
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(pos[i][..., None].float()
                         * inv_freq[start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)                       # [B,S,hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_pos_ids(num_image_tokens: int, b: int, s: int, offset,
                  device=None):
    """The M-RoPE position streams (t, h, w) ``[3, B, S]`` of the VLM stub,
    the reference's exactly: the first ``num_image_tokens`` positions are
    a square patch grid of side ``isqrt(p)`` (t = 0, h = pos // side, w =
    pos % side); text positions restart at ``pos - p`` on all three
    streams.  Every stage rebuilds them from the shape and ``offset`` (an
    int or a 0-d device tensor: tensor ops only, no host value, as a
    captured decode step needs) on ``device``; no position travels with
    the smashed data."""
    p = num_image_tokens
    pos = torch.arange(s, device=device) + offset
    side = max(1, math.isqrt(max(p, 1)))
    is_img = pos < p
    text = pos - p
    ids = torch.stack([torch.where(is_img, 0, text),
                       torch.where(is_img, pos // side, text),
                       torch.where(is_img, pos % side, text)])   # [3,S]
    return ids[:, None, :].expand(3, b, s)


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
    With no mask at all (the encoder-only attention: not causal, no window,
    no ``kv_len``) the softmax is ``torch.softmax``, one pass over the
    scores where the masked form takes seven: the same function (the
    masked form's ``+ 1e-30`` is below an fp32 ulp of a row sum >= 1), its
    exp and division rounded by another kernel.
    """
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kh).float()
    v = _repeat_kv(v, h // kh).float()
    scale = 1.0 / math.sqrt(hd)
    kv_pos = torch.arange(skv, device=q.device)
    unmasked = not causal and not window and kv_len is None

    def block(qc, off):
        cq = qc.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", qc.float(), k) * scale
        if unmasked:
            return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1),
                                v).to(q.dtype)
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
# MoE: top-k token-choice routing with capacity (mesh-TF style dispatch)
# ---------------------------------------------------------------------------


def moe_route(probs: torch.Tensor, k: int):
    """``lax.top_k(probs, k)``: the k largest router probabilities and their
    experts, the lower expert first among equal ones (a stable descending
    sort; ``torch.topk`` does not promise that order, and a token whose
    normed input is all zeros has E equal probabilities: experts 0..k-1)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_groups(t: int, group_size: int, num_experts: int, k: int,
               capacity_factor: float):
    """``(G, S, C)`` of ``t`` tokens: ``G = max(1, t // group_size)``
    groups of ``S = t // G`` tokens (a group is S tokens, not
    ``group_size``), and the capacity C of each expert in a group, in the
    reference's Python-float order."""
    g = max(1, t // group_size)
    s = t // g
    return g, s, max(4, int(s * k / num_experts * capacity_factor))


def moe_router_probs(xg: torch.Tensor, router_w: torch.Tensor):
    """Router probabilities ``[G,S,E]`` of grouped tokens ``xg`` [G,S,d]:
    fp32 logits from the widened input, then the softmax.  One flipped
    choice re-routes a token, so the product must stay fp32 (no TF32)."""
    if xg.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router needs fp32 logits: turn "
                           "torch.backends.cuda.matmul.allow_tf32 off")
    logits = torch.einsum("gsd,de->gse", xg.float(), router_w.float())
    return torch.softmax(logits, dim=-1)


def moe_slots(probs: torch.Tensor, k: int, cap: int):
    """The routing of router probabilities ``probs`` [G,S,E] at capacity
    ``cap`` -> ``(idx [G,S,K], gates [G,S,K], slot [G,S,E], keep
    [G,S,E])``: each token's top k experts (``moe_route``) and gates,
    normalised over all k choices before any drop; a choice of expert e
    takes e's next slot in priority order (token-major, then choice), and
    is kept while its slot is below ``cap``.  A token's k choices go to
    distinct experts, so its slot at e is the number of earlier tokens of
    its group that chose e (an exclusive integer cumsum over the group):
    the reference's cumsum over the flattened ``[G, S*K, E]`` one-hot."""
    gates, idx = moe_route(probs, k)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    chosen = (idx[..., None] == torch.arange(probs.shape[-1],
                                             device=probs.device)).any(2)
    slot = torch.cumsum(chosen.int(), dim=1) - 1
    return idx, gates, slot, chosen & (slot < cap)


def moe_tables(probs: torch.Tensor, k: int, cap: int,
               dtype=torch.float32):
    """Dispatch and combine ``[G,S,E,C]`` in ``dtype`` and the fp32
    load-balance aux loss of router probabilities ``probs`` [G,S,E] at
    capacity ``cap``.

    The reference builds a ``[G,S,K,E,C]`` fp32 one-hot of the slots and
    contracts K (335 MB a group at olmoe's E 64, C 160); here the masks
    come from :func:`moe_slots` directly, the same numbers: a dispatch
    cell is 1 where a kept choice of the token holds that slot, a combine
    cell that choice's gate.  In another ``dtype`` they are the fp32
    tables cast (a combine cell is 1 times a gate: the cast gate)."""
    e = probs.shape[-1]
    idx, gates, slot, keep = moe_slots(probs, k, cap)
    disp = (keep[..., None] & (slot[..., None] == torch.arange(
        cap, device=probs.device))).to(dtype)
    onehot = (idx[..., None] == torch.arange(e, device=probs.device)).float()
    gate_e = (onehot * gates[..., None]).sum(2)        # one term an expert
    comb = disp * gate_e.to(dtype)[..., None]
    # load-balance auxiliary loss (Switch/OLMoE style): top-1 fractions
    frac_tokens = onehot[:, :, 0, :].mean(1)
    frac_probs = probs.mean(1)
    aux = e * (frac_tokens * frac_probs).sum(-1).mean()
    return disp, comb, aux


def moe_dispatch(x, router_w, *, num_experts: int, k: int,
                 capacity_factor: float, group_size: int):
    """Capacity-limited dispatch and combine tensors.

    x: [T,d] flat tokens -> ``(dispatch [G,S,E,C], combine [G,S,E,C]
    fp32, aux_loss fp32 scalar, (G, S, C))`` (:func:`moe_groups`,
    :func:`moe_router_probs`, :func:`moe_tables`); the ragged tail ``T -
    G S`` is not routed.  Static shapes, no host value: it runs under
    ``vmap``, in a CUDA-graph capture and under deterministic
    algorithms."""
    t, d = x.shape
    g, s, cap = moe_groups(t, group_size, num_experts, k, capacity_factor)
    probs = moe_router_probs(x[: g * s].reshape(g, s, d), router_w)
    disp, comb, aux = moe_tables(probs, k, cap)
    return disp, comb, aux, (g, s, cap)


def moe_experts(x, disp, comb, params, g: int, s: int):
    """The experts' SwiGLU on the dispatched tokens and the combine: x
    [T,d] with its tables ``disp``/``comb`` [G,S,E,C] -> [T,d].  The
    combine weights are cast to the activations' dtype before the combine
    product, as the reference casts them; the ragged tail ``T - G S``
    passes through as zeros."""
    t, d = x.shape
    xg = x[: g * s].reshape(g, s, d)
    ein = torch.einsum("gsec,gsd->egcd", disp.to(x.dtype), xg)
    h = torch.einsum("egcd,edf->egcf", ein, params["w1"])
    hg = torch.einsum("egcd,edf->egcf", ein, params["w3"])
    out = torch.einsum("egcf,efd->egcd", silu(h) * hg, params["w2"])
    y = torch.einsum("gsec,egcd->gsd", comb.to(x.dtype), out)
    y = y.reshape(g * s, d)
    if g * s < t:   # the ragged tail bypasses the MoE (residual passthrough)
        y = torch.cat([y, y.new_zeros((t - g * s, d))], dim=0)
    return y


def moe_ffn(x, params, *, num_experts: int, k: int, capacity_factor: float,
            group_size: int):
    """Top-k MoE SwiGLU ffn.  x: [T,d] -> ``([T,d], aux load-balance
    loss)``; ``params``: ``router`` [d,E] fp32, ``w1``/``w3`` [E,d,f],
    ``w2`` [E,f,d].  The tables are built in x's dtype: the reference's
    casts of its fp32 tables, bit for bit, at half the memory in bf16."""
    t, d = x.shape
    g, s, cap = moe_groups(t, group_size, num_experts, k, capacity_factor)
    probs = moe_router_probs(x[: g * s].reshape(g, s, d), params["router"])
    disp, comb, aux = moe_tables(probs, k, cap, x.dtype)
    return moe_experts(x, disp, comb, params, g, s), aux


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


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, chunked dual form)
# ---------------------------------------------------------------------------


def ssd_scan(x, dt, a_log, b_mat, c_mat, *, chunk: int = 128, h0=None,
             return_state: bool = False):
    """Mamba-2 SSD.  x: [B,S,H,P]; dt: [B,S,H]; a_log: [H] (A =
    -exp(a_log)); b_mat, c_mat: [B,S,N] (one group) -> y [B,S,H,P] in x's
    dtype (and, with ``return_state``, the fp32 state after the last step,
    [B,H,N,P]).  ``h0``: the state before the first step (default zeros).

    h_t = exp(dt_t A_h) h_{t-1} + (dt_t x_t) outer b_t ;  y_t = h_t . c_t.

    The chunk-parallel form of the reference's chunk-by-chunk scan, each
    head's chunks as a batch of matrices ([B, H, nc, ...], fp32): every
    chunk's intra-chunk term and its own contribution to the state after
    it at once ([B, H, nc, Q, Q] scores), then the states entering the
    chunks from those contributions and h0 in one product with the
    chunks' decays ([B, H, nc+1, nc+1]; the decay from chunk j to chunk i
    a sum of the chunks' log decays between them, never a difference of
    running sums).  A sequence that is not a multiple of ``chunk`` is one
    chunk (the reference's fallback).  Above the diagonal the decay
    exponent is positive, so it is masked to -inf before the exp, never
    after (exp would overflow and inf * 0 be NaN).  Static shapes, no
    host values: it runs under ``vmap`` and in a CUDA graph capture."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if s % chunk:
        chunk = s
    nc = s // chunk
    dtf = dt.float().reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)
    xb = x.reshape(bsz, nc, chunk, h, p).permute(0, 3, 1, 2, 4) \
        * dtf[..., None]                             # [B,H,nc,Q,P], fp32
    bm = b_mat.float().reshape(bsz, 1, nc, chunk, n)
    cm = c_mat.float().reshape(bsz, 1, nc, chunk, n)
    a_neg = -torch.exp(a_log.float())
    la_cum = torch.cumsum(dtf * a_neg[:, None, None], dim=-1)  # [B,H,nc,Q]
    iq = torch.arange(chunk, device=x.device)
    # intra-chunk (attention-like)
    decay = la_cum[..., :, None] - la_cum[..., None, :]      # [B,H,nc,i,j]
    scores = (cm @ bm.transpose(-1, -2)) * torch.exp(
        torch.where(iq[:, None] >= iq[None, :], decay, -torch.inf))
    y = scores @ xb                                          # [B,H,nc,Q,P]
    # each chunk's own contribution to the state after it: [B,H,nc,N,P]
    tail = torch.exp(la_cum[..., -1:] - la_cum)[..., None]
    sc = bm.transpose(-1, -2) @ (xb * tail)
    # the states entering chunks 0..nc-1 and the last state: entry i of
    # [h0, sc_0, ..., sc_{nc-1}] decayed by chunks j..i-1 into slot i
    z = F.pad(la_cum[..., -1], (1, 0))                       # [B,H,nc+1]
    ic = torch.arange(nc + 1, device=x.device)
    seg = torch.cumsum(torch.where(ic[:, None] > ic[None, :],
                                   z[..., :, None], 0.0), dim=-2)
    dec = torch.exp(torch.where(ic[:, None] >= ic[None, :], seg,
                                -torch.inf))                 # [B,H,i,j]
    h_in = torch.zeros((bsz, h, 1, n, p), dtype=torch.float32,
                       device=x.device) if h0 is None \
        else h0.float()[:, :, None]
    states = torch.cat([h_in, sc], 2).flatten(-2)            # [B,H,nc+1,NP]
    hs = (dec @ states).unflatten(-1, (n, p))                # [B,H,nc+1,N,P]
    # inter-chunk, from the carried state
    y = torch.addcmul(y, cm @ hs[:, :, :nc], torch.exp(la_cum)[..., None])
    # the cast and the layout in one pass
    y = y.permute(0, 2, 3, 1, 4).to(
        x.dtype, memory_format=torch.contiguous_format).reshape(bsz, s, h, p)
    return (y, hs[:, :, nc]) if return_state else y


def ssd_decode(x, dt, a_log, b_mat, c_mat, h):
    """One step.  x: [B,H,P]; dt: [B,H]; b_mat, c_mat: [B,N]; h: [B,H,N,P]
    fp32 -> ``(y [B,H,P] in x's dtype, h)``, in the reference's fp32
    order; ``h`` is updated in place and returned."""
    dtf = dt.float()
    a = torch.exp(dtf * -torch.exp(a_log.float()))
    xb = x.float() * dtf[..., None]
    h.mul_(a[:, :, None, None]).add_(
        b_mat.float()[:, None, :, None] * xb[:, :, None, :])
    y = torch.einsum("bhnp,bn->bhp", h, c_mat.float())
    return y.to(x.dtype), h
