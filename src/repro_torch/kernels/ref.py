"""Plain PyTorch versions of the port's kernels.

``fused_ce*`` (the LM-head cross-entropy, K3/K4a/K4b) and
``swa_attention`` (K6) compute with materialized fp32 logits and scores, as
``repro.kernels.ref`` does; ``fused_ce_fwd``/``fused_ce_bwd`` have the CUDA
kernels' grouped signatures, ``swa_attention_fwd`` also gives the rows'
base-2 log-sum-exp the CUDA kernels save, and ``swa_attention_bwd`` is the
plain backward (the JAX package has no backward kernel for K6; on the
card bf16 runs kernels instead).
``ssm_scan`` (the Mamba-1 scan, K5) steps through time as
``repro.kernels.ref.ssm_scan`` does, with K5's grouped ``a``/``d``;
``ssm_scan_bwd`` is its backward on every device, chunk by chunk.

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

import math

import torch
import torch.nn.functional as F

BT, BC = 8, 128                  # wire tile; one fp32 scale per tile
INT8_MAX = 127.0
FP8_MAX = 448.0                  # float8_e4m3fn largest finite value
LOG2E = 1.4426950408889634       # log2(e): the attention kernels' lse base
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


# ---------------------------------------------------------------------------
# Fused linear + cross entropy (the aux / server LM-head loss)
# ---------------------------------------------------------------------------

CE_ROWS = 512      # rows per chunk of the grouped versions: bounds [G,rows,V]


def fused_ce(x, w, labels):
    """Mean CE of softmax(x @ w) against labels.  x: [T,d]; w: [d,V];
    labels: [T] -> fp32 scalar."""
    logits = x.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - picked).mean()


def fused_ce_grads(x, w, labels, g=1.0):
    """(dx, dw) of ``g * fused_ce``, in x's and w's dtypes."""
    t = x.shape[0]
    logits = x.float() @ w.float()
    p = torch.softmax(logits, dim=-1)
    p = p - F.one_hot(labels.long(), w.shape[1]).float()
    p = p * (g / t)
    return (p @ w.float().T).to(x.dtype), (x.float().T @ p).to(w.dtype)


def fused_ce_fwd(x, w, labels):
    """Per-row ``(lse, picked)`` fp32 ``[G, T]`` of the logits ``x @ w``.
    x: [G,T,d]; w: [G,d,V]; labels: [G,T] int."""
    wf = w.float()
    lse, picked = [], []
    for i in range(0, x.shape[1], CE_ROWS):
        logits = x[:, i:i + CE_ROWS].float() @ wf
        lse.append(torch.logsumexp(logits, dim=-1))
        picked.append(logits.gather(
            -1, labels[:, i:i + CE_ROWS].long()[..., None])[..., 0])
    return torch.cat(lse, 1), torch.cat(picked, 1)


def _ce_p(x, wf, labels, lse, g):
    """``(rows, x chunk, P chunk)`` over row chunks, fp32, with
    ``P = (exp(x @ w - lse) - onehot(labels)) * g / T``."""
    t, v = x.shape[1], wf.shape[2]
    scale = (g.float() / t)[:, None, None]
    cols = torch.arange(v, device=x.device)
    for i in range(0, t, CE_ROWS):
        xc = x[:, i:i + CE_ROWS].float()
        p = torch.exp(xc @ wf - lse[:, i:i + CE_ROWS, None])
        hit = cols == labels[:, i:i + CE_ROWS, None].long()
        yield xc, torch.where(hit, p - 1.0, p) * scale


def fused_ce_dx(x, w, labels, lse, g):
    """``dx = P w^T`` in x's dtype (K4a)."""
    wf = w.float()
    return torch.cat([p @ wf.transpose(1, 2)
                      for _, p in _ce_p(x, wf, labels, lse, g)], 1).to(x.dtype)


def fused_ce_dw(x, w, labels, lse, g):
    """``dw = x^T P`` in w's dtype (K4b)."""
    wf = w.float()
    dw = torch.zeros(wf.shape, dtype=torch.float32, device=w.device)
    for xc, p in _ce_p(x, wf, labels, lse, g):
        dw = dw + xc.transpose(1, 2) @ p
    return dw.to(w.dtype)


def fused_ce_bwd(x, w, labels, lse, g):
    """``(dx, dw)`` of ``g[G] * mean_t CE`` from the saved per-row ``lse``,
    in x's and w's dtypes."""
    return (fused_ce_dx(x, w, labels, lse, g),
            fused_ce_dw(x, w, labels, lse, g))


# ---------------------------------------------------------------------------
# Sliding-window causal attention
# ---------------------------------------------------------------------------


def _swa_scores(q, k, window: int):
    """Scaled scores ``[B,H,S,S]`` fp32 of causal attention restricted to
    the trailing ``window`` positions (0 = no window), -inf where masked."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores.mul_(1.0 / math.sqrt(hd))
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > qp - window
    return scores.masked_fill_(~mask, float("-inf"))


def _swa_probs(q, k, window: int):
    """Softmax weights ``[B,H,S,S]`` fp32 of :func:`_swa_scores`."""
    return torch.softmax(_swa_scores(q, k, window), dim=-1)


def swa_attention(q, k, v, window: int):
    """Materialized-scores reference.  q: [B,S,H,hd]; k,v: [B,S,KH,hd] ->
    [B,S,H,hd] in q's dtype."""
    rep = q.shape[2] // k.shape[2]
    v = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    wts = _swa_probs(q, k, window)
    return torch.einsum("bhqk,bkhd->bqhd", wts, v.float()).to(q.dtype)


def swa_attention_fwd(q, k, v, window: int):
    """``(o, lse)``: :func:`swa_attention` and each row's log-sum-exp
    ``[B,H,S]`` fp32 in base 2 of the scaled scores, ``log2 sum_k
    2^(s_k log2(e) / sqrt(hd))``, the residual the backward kernels
    recompute P from."""
    rep = q.shape[2] // k.shape[2]
    v = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    scores = _swa_scores(q, k, window)
    lse = torch.logsumexp(scores, dim=-1).mul_(LOG2E)
    wts = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", wts, v.float()).to(q.dtype), lse


def swa_attention_bwd_delta(o, g):
    """``rowsum(g o)`` ``[B,H,S]`` fp32 of output ``o`` and cotangent
    ``g`` ``[B,S,H,hd]``: the backward kernels' first step."""
    return (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def swa_attention_bwd(q, k, v, g, window: int):
    """``(dq, dk, dv)`` of :func:`swa_attention` for the output cotangent
    ``g``, recomputed in fp32 from q, k, v: ``dV = P^T g``,
    ``dS = P (dP - rowsum(g o))`` with ``dP = g V^T`` (``rowsum(dP P)`` is
    ``rowsum(g o)``), ``dQ = dS K / sqrt(hd)``, ``dK = dS^T Q / sqrt(hd)``,
    with the GQA groups summed onto their kv head.  Updates its own
    ``[B,H,S,S]`` temporaries in place, so it runs outside autograd."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    rep = h // kh
    kr = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vr = (v.repeat_interleave(rep, dim=2) if rep > 1 else v).float()
    p = _swa_probs(q, k, window)                          # [B,H,S,S]
    gf = g.float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    delta = (gf * o).sum(-1).transpose(1, 2)[..., None]   # [B,H,S,1]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    ds = torch.einsum("bqhd,bkhd->bhqk", gf, vr)          # dP
    ds.sub_(delta).mul_(p).mul_(1.0 / math.sqrt(hd))
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    if rep > 1:
        dk = dk.reshape(b, s, kh, rep, hd).sum(3)
        dv = dv.reshape(b, s, kh, rep, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Mamba-1 selective scan
# ---------------------------------------------------------------------------


def _per_batch(a, d, bsz: int):
    """K5's grouped ``a [G,D,N]`` / ``d [G,D]`` (or ungrouped ``[D,N]`` /
    ``[D]``) as one row per batch row: batch row i uses group
    ``i // (B // G)``."""
    if a.dim() == 2:
        a, d = a[None], d[None]
    g = a.shape[0]
    if bsz % g:
        raise ValueError(f"batch {bsz} is not a multiple of {g} groups")
    return (a.float().repeat_interleave(bsz // g, 0),
            d.float().repeat_interleave(bsz // g, 0))


def ssm_scan(u, dt, a, b_mat, c_mat, d_vec, chunk=None):
    """Sequential-in-time Mamba-1 scan (the plain version of K5).

    u, dt: [B,S,D]; a: [G,D,N] (or [D,N]); b_mat, c_mat: [B,S,N];
    d_vec: [G,D] (or [D]) -> y [B,S,D] in u's dtype, with fp32 state:
    h_t = exp(dt_t a) h_{t-1} + (dt_t u_t) b_t ;  y_t = c_t . h_t + d u_t.
    With ``chunk`` returns ``(y, states)``: states [B, ceil(S/chunk), D, N]
    fp32 holds h after min((i + 1) chunk, S) steps.
    """
    bsz, s, dim = u.shape
    ab, db = _per_batch(a, d_vec, bsz)
    h = torch.zeros(ab.shape, dtype=torch.float32, device=u.device)
    y = torch.empty((bsz, s, dim), dtype=torch.float32, device=u.device)
    hs = None if chunk is None else torch.empty(
        (bsz, -(-s // chunk)) + tuple(ab.shape[1:]), dtype=torch.float32,
        device=u.device)
    for t in range(s):
        dtt, ut = dt[:, t].float(), u[:, t].float()
        h = torch.exp(dtt[..., None] * ab) * h \
            + (dtt * ut)[..., None] * b_mat[:, t, None, :].float()
        y[:, t] = torch.einsum("bdn,bn->bd", h, c_mat[:, t].float()) \
            + db * ut
        if hs is not None and ((t + 1) % chunk == 0 or t == s - 1):
            hs[:, t // chunk] = h
    return y.to(u.dtype) if hs is None else (y.to(u.dtype), hs)


def _linear_scan_(a, b):
    """``models.layers.linear_scan``'s doubling scan of
    ``h_t = a_t h_{t-1} + b_t`` along dim 1, in place and with the same
    arithmetic: ``a`` becomes ``prod_{s<=t} a_s`` and ``b`` becomes ``h``.
    Outside autograd only."""
    k, n = 1, a.shape[1]
    while k < n:
        b[:, k:] += a[:, k:] * b[:, :-k]
        a[:, k:] = a[:, k:] * a[:, :-k]
        k *= 2
    return b


def ssm_scan_bwd(u, dt, a, b_mat, c_mat, d_vec, gy, chunk: int = 128):
    """Gradients ``(du, ddt, da, db_mat, dc_mat, dd)`` of :func:`ssm_scan`
    for the output cotangent ``gy``, in the inputs' dtypes; ``da`` and
    ``dd`` are summed over the batch rows of each group.

    A forward pass over time chunks keeps only the chunk-boundary states
    ``[nc, B, D, N]``; a reverse walk recomputes each chunk's states and
    runs the adjoint recurrence
    ``g_t = c_t gy_t + exp(dt_{t+1} a) g_{t+1}`` with the same doubling
    scan, so no tensor is larger than ``[B, chunk, D, N]``.  Updates its
    own temporaries in place, so it runs outside autograd."""
    bsz, s, dim = u.shape
    if s % chunk:
        chunk = s
    ab, dvec = _per_batch(a, d_vec, bsz)
    dtf, uf, gyf = dt.float(), u.float(), gy.float()
    bm, cm = b_mat.float(), c_mat.float()

    def chunk_states(i, h0):
        """(exp(dt a), states h_t) of the chunk starting at i, from the
        state h0 before it."""
        dt_c = dtf[:, i:i + chunk]
        da = torch.exp(dt_c[..., None] * ab[:, None])
        h = (dt_c * uf[:, i:i + chunk])[..., None] * bm[:, i:i + chunk,
                                                       None, :]
        acc_a = da.clone()
        return da, _linear_scan_(acc_a, h).addcmul_(acc_a, h0[:, None])

    starts = list(range(0, s, chunk))
    h0s = [torch.zeros(ab.shape, dtype=torch.float32, device=u.device)]
    for i in starts[:-1]:
        h0s.append(chunk_states(i, h0s[-1])[1][:, -1].clone())
    g_u = torch.empty_like(uf)
    g_dt = torch.empty_like(dtf)
    g_b, g_c = torch.empty_like(bm), torch.empty_like(cm)
    g_a = torch.zeros_like(ab)
    carry = torch.zeros_like(ab)            # exp(dt_{t+1} a) g_{t+1}
    for i, h0 in zip(reversed(starts), reversed(h0s)):
        sl = slice(i, i + chunk)
        da, h = chunk_states(i, h0)
        g_c[:, sl] = torch.einsum("bld,bldn->bln", gyf[:, sl], h)
        h_prev = torch.cat([h0[:, None], h[:, :-1]], 1)
        del h
        # reversed in time: g_k = A_k g_{k-1} + e_k, with A_0 g_{-1} the
        # carry and A_k = exp(dt a) of the step after
        e = (gyf[:, sl, :, None] * cm[:, sl, None, :]).flip(1)
        e[:, 0] += carry
        rev_a = torch.cat([torch.ones_like(da[:, :1]), da.flip(1)[:, :-1]], 1)
        g = _linear_scan_(rev_a, e).flip(1)                  # [B,L,D,N]
        del e, rev_a
        carry = da[:, 0] * g[:, 0]
        # through db = (dt u) b and da = exp(dt a)
        gb_sum = torch.einsum("bldn,bln->bld", g, bm[:, sl])
        dt_c, u_c = dtf[:, sl], uf[:, sl]
        g_u[:, sl] = dvec[:, None] * gyf[:, sl] + dt_c * gb_sum
        g_b[:, sl] = torch.einsum("bldn,bld->bln", g, dt_c * u_c)
        gda = g.mul_(h_prev).mul_(da)                       # g h_{t-1} da
        del h_prev, da
        g_dt[:, sl] = torch.einsum("bldn,bdn->bld", gda, ab) + u_c * gb_sum
        g_a += torch.einsum("bldn,bld->bdn", gda, dt_c)
        del gda
    g_d = (gyf * uf).sum(1)
    if a.dim() == 3:
        grp = a.shape[0]
        g_a = g_a.reshape(grp, -1, *g_a.shape[1:]).sum(1)
        g_d = g_d.reshape(grp, -1, dim).sum(1)
    else:
        g_a, g_d = g_a.sum(0), g_d.sum(0)
    return (g_u.to(u.dtype), g_dt.to(dt.dtype), g_a.to(a.dtype),
            g_b.to(b_mat.dtype), g_c.to(c_mat.dtype), g_d.to(d_vec.dtype))


def ssm_scan_bwd_sum(part, rows_a, rows_d, groups: int, dtype):
    """The plain version of the K5 backward's second kernel
    (``ssm_scan.sum_partials``): ``db, dc [B, S, N]`` in ``dtype`` are the
    per-slab partials ``part [2, slabs, B, N, S]`` summed over the slabs,
    ``da [G, D, N]`` and ``dd [G, D]`` the per-row partials summed over
    each group's rows."""
    db, dc = part.sum(1).transpose(-1, -2).contiguous().to(dtype)
    bsz = rows_a.shape[0]
    return (db, dc,
            rows_a.reshape(groups, bsz // groups, *rows_a.shape[1:]).sum(1),
            rows_d.reshape(groups, bsz // groups, -1).sum(1))
