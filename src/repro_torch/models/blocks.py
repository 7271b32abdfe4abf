"""Per-layer blocks, init + apply (``repro.models.blocks``), for the dense,
MoE, Mamba-1 and Mamba-2 kinds, in training, prefill and decode mode (the
vlm and audio families run dense blocks: M-RoPE positions for the vlm,
non-causal attention for the encoder-only audio model).

A block is ``(cfg, params, x, ctx, cache) -> (x, new_cache, aux_loss)``.
Depth comes from params stacked on a leading layer axis (``model.py``).
Prefill emits each layer's cache; decode updates the cache it is given in
place and returns it (the attention's ring slot, the conv window, the SSM
state), where the reference returns new arrays that its ``jax.jit``
donates.  The MoE block returns its load-balance loss as ``aux_loss`` (a
0-d fp32 tensor; the others a Python 0.0).  The hybrid family runs
Mamba-2 blocks with a shared dense block between groups of them
(``model.stage_apply``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    mode: str                      # "train" | "prefill" | "decode"
    pos: Any = 0                   # q offset; decode: the write position
                                   # (an int or a 0-d device tensor)
    window: int = 0                # sliding window (0 = full)
    cache_len: int = 0             # allocated cache slots (decode)


def _init(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# Attention sub-block
# ---------------------------------------------------------------------------


def attn_init(cfg: ModelConfig, gen, dtype, lead=()):
    d, h, kh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    lead = tuple(lead)
    p = {
        "ln": torch.ones(lead + (d,), dtype=dtype),
        "wq": _init(gen, lead + (d, h * hd), d ** -0.5, dtype),
        "wk": _init(gen, lead + (d, kh * hd), d ** -0.5, dtype),
        "wv": _init(gen, lead + (d, kh * hd), d ** -0.5, dtype),
        "wo": _init(gen, lead + (h * hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (h * hd,), dtype=dtype)
        p["bk"] = torch.zeros(lead + (kh * hd,), dtype=dtype)
        p["bv"] = torch.zeros(lead + (kh * hd,), dtype=dtype)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype)
    return p


def attn_apply(cfg: ModelConfig, p, x, ctx: Ctx, cache):
    b, s, d = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    xn = L.rmsnorm(x, p["ln"])
    q = xn @ p["wq"]
    k = xn @ p["wk"]
    v = xn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"])
        k = L.rmsnorm(k, p["k_norm"])
    # positions rebuilt from the shape and ctx.pos in every stage: M-RoPE's
    # three streams for the vlm, one stream otherwise
    if cfg.mrope_sections is not None:
        pos_ids = L.mrope_pos_ids(cfg.num_image_tokens, b, s, ctx.pos,
                                  x.device)
    else:
        pos_ids = (torch.arange(s, device=x.device) + ctx.pos)[None].expand(
            b, s)
    q = L.apply_rope(q, pos_ids, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, pos_ids, cfg.rope_theta, cfg.mrope_sections)
    new_cache = None
    if ctx.mode == "decode":
        # cache {"k"/"v": [B, cache_len, KH, hd]}: a ring buffer where the
        # allocated length is a sliding window shorter than the context
        ck, cv = cache["k"], cache["v"]
        clen = ck.shape[1]
        pos = torch.as_tensor(ctx.pos, device=x.device).long()
        slot = (pos % clen).reshape(1)
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        out = L.attention(q, ck, cv, causal=False,
                          kv_len=torch.clamp(pos + 1, max=clen))
        new_cache = cache
    else:
        # the reference's gate for the sliding-window kernel (K6)
        if (cfg.use_pallas and ctx.window and not cfg.encoder_only
                and s % 128 == 0):
            from repro_torch.kernels import ops
            out = ops.swa_attention(q, k, v, ctx.window)
        else:
            out = L.attention(q, k, v, causal=not cfg.encoder_only,
                              window=ctx.window, q_offset=ctx.pos)
        if ctx.mode == "prefill":
            if ctx.window:          # keep only the trailing window
                w = min(ctx.window, s)
                # decode writes position p at slot p % w, so slot i holds
                # the kept position (s-w .. s-1) with p % w == i
                shift = (s - w) % w
                new_cache = {"k": torch.roll(k[:, s - w:], shift, 1),
                             "v": torch.roll(v[:, s - w:], shift, 1)}
            else:
                new_cache = {"k": k, "v": v}
    y = out.reshape(b, s, h * hd) @ p["wo"]
    return x + y, new_cache


def attn_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    """One layer's k/v cache as ``meta`` tensors."""
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


# ---------------------------------------------------------------------------
# Dense MLP sub-block (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_init(cfg: ModelConfig, gen, dtype, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "ln": torch.ones(lead + (d,), dtype=dtype),
        "w1": _init(gen, lead + (d, f), d ** -0.5, dtype),
        "w3": _init(gen, lead + (d, f), d ** -0.5, dtype),
        "w2": _init(gen, lead + (f, d), f ** -0.5, dtype),
    }


def mlp_apply(p, x):
    xn = L.rmsnorm(x, p["ln"])
    hidden = L.silu(xn @ p["w1"]) * (xn @ p["w3"])
    return x + hidden @ p["w2"]


# ---------------------------------------------------------------------------
# Block kinds
# ---------------------------------------------------------------------------


def dense_init(cfg, gen, dtype, lead=()):
    """One dense block's params, each with leading dims ``lead`` (the
    stacked layer axis)."""
    return {"attn": attn_init(cfg, gen, dtype, lead),
            "mlp": mlp_init(cfg, gen, dtype, lead)}


def dense_apply(cfg, p, x, ctx: Ctx, cache):
    x, new_cache = attn_apply(cfg, p["attn"], x, ctx, cache)
    x = mlp_apply(p["mlp"], x)
    return x, new_cache, 0.0


# ---------------------------------------------------------------------------
# MoE (olmoe, phi3.5-moe): the attention sub-block, then top-k experts
# ---------------------------------------------------------------------------


def moe_init(cfg, gen, dtype, lead=()):
    """The router is drawn and kept in fp32 whatever ``dtype`` is."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)
    return {
        "attn": attn_init(cfg, gen, dtype, lead),
        "moe": {
            "ln": torch.ones(lead + (d,), dtype=dtype),
            "router": _init(gen, lead + (d, e), d ** -0.5, torch.float32),
            "w1": _init(gen, lead + (e, d, f), d ** -0.5, dtype),
            "w3": _init(gen, lead + (e, d, f), d ** -0.5, dtype),
            "w2": _init(gen, lead + (e, f, d), f ** -0.5, dtype),
        },
    }


def moe_apply(cfg, p, x, ctx: Ctx, cache):
    """The B*S tokens in groups of ``min(moe_group_size, B*S)``: a decode
    step groups only its B tokens."""
    x, new_cache = attn_apply(cfg, p["attn"], x, ctx, cache)
    b, s, d = x.shape
    xn = L.rmsnorm(x, p["moe"]["ln"]).reshape(b * s, d)
    y, aux = L.moe_ffn(xn, p["moe"], num_experts=cfg.num_experts,
                       k=cfg.num_experts_per_tok,
                       capacity_factor=cfg.moe_capacity_factor,
                       group_size=min(cfg.moe_group_size, b * s))
    return x + y.reshape(b, s, d), new_cache, aux


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba)
# ---------------------------------------------------------------------------


def mamba1_init(cfg, gen, dtype, lead=()):
    d, din, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, k = cfg.resolved_dt_rank, cfg.ssm_conv
    lead = tuple(lead)
    a_init = torch.arange(1, n + 1, dtype=torch.float32).expand(
        lead + (din, n))
    return {
        "ln": torch.ones(lead + (d,), dtype=dtype),
        "in_proj": _init(gen, lead + (d, 2 * din), d ** -0.5, dtype),
        "conv_w": _init(gen, lead + (din, k), k ** -0.5, dtype),
        "conv_b": torch.zeros(lead + (din,), dtype=dtype),
        "x_proj": _init(gen, lead + (din, dtr + 2 * n), din ** -0.5, dtype),
        "dt_w": _init(gen, lead + (dtr, din), dtr ** -0.5, dtype),
        "dt_b": torch.full(lead + (din,), -4.6,        # softplus^-1(0.01)
                           dtype=dtype),
        "a_log": torch.log(a_init),
        "d_skip": torch.ones(lead + (din,), dtype=torch.float32),
        "out_proj": _init(gen, lead + (din, d), din ** -0.5, dtype),
    }


def _mamba1_inner(cfg, p, xc):
    """Shared post-conv math.  xc: [B,S,din] (conv output, pre-SiLU)."""
    n, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    xc = L.silu(xc)
    proj = xc @ p["x_proj"]
    dt_r, b_mat, c_mat = torch.split(proj, [dtr, n, n], dim=-1)
    dt = L.softplus(dt_r @ p["dt_w"] + p["dt_b"])
    a = -torch.exp(p["a_log"])
    return xc, dt, a, b_mat, c_mat


def mamba1_apply(cfg, p, x, ctx: Ctx, cache):
    s = x.shape[1]
    xn = L.rmsnorm(x, p["ln"])
    xin, z = torch.chunk(xn @ p["in_proj"], 2, dim=-1)
    new_cache = None
    if ctx.mode == "decode":
        xc1, conv = L.conv1d_decode(xin[:, 0], cache["conv"], p["conv_w"],
                                    p["conv_b"])
        xc, dt, a, b_mat, c_mat = _mamba1_inner(cfg, p, xc1[:, None])
        y, h = L.selective_scan_decode(xc[:, 0], dt[:, 0], a, b_mat[:, 0],
                                       c_mat[:, 0], p["d_skip"],
                                       cache["ssm"])
        y = y[:, None]
        new_cache = {"conv": conv, "ssm": h}
    else:
        xc0 = L.causal_conv1d(xin, p["conv_w"], p["conv_b"])
        xc, dt, a, b_mat, c_mat = _mamba1_inner(cfg, p, xc0)
        if ctx.mode == "prefill":
            # the reference's prefill takes the plain scan with its state
            y, h = L.selective_scan(xc, dt, a, b_mat, c_mat, p["d_skip"],
                                    chunk=cfg.ssm_chunk, return_state=True)
            kc = cfg.ssm_conv - 1
            new_cache = {"conv": xin[:, s - kc:].contiguous(), "ssm": h}
        # the reference's gate for the selective-scan kernel (K5)
        elif cfg.use_pallas and cfg.d_inner % 128 == 0:
            from repro_torch.kernels import ops
            y = ops.ssm_scan(xc, dt, a, b_mat, c_mat, p["d_skip"],
                             cfg.ssm_chunk)
        else:
            y = L.selective_scan(xc, dt, a, b_mat, c_mat, p["d_skip"],
                                 chunk=cfg.ssm_chunk)
    y = y * L.silu(z)
    return x + y @ p["out_proj"], new_cache, 0.0


def mamba1_cache_spec(cfg, batch, dtype):
    """One layer's conv window and SSM state as ``meta`` tensors."""
    din, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.empty((batch, k - 1, din), dtype=dtype,
                                device="meta"),
            "ssm": torch.empty((batch, din, n), dtype=torch.float32,
                               device="meta")}


# ---------------------------------------------------------------------------
# Mamba-2 (zamba2's backbone)
# ---------------------------------------------------------------------------


def mamba2_init(cfg, gen, dtype, lead=()):
    """``a_log``, ``dt_b`` and ``d_skip`` are kept in fp32 whatever
    ``dtype`` is."""
    d, din, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, k = cfg.resolved_ssm_heads, cfg.ssm_conv
    conv_ch = din + 2 * n
    lead = tuple(lead)
    return {
        "ln": torch.ones(lead + (d,), dtype=dtype),
        "in_proj": _init(gen, lead + (d, 2 * din + 2 * n + h), d ** -0.5,
                         dtype),
        "conv_w": _init(gen, lead + (conv_ch, k), k ** -0.5, dtype),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype),
        "a_log": torch.zeros(lead + (h,), dtype=torch.float32),
        "dt_b": torch.full(lead + (h,), -4.6, dtype=torch.float32),
        "d_skip": torch.ones(lead + (h,), dtype=torch.float32),
        "gate_ln": torch.ones(lead + (din,), dtype=dtype),
        "out_proj": _init(gen, lead + (din, d), din ** -0.5, dtype),
    }


def mamba2_apply(cfg, p, x, ctx: Ctx, cache):
    """The projection splits into z (din), xbc (din + 2N: the conv runs
    over all of it) and dt (H).  The scan's y comes back in the
    activations' dtype and the skip term is added in fp32 after, then cast
    again, as the reference rounds twice."""
    b, s, _ = x.shape
    din, n, nh = cfg.d_inner, cfg.ssm_state, cfg.resolved_ssm_heads
    hp = din // nh
    xn = L.rmsnorm(x, p["ln"])
    z, xbc, dt_raw = torch.split(xn @ p["in_proj"], [din, din + 2 * n, nh],
                                 dim=-1)
    dt = L.softplus(dt_raw.float() + p["dt_b"])
    new_cache = None
    if ctx.mode == "decode":
        xbc1, conv = L.conv1d_decode(xbc[:, 0], cache["conv"], p["conv_w"],
                                     p["conv_b"])
        xin, b_mat, c_mat = torch.split(L.silu(xbc1), [din, n, n], dim=-1)
        xh = xin.reshape(b, nh, hp)
        y, h = L.ssd_decode(xh, dt[:, 0], p["a_log"], b_mat, c_mat,
                            cache["ssm"])
        y = torch.addcmul(y, p["d_skip"][None, :, None], xh).to(x.dtype)
        y = y.reshape(b, 1, din)
        new_cache = {"conv": conv, "ssm": h}
    else:
        xbc_c = L.silu(L.causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
        xin, b_mat, c_mat = torch.split(xbc_c, [din, n, n], dim=-1)
        xh = xin.reshape(b, s, nh, hp)
        if ctx.mode == "prefill":
            y, h = L.ssd_scan(xh, dt, p["a_log"], b_mat, c_mat,
                              chunk=cfg.ssm_chunk, return_state=True)
            kc = cfg.ssm_conv - 1
            # the raw projection, before the conv
            new_cache = {"conv": xbc[:, s - kc:].contiguous(), "ssm": h}
        else:
            y = L.ssd_scan(xh, dt, p["a_log"], b_mat, c_mat,
                           chunk=cfg.ssm_chunk)
        y = torch.addcmul(y, p["d_skip"][None, None, :, None], xh).to(
            x.dtype).reshape(b, s, din)
    y = L.rmsnorm(y * L.silu(z), p["gate_ln"])
    return x + y @ p["out_proj"], new_cache, 0.0


def mamba2_cache_spec(cfg, batch, dtype):
    """One layer's conv window (over the din + 2N conv channels) and SSD
    state ``[B, H, N, P]`` as ``meta`` tensors."""
    din, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh = cfg.resolved_ssm_heads
    return {"conv": torch.empty((batch, k - 1, din + 2 * n), dtype=dtype,
                                device="meta"),
            "ssm": torch.empty((batch, nh, n, din // nh),
                               dtype=torch.float32, device="meta")}


BLOCKS = {
    "dense": (dense_init, dense_apply),
    "moe": (moe_init, moe_apply),
    "mamba1": (mamba1_init, mamba1_apply),
    "mamba2": (mamba2_init, mamba2_apply),
}
# the kinds whose apply returns an aux loss (a tensor)
AUX_KINDS = frozenset({"moe"})


def block_kind(cfg: ModelConfig) -> str:
    if cfg.family == "moe":
        return "moe"
    if cfg.family == "ssm":
        return cfg.ssm_variant or "mamba1"
    if cfg.family == "hybrid":
        return cfg.ssm_variant or "mamba2"
    return "dense"


def block_cache_spec(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     dtype):
    """One layer's decode cache of block ``kind`` as ``meta`` tensors."""
    if kind in ("dense", "moe"):
        return attn_cache_spec(cfg, batch, cache_len, dtype)
    if kind == "mamba1":
        return mamba1_cache_spec(cfg, batch, dtype)
    return mamba2_cache_spec(cfg, batch, dtype)
