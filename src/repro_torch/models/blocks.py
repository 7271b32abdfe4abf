"""Per-layer blocks, init + apply (``repro.models.blocks``), for the dense
and Mamba-1 kinds in training mode.

A block is ``(cfg, params, x, ctx, cache) -> (x, new_cache, aux_loss)``.
Depth comes from params stacked on a leading layer axis (``model.py``).
The MoE, Mamba-2 and hybrid kinds, and the prefill/decode cache branches,
come with the slices that port them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    mode: str                      # "train" (the only mode ported)
    pos: int = 0                   # q offset
    window: int = 0                # sliding window (0 = full)


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
    if ctx.mode != "train":
        raise NotImplementedError("the prefill/decode cache branches are "
                                  "not ported yet")
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
    pos_ids = (torch.arange(s, device=x.device) + ctx.pos)[None].expand(b, s)
    q = L.apply_rope(q, pos_ids, cfg.rope_theta)
    k = L.apply_rope(k, pos_ids, cfg.rope_theta)
    # the reference's gate for the sliding-window kernel (K6)
    if (cfg.use_pallas and ctx.window and not cfg.encoder_only
            and s % 128 == 0):
        from repro_torch.kernels import ops
        out = ops.swa_attention(q, k, v, ctx.window)
    else:
        out = L.attention(q, k, v, causal=not cfg.encoder_only,
                          window=ctx.window, q_offset=ctx.pos)
    y = out.reshape(b, s, h * hd) @ p["wo"]
    return x + y, None


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
    if ctx.mode != "train":
        raise NotImplementedError("the prefill/decode cache branches are "
                                  "not ported yet")
    xn = L.rmsnorm(x, p["ln"])
    xin, z = torch.chunk(xn @ p["in_proj"], 2, dim=-1)
    xc0 = L.causal_conv1d(xin, p["conv_w"], p["conv_b"])
    xc, dt, a, b_mat, c_mat = _mamba1_inner(cfg, p, xc0)
    # the reference's gate for the selective-scan kernel (K5)
    if cfg.use_pallas and cfg.d_inner % 128 == 0:
        from repro_torch.kernels import ops
        y = ops.ssm_scan(xc, dt, a, b_mat, c_mat, p["d_skip"], cfg.ssm_chunk)
    else:
        y = L.selective_scan(xc, dt, a, b_mat, c_mat, p["d_skip"],
                             chunk=cfg.ssm_chunk)
    y = y * L.silu(z)
    return x + y @ p["out_proj"], None, 0.0


BLOCKS = {
    "dense": (dense_init, dense_apply),
    "mamba1": (mamba1_init, mamba1_apply),
}


def block_kind(cfg: ModelConfig) -> str:
    if cfg.family == "dense":
        return "dense"
    if cfg.family == "ssm":
        kind = cfg.ssm_variant or "mamba1"
        if kind in BLOCKS:
            return kind
    raise NotImplementedError(f"block kind of family {cfg.family!r} "
                              f"({cfg.ssm_variant or 'default'}) is not "
                              "ported yet")
