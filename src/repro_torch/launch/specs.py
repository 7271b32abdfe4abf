"""Input stand-ins for every (arch x input shape) combination
(``repro.launch.specs``): ``train_batch_specs``, ``prefill_specs``,
``decode_specs`` and ``combo_supported``.

With ``as_spec=True`` they return ``meta`` tensors (shapes and dtypes,
nothing allocated: the port's ``jax.ShapeDtypeStruct``); otherwise real
tensors on ``device``, drawn with numpy from ``seed`` in the reference's
order and dtypes, so the draws are the reference's bit for bit: int32
tokens, then the vlm's fp32 ``image_embeds``; the audio model's fp32
``features`` alone.  The specs declare the float leaves in the model's
dtype, as the reference's do.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.common import dtype_of
from repro_torch.configs.base import FSLConfig, ModelConfig, ShapeConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def _batch_inputs(cfg: ModelConfig, lead: Tuple[int, ...], seq: int,
                  as_spec: bool, rng, device) -> Dict[str, Any]:
    """One batch's input tree with leading dims ``lead`` (e.g. ``(n, h,
    B)``): ``{"tokens": lead + (seq,)}`` (int32), the vlm's
    ``"image_embeds": lead + (P, d)`` beside it, or the audio model's
    ``{"features": lead + (seq, frontend_dim)}``."""
    dt = dtype_of(cfg.dtype)

    def arr(shape, dtype, draw):
        if as_spec:
            return _spec(shape, dtype)
        return torch.from_numpy(draw(shape)).to(device)

    def normal(shape):
        return rng.normal(size=shape).astype(np.float32)

    if cfg.family == "audio":
        return {"features": arr(lead + (seq, cfg.frontend_dim), dt, normal)}
    def tokens(shape):
        return rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)

    out = {"tokens": arr(lead + (seq,), torch.int32, tokens)}
    if cfg.family == "vlm":
        out["image_embeds"] = arr(lead + (cfg.num_image_tokens, cfg.d_model),
                                  dt, normal)
    return out


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, fsl: FSLConfig,
                      h: int | None = None, as_spec: bool = True,
                      seed: int = 0, device="cuda"):
    """``(inputs, labels)`` of one round with leading ``[n_clients, h,
    B_local]`` dims (B_local = the shape's global batch over the clients);
    labels int32 ``[n, h, B, S]``, drawn after the inputs."""
    n = fsl.num_clients
    hh = h if h is not None else fsl.h
    if shape.global_batch % n:
        raise ValueError(f"global batch {shape.global_batch} is not a "
                         f"multiple of {n} clients")
    b = shape.global_batch // n
    rng = None if as_spec else np.random.default_rng(seed)
    inputs = _batch_inputs(cfg, (n, hh, b), shape.seq_len, as_spec, rng,
                           device)
    lshape = (n, hh, b, shape.seq_len)
    if as_spec:
        return inputs, _spec(lshape, torch.int32)
    return inputs, torch.from_numpy(rng.integers(
        0, cfg.vocab_size, lshape, dtype=np.int32)).to(device)


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig, as_spec: bool = True,
                  seed: int = 0, device="cuda"):
    rng = None if as_spec else np.random.default_rng(seed)
    return _batch_inputs(cfg, (shape.global_batch,), shape.seq_len, as_spec,
                         rng, device)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, as_spec: bool = True,
                 seed: int = 0, device="cuda"):
    """``(token [B], pos (0-d), caches, window)``.  The cache holds the
    whole context, except past 32k tokens for a sliding-window arch, where
    the ring buffer is the window (``long_500k``)."""
    from repro_torch.models.model import (decode_cache_specs,
                                          init_decode_caches)
    b = shape.global_batch
    cache_len = shape.seq_len
    window = 0
    if shape.seq_len > 32_768 and cfg.swa_window:
        window = cfg.swa_window
        cache_len = cfg.swa_window
    if as_spec:
        token = _spec((b,), torch.int32)
        pos = _spec((), torch.int32)
        caches = decode_cache_specs(cfg, b, cache_len)
    else:
        rng = np.random.default_rng(seed)
        token = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b,),
                                              dtype=np.int32)).to(device)
        pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                           device=device)
        caches = init_decode_caches(cfg, b, cache_len, device=device)
    return token, pos, caches, window


def combo_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) runs, and the reason where it does not."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only: no autoregressive decode step"
    if (shape.kind == "decode" and shape.seq_len > 32_768
            and cfg.family in ("dense", "moe", "vlm") and not cfg.swa_window):
        return False, ("full attention at 500k context requires "
                       "sub-quadratic variant")
    return True, ""
