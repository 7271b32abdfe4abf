"""Input stand-ins for the serving shapes (``repro.launch.specs``, its
serving half): ``prefill_specs``, ``decode_specs`` and
``combo_supported``.

With ``as_spec=True`` they return ``meta`` tensors (shapes and dtypes,
nothing allocated: the port's ``jax.ShapeDtypeStruct``); otherwise real
tensors on ``device``, the tokens drawn with numpy from ``seed`` as the
reference draws them.  ``train_batch_specs`` comes with the dry run
(ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def _batch_inputs(cfg: ModelConfig, lead: Tuple[int, ...], seq: int,
                  as_spec: bool, rng, device) -> Dict[str, Any]:
    """One batch's inputs ``{"tokens": lead + (seq,)}`` (int32)."""
    shape = lead + (seq,)
    if as_spec:
        return {"tokens": _spec(shape, torch.int32)}
    toks = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
    return {"tokens": torch.from_numpy(toks).to(device)}


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
