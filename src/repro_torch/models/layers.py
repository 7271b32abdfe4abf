"""Loss functions shared by the port's models (``repro.models.layers``)."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [..., V], labels [...] int (int32 on the wire) -> mean CE (fp32)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()
