"""The paper's experiment models: split CNNs for CIFAR-10 / F-EMNIST
(``repro.models.cnn``), as three ``nn.Module`` stages.

Client stage: two conv(+pool, +LRN) layers.  Auxiliary net: MLP or
1x1-conv + MLP (paper §VI-C, Tables III/IV).  Server stage: an MLP tower.

The stages hold no weights of their own: they are built on the ``meta``
device and driven with ``torch.func.functional_call`` on parameter dicts
(see :func:`init_params`), so clients can be stacked on dim 0 and
``vmap``-ed.  Inputs are NHWC like the reference; the convs run NCHW
inside, and the smashed tensor leaves the client stage NHWC again, so the
flatten order of the aux/server heads and the codec's 2D wire view
(rows = leading axes, cols = channels) match the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    in_shape: Tuple[int, int, int]          # (H, W, C)
    num_classes: int
    conv_channels: Tuple[int, int] = (64, 64)
    kernel: int = 5
    server_widths: Tuple[int, ...] = (384, 192)
    aux_kind: str = "mlp"                   # "mlp" | "conv1x1"
    aux_channels: int = 54                  # 1x1-conv output channels
    lrn: bool = True
    # "conv_pool_conv_pool" (paper CIFAR-10, SAME convs) or
    # "conv_conv_pool" (paper F-EMNIST, VALID convs — Reddi et al. model)
    layout: str = "conv_pool_conv_pool"

    @property
    def smashed_hw(self) -> Tuple[int, int]:
        h, w, _ = self.in_shape
        if self.layout == "conv_conv_pool":
            k = self.kernel - 1
            return (h - 2 * k) // 2, (w - 2 * k) // 2
        return h // 4, w // 4               # two SAME convs + two 2x2 pools

    @property
    def smashed_size(self) -> int:
        h, w = self.smashed_hw
        return h * w * self.conv_channels[1]


# Paper experiment models, matched to Tables III/IV exactly:
#   CIFAR-10 (TF-tutorial CNN on 24x24 crops): client 107,328 params,
#   aux-MLP 23,050 (2.16%), server 960,970.
CIFAR10 = CNNConfig("cifar10_cnn", (24, 24, 3), 10)
#   F-EMNIST (Reddi et al. CNN): client 18,816, aux-MLP 571,454 (47.36%),
#   server 1,187,774.
FEMNIST = CNNConfig("femnist_cnn", (28, 28, 1), 62,
                    conv_channels=(32, 64), kernel=3, server_widths=(128,),
                    aux_channels=64, lrn=False, layout="conv_conv_pool")


def _pool(x):
    """2x2 max pool, NCHW; an odd edge pools over what is there (the
    reference pads it with -inf)."""
    return F.max_pool2d(x, 2, ceil_mode=True)


def _lrn(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
         k: float = 2.0):
    """x / (k + alpha * sum of squares over a zero-padded window of ``n``
    channels) ** beta, NCHW.  No 1/n on alpha, unlike
    ``F.local_response_norm``."""
    c = x.shape[-3]
    lo = (n - 1) // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, lo, n - 1 - lo))
    summed = sum(sq[..., i:i + c, :, :] for i in range(n))
    return x / (k + alpha * summed).pow(beta)


class ClientCNN(nn.Module):
    def __init__(self, cfg: CNNConfig):
        super().__init__()
        self.cfg = cfg
        c0, c1 = cfg.conv_channels
        pad = "valid" if cfg.layout == "conv_conv_pool" else "same"
        self.conv1 = nn.Conv2d(cfg.in_shape[2], c0, cfg.kernel, padding=pad)
        self.conv2 = nn.Conv2d(c0, c1, cfg.kernel, padding=pad)

    def forward(self, x):
        """x: [B,H,W,C] -> smashed [B,h,w,c]."""
        x = x.permute(0, 3, 1, 2)
        if self.cfg.layout == "conv_conv_pool":      # F-EMNIST
            x = F.relu(self.conv1(x))
            x = _pool(F.relu(self.conv2(x)))
        else:
            x = _pool(F.relu(self.conv1(x)))
            if self.cfg.lrn:
                x = _lrn(x)
            x = _pool(F.relu(self.conv2(x)))
            if self.cfg.lrn:
                x = _lrn(x)
        return x.permute(0, 2, 3, 1)


class AuxHead(nn.Module):
    def __init__(self, cfg: CNNConfig):
        super().__init__()
        h, w = cfg.smashed_hw
        c = cfg.conv_channels[1]
        if cfg.aux_kind == "mlp":
            self.conv = None
            self.fc = nn.Linear(h * w * c, cfg.num_classes)
        else:
            self.conv = nn.Conv2d(c, cfg.aux_channels, 1)
            self.fc = nn.Linear(h * w * cfg.aux_channels, cfg.num_classes)

    def forward(self, smashed):
        x = smashed
        if self.conv is not None:
            x = F.relu(self.conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        return self.fc(x.reshape(x.shape[0], -1))


class ServerMLP(nn.Module):
    def __init__(self, cfg: CNNConfig):
        super().__init__()
        widths = (cfg.smashed_size,) + cfg.server_widths + (cfg.num_classes,)
        self.depth = len(widths) - 1
        for i in range(self.depth):
            setattr(self, f"fc{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, smashed):
        x = smashed.reshape(smashed.shape[0], -1)
        for i in range(self.depth):
            x = getattr(self, f"fc{i}")(x)
            if i < self.depth - 1:
                x = F.relu(x)
        return x


def stages(cfg: CNNConfig) -> Dict[str, nn.Module]:
    """The three stages on the ``meta`` device (structure only)."""
    with torch.device("meta"):
        return {"client": ClientCNN(cfg), "aux": AuxHead(cfg),
                "server": ServerMLP(cfg)}


def _init_stage(module: nn.Module, gen: torch.Generator):
    """normal * fan_in^-1/2 weights, zero biases (the reference's init; the
    numbers differ from ``jax.random``).  Drawn on the CPU from ``gen``, so
    every device starts from the same weights."""
    out = {}
    for name, p in module.named_parameters():
        if name.endswith("weight"):
            fan_in = p.shape[1:].numel()
            out[name] = torch.randn(p.shape, generator=gen) * fan_in ** -0.5
        else:
            out[name] = torch.zeros(p.shape)
    return out


def init_params(cfg: CNNConfig, gen: torch.Generator, device="cpu"):
    """``{"client", "aux", "server"}`` parameter dicts on ``device``."""
    return {k: {n: t.to(device) for n, t in _init_stage(m, gen).items()}
            for k, m in stages(cfg).items()}
