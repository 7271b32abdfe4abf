"""SplitModelBundle: the uniform interface the FSL methods operate on
(``repro.core.bundle``), for the split transformers and the paper's split
CNNs."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch.func import functional_call

from repro_torch.common import dtype_of, resolve_device, tree_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import model as tf_mod
from repro_torch.models.blocks import Ctx
from repro_torch.models.layers import cross_entropy


def _named_leaves(tree, name: str = ""):
    """``(key, leaf)`` pairs in ``tree_leaves`` order, each leaf with the
    dict key it sits under."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _named_leaves(v, name)
    else:
        yield name, tree


def same_axes(tree) -> list:
    """A parameter tree already laid out as the JAX package keeps it: no
    leaf moves (the transformers)."""
    return [None] * len(tree_leaves(tree))


def cnn_wire_axes(tree) -> list:
    """Per leaf of a client's CNN parameter tree (``tree_leaves`` order),
    the axes that lay it out as the JAX package's checkpoint does: conv
    weights OIHW -> HWIO, ``nn.Linear`` weights ``[dout, din]`` -> ``[din,
    dout]``; None where nothing moves (biases)."""
    out = []
    for name, t in _named_leaves(tree):
        if name.endswith(".weight") and t.dim() in (2, 4):
            out.append((2, 3, 1, 0) if t.dim() == 4 else (1, 0))
        else:
            out.append(None)
    return out


@dataclasses.dataclass(frozen=True)
class SplitModelBundle:
    """Pure functions over explicit parameter dicts.

    params layout: ``{"client": ..., "aux": ..., "server": ...}``, each a
    tree of tensors; ``init(generator)`` draws them on ``device``.
    ``specs`` holds the same layout as ``meta`` tensors (shapes only).
    ``inputs`` is a tree (``{"tokens": ...}`` for transformers, a tensor
    for CNNs); ``labels`` an int tensor.  ``wire_axes(tree)`` gives, per
    leaf of a client's parameter tree, the axes permutation that lays it
    out as the JAX package's checkpoint (None: as it is): the model-sync
    wire codes each leaf in that layout, so its 8x128 tiles and its wire
    bytes are the JAX package's.
    """
    name: str
    device: torch.device
    init: Callable[[torch.Generator], Dict[str, Any]]
    specs: Dict[str, Dict[str, torch.Tensor]]
    client_loss: Callable[..., Any]       # (cp, ap, inputs, labels) -> (loss, smashed)
    server_loss: Callable[..., Any]       # (sp, smashed, labels) -> loss
    client_smashed: Callable[..., Any]    # (cp, inputs) -> smashed
    e2e_loss: Callable[..., Any]          # (cp, sp, inputs, labels) -> loss
    smashed_bytes_per_sample: int = 0     # q in Table II (at model dtype)
    label_bytes_per_sample: int = 4
    wire_axes: Callable[[Any], list] = same_axes


def transformer_bundle(cfg: ModelConfig, device="cuda") -> SplitModelBundle:
    """The split transformer of ``cfg`` on ``device`` (default the card;
    raises when there is none — pass ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    ctx = Ctx(cfg, "train", window=cfg.swa_window)

    def client_loss(cp, ap, inputs, labels):
        return tf_mod.client_loss(cfg, cp, ap, inputs, labels, ctx)

    def server_loss(sp, smashed, labels):
        return tf_mod.server_loss(cfg, sp, smashed, labels, ctx)

    def client_smashed(cp, inputs):
        smashed, _, _ = tf_mod.client_forward(cfg, cp, inputs, ctx)
        return smashed

    def e2e_loss(cp, sp, inputs, labels):
        smashed, aux1, _ = tf_mod.client_forward(cfg, cp, inputs, ctx)
        x, aux2, _ = tf_mod.server_forward(cfg, sp, smashed, ctx)
        loss = tf_mod.chunked_ce(x, tf_mod.server_logits_fn(cfg, sp), labels)
        return loss + tf_mod.MOE_AUX_COEF * (aux1 + aux2)

    itemsize = torch.empty((), dtype=dtype_of(cfg.dtype)).element_size()
    return SplitModelBundle(
        name=cfg.name,
        device=device,
        init=lambda gen: tf_mod.init_params(cfg, gen, device),
        specs=tf_mod.param_specs(cfg),
        client_loss=client_loss,
        server_loss=server_loss,
        client_smashed=client_smashed,
        e2e_loss=e2e_loss,
        smashed_bytes_per_sample=cfg.d_model * itemsize,  # q: one token
    )


def cnn_bundle(cfg: cnn_mod.CNNConfig, device="cuda") -> SplitModelBundle:
    """The split CNN of ``cfg`` on ``device`` (default the card; raises when
    there is none — pass ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    st = cnn_mod.stages(cfg)

    def client_smashed(cp, inputs):
        return functional_call(st["client"], cp, (inputs,))

    def client_loss(cp, ap, inputs, labels):
        smashed = client_smashed(cp, inputs)
        logits = functional_call(st["aux"], ap, (smashed,))
        return cross_entropy(logits, labels), smashed

    def server_loss(sp, smashed, labels):
        logits = functional_call(st["server"], sp, (smashed,))
        return cross_entropy(logits, labels)

    def e2e_loss(cp, sp, inputs, labels):
        return server_loss(sp, client_smashed(cp, inputs), labels)

    return SplitModelBundle(
        name=cfg.name,
        device=device,
        init=lambda gen: cnn_mod.init_params(cfg, gen, device),
        specs={k: {n: p.detach() for n, p in m.named_parameters()}
               for k, m in st.items()},
        client_loss=client_loss,
        server_loss=server_loss,
        client_smashed=client_smashed,
        e2e_loss=e2e_loss,
        smashed_bytes_per_sample=cfg.smashed_size * 4,
        wire_axes=cnn_wire_axes,
    )
