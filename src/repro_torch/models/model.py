"""Split model: client stage | cut | server stage (+ aux head)
(``repro.models.model``), for the dense and non-hybrid ssm (Mamba-1)
families in training mode.

The *client stage* owns the embedding and the first ``cut`` blocks; the
*server stage* owns the remaining blocks, the final norm and the LM head.
The *auxiliary network* (paper §IV-A) maps the cut-layer output to a task
loss, so the client trains without server gradients.

Params keep the reference's tree and layouts: weights ``[din, dout]``
(``x @ w``) and block params stacked on a leading ``[L, ...]`` axis, which
``stage_apply`` walks with a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.common import dtype_of, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.blocks import BLOCKS, Ctx, block_kind

MOE_AUX_COEF = 0.01


# ---------------------------------------------------------------------------
# Stage plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StagePlan:
    kind: str
    n_layers: int


def stage_plans(cfg: ModelConfig):
    cut = cfg.resolved_cut
    kind = block_kind(cfg)
    return StagePlan(kind, cut), StagePlan(kind, cfg.num_layers - cut)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _stage_init(cfg: ModelConfig, plan: StagePlan, gen, dtype):
    init_fn, _ = BLOCKS[plan.kind]
    return {"blocks": init_fn(cfg, gen, dtype, lead=(plan.n_layers,))}


def aux_init(cfg: ModelConfig, gen, dtype):
    d, v, r = cfg.d_model, cfg.vocab_size, cfg.aux_rank

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dtype)

    if cfg.aux_kind == "mlp":      # full-width head (paper's MLP analogue)
        return {"ln": torch.ones((d,), dtype=dtype),
                "up": normal((d, v), d ** -0.5)}
    # "lowrank": the 1x1-conv analogue — channel mixing at reduced width
    return {"ln": torch.ones((d,), dtype=dtype),
            "down": normal((d, r), d ** -0.5),
            "up": normal((r, v), r ** -0.5)}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Params drawn from ``gen`` (a CPU generator) and moved to ``device``."""
    dtype = dtype_of(cfg.dtype)
    cplan, splan = stage_plans(cfg)
    d = cfg.d_model
    client = {"blocks_stage": _stage_init(cfg, cplan, gen, dtype),
              "embed": (torch.randn((cfg.vocab_size, d), generator=gen)
                        * d ** -0.5).to(dtype)}
    server = {"blocks_stage": _stage_init(cfg, splan, gen, dtype),
              "ln_f": torch.ones((d,), dtype=dtype),
              "head": (torch.randn((d, cfg.vocab_size), generator=gen)
                       * d ** -0.5).to(dtype)}
    params = {"client": client, "aux": aux_init(cfg, gen, dtype),
              "server": server}
    return tree_map(lambda t: t.to(device), params)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The params' shapes and dtypes as ``meta`` tensors (nothing drawn)."""
    with torch.device("meta"):
        return init_params(cfg, None, device="meta")


def aux_logits_fn(cfg: ModelConfig, ap) -> Callable:
    def f(x):
        xn = L.rmsnorm(x, ap["ln"])
        if "down" in ap:
            xn = xn @ ap["down"]
        return xn @ ap["up"]
    return f


# ---------------------------------------------------------------------------
# Stage application
# ---------------------------------------------------------------------------


def stage_apply(cfg: ModelConfig, plan: StagePlan, sp, x, ctx: Ctx):
    """Run a stage's stacked blocks in order.  Returns ``(x, aux, None)``
    (no caches in training mode).

    The stacked params are split with one ``unbind`` per leaf, whose
    backward stacks the layers' grads once.  Indexing ``a[i]`` per layer
    would make each layer's backward a zero-filled grad of the whole stack,
    summed across layers: a stack's size per layer and leaf (4 GiB for
    falcon-mamba's 4 stacked clients' ``in_proj``)."""
    _, apply_fn = BLOCKS[plan.kind]
    aux = 0.0
    for p in _unstack(sp["blocks"]):
        x, _, a = apply_fn(cfg, p, x, ctx, None)
        aux = aux + a
    return x, aux, None


def _unstack(tree):
    """``[tree[0], tree[1], ...]`` of a tree of stacked tensors."""
    parts = [t.unbind(0) for t in tree_leaves(tree)]
    out = []
    for layer in zip(*parts):
        it = iter(layer)
        out.append(tree_map(lambda _: next(it), tree))
    return out


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, cp, inputs: Dict[str, Any]):
    """inputs ``{"tokens": [B,S]}`` -> x [B,S,d]."""
    return F.embedding(inputs["tokens"].long(), cp["embed"])


# ---------------------------------------------------------------------------
# Losses (chunked over the sequence so [B,S,V] never materializes)
# ---------------------------------------------------------------------------


def chunked_ce(x, logits_fn, labels, chunk: int = 128):
    b, s, _ = x.shape
    if s <= chunk:
        return L.cross_entropy(logits_fn(x), labels)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    total = 0.0
    for i in range(0, s, chunk):
        total = total + L.cross_entropy(logits_fn(x[:, i:i + chunk]),
                                        labels[:, i:i + chunk])
    return total / (s // chunk)


def head_ce(cfg: ModelConfig, pre, head_w, labels):
    """CE of ``pre @ head_w`` vs labels; the fused kernels (K3, K4a, K4b)
    when ``cfg.use_pallas``.  pre: [B,S,r]; head_w: [r,V]; labels: [B,S]."""
    if cfg.use_pallas:
        from repro_torch.kernels import ops
        t = pre.shape[0] * pre.shape[1]
        return ops.fused_ce(pre.reshape(t, -1), head_w, labels.reshape(t))
    return chunked_ce(pre, lambda xc: xc @ head_w, labels)


# ---------------------------------------------------------------------------
# Public forward passes
# ---------------------------------------------------------------------------


def client_forward(cfg: ModelConfig, cp, inputs, ctx: Ctx):
    cplan, _ = stage_plans(cfg)
    return stage_apply(cfg, cplan, cp["blocks_stage"],
                       embed_inputs(cfg, cp, inputs), ctx)


def server_forward(cfg: ModelConfig, sp, smashed, ctx: Ctx):
    _, splan = stage_plans(cfg)
    return stage_apply(cfg, splan, sp["blocks_stage"], smashed, ctx)


def server_logits_fn(cfg: ModelConfig, sp) -> Callable:
    def f(x):
        return L.rmsnorm(x, sp["ln_f"]) @ sp["head"]
    return f


def client_loss(cfg: ModelConfig, cp, ap, inputs, labels, ctx: Ctx):
    """Local loss through the auxiliary head (Eq. 5).  Returns
    ``(loss, smashed)``."""
    smashed, moe_aux, _ = client_forward(cfg, cp, inputs, ctx)
    pre = L.rmsnorm(smashed, ap["ln"])
    if "down" in ap:
        pre = pre @ ap["down"]
    loss = head_ce(cfg, pre, ap["up"], labels)
    return loss + MOE_AUX_COEF * moe_aux, smashed


def server_loss(cfg: ModelConfig, sp, smashed, labels, ctx: Ctx):
    """Server loss on the (detached) smashed data (Eq. 7)."""
    x, moe_aux, _ = server_forward(cfg, sp, smashed, ctx)
    loss = head_ce(cfg, L.rmsnorm(x, sp["ln_f"]), sp["head"], labels)
    return loss + MOE_AUX_COEF * moe_aux
