"""Split model: client stage | cut | server stage (+ aux head)
(``repro.models.model``), for every family of the reference: dense, MoE,
ssm (Mamba-1), hybrid (Mamba-2 with a shared attention block), the vlm
(M-RoPE, stub patch embeddings) and audio (encoder-only, stub frame
features): training, and serving the merged model (``prefill``,
``decode_step``, ``full_forward``; the encoder-only audio model has no
decode step).

The *client stage* owns the embedding (the audio model's frame frontend
in its place) and the first ``cut`` blocks; the
*server stage* owns the remaining blocks, the final norm and the LM head.
The *auxiliary network* (paper §IV-A) maps the cut-layer output to a task
loss, so the client trains without server gradients.

Params keep the reference's tree and layouts: weights ``[din, dout]``
(``x @ w``) and block params stacked on a leading ``[L, ...]`` axis, which
``stage_apply`` walks with a Python loop.  A hybrid (zamba2) stage also
holds ``shared_attn``, one dense block with no layer axis that runs after
every ``attn_every`` backbone layers: the same weights at every site, a
decode cache per site.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.common import dtype_of, tree_leaves, tree_map, tree_stack
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.blocks import (AUX_KINDS, BLOCKS, Ctx,
                                       attn_cache_spec, block_cache_spec,
                                       block_kind, dense_apply, dense_init)

MOE_AUX_COEF = 0.01


# ---------------------------------------------------------------------------
# Stage plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StagePlan:
    kind: str
    n_layers: int
    groups: int = 0          # hybrid: complete groups of attn_every layers
    tail: int = 0            # hybrid: the backbone layers after the groups

    @property
    def n_shared_sites(self) -> int:
        return self.groups


def stage_plans(cfg: ModelConfig):
    cut = cfg.resolved_cut
    kind = block_kind(cfg)
    if cfg.family == "hybrid":
        e = cfg.attn_every
        if cut % e:
            raise ValueError(f"hybrid cut {cut} must be a multiple of {e}")
        rest = cfg.num_layers - cut
        return (StagePlan(kind, cut, groups=cut // e),
                StagePlan(kind, rest, groups=rest // e, tail=rest % e))
    return StagePlan(kind, cut), StagePlan(kind, cfg.num_layers - cut)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _stage_init(cfg: ModelConfig, plan: StagePlan, gen, dtype):
    init_fn, _ = BLOCKS[plan.kind]
    p = {"blocks": init_fn(cfg, gen, dtype, lead=(plan.n_layers,))}
    if cfg.family == "hybrid":      # each stage its own shared block
        p["shared_attn"] = dense_init(cfg, gen, dtype)
    return p


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
    client = {"blocks_stage": _stage_init(cfg, cplan, gen, dtype)}
    if cfg.family == "audio":       # the frame frontend, no token embedding
        f = cfg.frontend_dim
        client["frontend_w"] = (torch.randn((f, d), generator=gen)
                                * f ** -0.5).to(dtype)
        client["frontend_b"] = torch.zeros((d,), dtype=dtype)
    else:
        client["embed"] = (torch.randn((cfg.vocab_size, d), generator=gen)
                           * d ** -0.5).to(dtype)
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


# the JAX package's name for the params' shapes, nothing allocated
abstract_params = param_specs


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


def _batched(layer, in_dims):
    """``layer`` vmapped over its input and leaves at ``in_dims``."""
    xd, ld = in_dims[0], tuple(in_dims[1:])
    return lambda x, leaves: torch.func.vmap(layer, in_dims=(xd, ld))(
        x, tuple(leaves))


class RematBwd(torch.autograd.Function):
    """``(dx, *dleaves)`` of ``layer`` at ``(x, leaves)`` against its
    outputs' cotangents (``ng`` of them: x's, and the aux loss's where the
    layer returns one): the layer rerun and ``torch.func.vjp`` of it.  A
    Function of its own, as the kernels' backwards in ``kernels/ops.py``
    are, so that its vmap rule runs the vjp on plain tensors (the layer
    vmapped inside it, where the kernel Functions fold the clients), also
    when the backward is reached through a ``vjp``'s pull under ``vmap``
    (the blocking methods' client update), and so that
    ``torch.func.grad``'s ``create_graph=True`` records none of the rerun.
    ``apply(layer, ng, x, *cotangents, *leaves)``."""

    @staticmethod
    def forward(layer, ng, x, *rest):
        gs, leaves = rest[:ng], rest[ng:]
        _, vjp_fn = torch.func.vjp(lambda xx, *ll: layer(xx, ll), x, *leaves)
        return vjp_fn(gs[0] if ng == 1 else tuple(gs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("a recomputed layer has no second derivative")

    @staticmethod
    def vmap(info, in_dims, layer, ng, x, *rest):
        n = info.batch_size

        def lead(t, d):
            # every operand batched on dim 0, so each row gets its own grads
            return t.expand((n,) + tuple(t.shape)) if d is None \
                else t.movedim(d, 0)

        _, _, xd, *rd = in_dims
        out = RematBwd.apply(_batched(layer, (0,) * (1 + len(rest) - ng)),
                             ng, lead(x, xd),
                             *(lead(t, d) for t, d in zip(rest, rd)))
        return out, (0,) * len(out)


class Remat(torch.autograd.Function):
    """One layer recomputed in the backward (``jax.checkpoint`` of the
    reference's scan body): ``Remat.apply(layer, x, *leaves)`` with
    ``layer(x, leaves) -> x'``, or ``-> (x', aux)`` for a block with an
    aux loss (MoE): both outputs carry their gradients.

    The forward runs the layer without recording it, so none of its
    activations stay alive; only its input and parameter leaves are saved.
    The backward (:class:`RematBwd`) reruns the layer and takes
    ``torch.func.vjp`` of it with respect to the input and the leaves.
    Built for ``torch.func`` as the kernel Functions in ``kernels/ops.py``
    are (``setup_context``, no ``ctx`` in ``forward``, a ``vmap``
    staticmethod): under the clients' ``vmap`` the layer runs vmapped
    inside one call, so the kernel Functions in it still fold the clients
    into one launch, in the forward and in its rerun.
    ``torch.utils.checkpoint`` does not compose with ``torch.func.grad``;
    this does."""

    @staticmethod
    def forward(layer, x, *leaves):
        return layer(x, leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        layer, x, *leaves = inputs
        ctx.layer = layer
        ctx.save_for_backward(x, *leaves)

    @staticmethod
    def backward(ctx, *grads):
        x, *leaves = ctx.saved_tensors
        return (None, *RematBwd.apply(ctx.layer, len(grads), x, *grads,
                                      *leaves))

    @staticmethod
    def vmap(info, in_dims, layer, x, *leaves):
        out = Remat.apply(_batched(layer, in_dims[1:]), x, *leaves)
        return out, ((0,) * len(out) if isinstance(out, tuple) else 0)


def _remat_layer(cfg: ModelConfig, apply_fn, p, ctx: Ctx, with_aux: bool):
    """``layer(x, leaves)`` for :class:`Remat`: the block ``apply_fn`` with
    ``p``'s structure refilled from ``leaves``; ``(x, aux)`` with
    ``with_aux``."""
    def layer(x, leaves):
        it = iter(leaves)
        x, _, a = apply_fn(cfg, tree_map(lambda _: next(it), p), x, ctx,
                           None)
        return (x, a) if with_aux else x
    return layer


def stage_apply(cfg: ModelConfig, plan: StagePlan, sp, x, ctx: Ctx,
                caches=None):
    """Run a stage's stacked blocks in order.  Returns ``(x, aux, cache)``:
    in training mode ``cache`` is None; in prefill mode the blocks emit
    their caches, stacked into the stage cache ``{"blocks": [L, B, ...]}``
    (the reference's layout); in decode mode ``caches`` (that layout) is
    updated in place, a layer's view at a time, and returned.

    A hybrid stage runs ``sp["shared_attn"]`` as a dense block after every
    ``attn_every`` backbone layers (``plan.groups`` sites; none after the
    ``plan.tail`` layers that end a stage).  Every site uses the same
    weights, so their gradients add into one leaf; each site has its own
    decode cache, ``"shared": [sites, B, ...]`` in the stage cache.

    The stacked params are split with one ``unbind`` per leaf, whose
    backward stacks the layers' grads once.  Indexing ``a[i]`` per layer
    would make each layer's backward a zero-filled grad of the whole stack,
    summed across layers: a stack's size per layer and leaf (4 GiB for
    falcon-mamba's 4 stacked clients' ``in_proj``).

    With ``cfg.remat`` in train mode each layer runs through
    :class:`Remat`: its activations are recomputed in the backward, the
    numbers are the same bit for bit, and the layer's kernels launch once
    more there (the rerun forward).  A shared site runs through it too
    (the reference checkpoints only the backbone layers: recompute moves
    memory, not numbers).  The stage's aux is the blocks' aux losses
    summed in layer order from 0 (the reference's scan carry); the dense
    and Mamba blocks add none, so theirs stays 0."""
    _, apply_fn = BLOCKS[plan.kind]
    with_aux = plan.kind in AUX_KINDS
    remat = cfg.remat and ctx.mode == "train"
    decode = ctx.mode == "decode"
    aux = 0.0
    layers = _unstack(sp["blocks"])
    given = _unstack(caches["blocks"]) if decode else [None] * len(layers)
    sites = _unstack(caches["shared"]) if decode and plan.groups \
        else [None] * plan.groups
    emitted, emitted_sites = [], []
    for i, (p, c) in enumerate(zip(layers, given)):
        if remat:
            out = Remat.apply(_remat_layer(cfg, apply_fn, p, ctx, with_aux),
                              x, *tree_leaves(p))
            x, a = out if with_aux else (out, 0.0)
            aux = aux + a
        else:
            x, nc, a = apply_fn(cfg, p, x, ctx, c)
            aux = aux + a
            emitted.append(nc)
        if plan.groups and (i + 1) % cfg.attn_every == 0:
            shared = sp["shared_attn"]
            if remat:
                x = Remat.apply(_remat_layer(cfg, dense_apply, shared, ctx,
                                             False), x, *tree_leaves(shared))
                continue
            x, nc, _ = dense_apply(cfg, shared, x, ctx,
                                   sites[(i + 1) // cfg.attn_every - 1])
            emitted_sites.append(nc)
    if ctx.mode == "prefill":
        out = {"blocks": tree_stack(emitted)}
        if plan.groups:
            out["shared"] = tree_stack(emitted_sites)
        elif cfg.family == "hybrid":    # a stage shorter than a group
            s = x.shape[1]
            out["shared"] = tree_map(
                lambda t: torch.empty((0,) + tuple(t.shape), dtype=t.dtype,
                                      device=x.device),
                attn_cache_spec(cfg, x.shape[0],
                                min(ctx.window, s) if ctx.window else s,
                                x.dtype))
        return x, aux, out
    if decode:
        return x, aux, caches
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
    """The inputs -> x [B,S,d].

    ``{"tokens": [B,S]}`` through the embedding; the vlm's also carry
    ``"image_embeds": [B,P,d]``, the stub frontend's patch embeddings,
    which replace the first P positions (cast to the activations' dtype);
    the audio model's ``{"features": [B,S,frontend_dim]}`` go through the
    frame frontend, ``features @ frontend_w + frontend_b``, in the
    parameters' dtype.  (The reference's drawn features are fp32, and
    jnp's type promotion runs a bf16 model's whole stack in fp32 on them;
    its input specs declare them in the model's dtype, as here.)  No
    position ids come out: the M-RoPE streams are rebuilt in each stage
    (``blocks.attn_apply``)."""
    if cfg.family == "audio":
        w = cp["frontend_w"]
        return inputs["features"].to(w.dtype) @ w + cp["frontend_b"]
    x = F.embedding(inputs["tokens"].long(), cp["embed"])
    if cfg.family == "vlm":
        img = inputs["image_embeds"].to(x.dtype)
        x = torch.cat([img, x[:, img.shape[1]:]], dim=1)
    return x


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


def full_forward(cfg: ModelConfig, params, inputs, ctx: Ctx):
    """The merged inference model (the aggregated client stage, then the
    server stage): the final hidden states ``[B, S, d]`` before ``ln_f``."""
    smashed, _, _ = client_forward(cfg, params["client"], inputs, ctx)
    x, _, _ = server_forward(cfg, params["server"], smashed, ctx)
    return x


# ---------------------------------------------------------------------------
# Serving: prefill / decode with split caches
# ---------------------------------------------------------------------------


def _stage_cache_spec(cfg, plan: StagePlan, batch, cache_len, dtype):
    def lead(n):
        return lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                     device="meta")
    spec = {"blocks": tree_map(lead(plan.n_layers), block_cache_spec(
        cfg, plan.kind, batch, cache_len, dtype))}
    if cfg.family == "hybrid":      # one attention cache a shared site
        spec["shared"] = tree_map(lead(plan.n_shared_sites), attn_cache_spec(
            cfg, batch, cache_len, dtype))
    return spec


def decode_cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    """``{"client", "server"}`` stage caches as ``meta`` tensors."""
    dtype = dtype_of(cfg.dtype)
    cplan, splan = stage_plans(cfg)
    return {"client": _stage_cache_spec(cfg, cplan, batch, cache_len, dtype),
            "server": _stage_cache_spec(cfg, splan, batch, cache_len, dtype)}


def init_decode_caches(cfg: ModelConfig, batch: int, cache_len: int,
                       device="cuda"):
    """Zero caches of :func:`decode_cache_specs`' shapes on ``device``."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device),
                    decode_cache_specs(cfg, batch, cache_len))


def _pad_attn_caches(caches, cache_len: int):
    """Grow the k/v caches' sequence dim (stacked layout [L,B,S,KH,hd], a
    hybrid's shared sites' [sites,B,S,KH,hd] too) to
    ``cache_len``, zeros after the prompt, so decode appends up to
    ``cache_len - S`` tokens before the ring buffer wraps."""
    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif name in ("k", "v") and leaf.dim() >= 4 \
                    and leaf.shape[2] < cache_len:
                out[name] = F.pad(leaf, (0, 0) * (leaf.dim() - 3)
                                  + (0, cache_len - leaf.shape[2]))
            else:
                out[name] = leaf
        return out
    return walk(caches)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, inputs, *, window: int = 0,
            cache_len: int = 0):
    """Full-sequence forward producing the caches and the last token's
    logits ``[B, V]``.  ``inputs`` as :func:`embed_inputs` takes them (the
    vlm's with its ``image_embeds``).

    ``cache_len``: if longer than the prompt (and no window), the
    attention caches are padded so decode can append ``cache_len - S``
    tokens before the ring buffer wraps."""
    ctx = Ctx(cfg, "prefill", pos=0, window=window)
    cplan, splan = stage_plans(cfg)
    x = embed_inputs(cfg, params["client"], inputs)
    x, _, ccache = stage_apply(cfg, cplan, params["client"]["blocks_stage"],
                               x, ctx)
    y, _, scache = stage_apply(cfg, splan, params["server"]["blocks_stage"],
                               x, ctx)
    logits = server_logits_fn(cfg, params["server"])(y[:, -1:, :])
    caches = {"client": ccache, "server": scache}
    if cache_len and not window:
        caches = _pad_attn_caches(caches, cache_len)
    return logits[:, 0], caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token, pos, caches, *,
                window: int = 0):
    """One-token decode through the split model -> ``(logits [B, V],
    caches)``.

    token: [B] int; pos: the current absolute position (an int or a 0-d
    integer tensor; a device tensor keeps the step free of host values, as
    a captured step needs); caches: as from :func:`init_decode_caches` or
    :func:`prefill`, updated in place and returned (the reference's
    ``jax.jit`` donates them)."""
    dev = token.device
    ctx = Ctx(cfg, "decode", pos=torch.as_tensor(pos, device=dev),
              window=window)
    cplan, splan = stage_plans(cfg)
    inputs = {"tokens": token[:, None]}
    if cfg.family == "vlm":         # no image position in a decoded token
        inputs["image_embeds"] = torch.zeros(
            (token.shape[0], 0, cfg.d_model), dtype=dtype_of(cfg.dtype),
            device=dev)
    x = embed_inputs(cfg, params["client"], inputs)
    x, _, ncc = stage_apply(cfg, cplan, params["client"]["blocks_stage"], x,
                            ctx, caches["client"])
    x, _, nsc = stage_apply(cfg, splan, params["server"]["blocks_stage"], x,
                            ctx, caches["server"])
    logits = server_logits_fn(cfg, params["server"])(x)[:, 0]
    return logits, {"client": ncc, "server": nsc}
