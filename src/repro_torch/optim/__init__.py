"""Minimal functional optimizers over parameter trees (``repro.optim``).

``make_optimizer(name)`` returns ``(init_fn, update_fn)`` where
``update_fn(grads, opt_state, params, lr, out=None) -> (new_params,
new_opt_state)``.  Updates are out of place, so they compose with
``torch.func.vmap`` over stacked clients; ``out`` (a tree like ``params``,
``params`` itself where the caller owns them) lets an update write new
params into its buffers instead (SGD does, for the leaves it slices), and
the returned tree is the result either way.  The round steps pass ``lr``
as a 0-d fp32 tensor on the params' device, so a captured round reads
each round's lr (a Python float works too: the same fp32 products).
"""
from __future__ import annotations

import torch

from repro_torch.common import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """The fp32 l2 norm over every leaf of ``tree``."""
    return torch.sqrt(sum(t.float().square().sum() for t in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / (norm + 1e-12)), norm)``; the scale is
    fp32, so the clipped grads are too (as in the JAX package)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


# A leaf of at least this many elements (per client under ``vmap``) takes
# its SGD step in slices along dim 0, each of at most half as many, written
# into one output: the step's fp32 temporaries of a whole leaf are three
# times its fp32 size, 24 GiB for falcon-mamba's 8-layer in_proj stack
# over 4 clients.
SLICE_NUMEL = 1 << 26


def sliced(fn, p, *rest, out=None):
    """``fn(p, *rest)``, elementwise, over slices of dim 0 when ``p`` has
    SLICE_NUMEL elements or more: the same bits, smaller temporaries.
    The slices are written into ``out`` where given (``p`` itself, for an
    update in place: each slice after it was computed), else into a new
    tensor; a smaller ``p`` always gives a new tensor."""
    if p.dim() == 0 or p.numel() < SLICE_NUMEL:
        return fn(p, *rest)
    rows = max(1, p.shape[0] * (SLICE_NUMEL // 2) // p.numel())
    first = fn(*(t[:rows] for t in (p, *rest)))
    if out is None:
        # new_empty of the first slice: batched under vmap as the result is
        out = first.new_empty((p.shape[0],) + first.shape[1:])
    out[:rows].copy_(first)
    del first
    for i in range(rows, p.shape[0], rows):
        out[i:i + rows].copy_(fn(*(t[i:i + rows] for t in (p, *rest))))
    return out


def sgd():
    def init(params):
        return ()

    def update(grads, state, params, lr, out=None):
        def step(p, g):
            return (p.float() - lr * g.float()).to(p.dtype)
        if out is None:
            return tree_map(lambda p, g: sliced(step, p, g), params,
                            grads), state
        return tree_map(lambda p, g, o: sliced(step, p, g, out=o), params,
                        grads, out), state
    return init, update


def momentum(beta: float = 0.9):
    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr, out=None):
        m = tree_map(lambda m_, g: beta * m_ + g.to(m_.dtype), state["m"],
                     grads)
        new = tree_map(lambda p, m_: (p.float() - lr * m_).to(p.dtype),
                       params, m)
        return new, {"m": m}
    return init, update


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params):
        def f32(t):
            return tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), t)
        device = tree_leaves(params)[0].device
        return {"m": f32(params), "v": f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params, lr, out=None):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)
        c1 = 1 - torch.pow(b1, t.float())
        c2 = 1 - torch.pow(b2, t.float())
        new = tree_map(
            lambda p, m_, v_: (p.float() - lr * (m_ / c1)
                               / ((v_ / c2).sqrt() + eps)).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}
    return init, update


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam}


def make_optimizer(name: str, **kw):
    return OPTIMIZERS[name](**kw)


def paper_lr_schedule(round_idx: int, lr0: float, decay_every: int = 10,
                      decay: float = 0.99) -> float:
    """Paper §VI-A: initial lr, decayed every `decay_every` rounds by `decay`."""
    return lr0 * decay ** (round_idx // decay_every)
