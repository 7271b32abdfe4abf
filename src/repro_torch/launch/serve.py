"""Batched serving driver for the final CSE-FSL model
(``repro.launch.serve``).

After training, the deployed model is the *merged* network (the
aggregated client stage and the single server stage, paper Step 4).  This
driver serves it at a fixed batch size: prefill each request batch, then
decode greedily, reporting tokens/s.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 64 --gen 32 [--size {reduced,full}] \\
      [--device cpu]

It runs on the card (``--device cuda``, the default); ``--device cpu``
asks for the CPU, and without a card the default exits with an error.

The port's counterpart of the reference's ``jax.jit(decode,
donate_argnums=(3,))``: decode updates its caches in place, and on the
card :func:`make_serving_fns`' decode replays a CUDA graph of
``decode_step`` (:class:`CapturedDecode`), bitwise the eager step.
Prefill runs eagerly, as the reference retraces it per shape.

``main`` pads the attention caches to the prompt plus the generated
tokens, as ``examples/serve_split_model.py`` does, so decode attends to
the whole context; the reference's ``main`` does not, and its ring buffer
(the prompt's length) drops the prompt's first tokens from the first
decode step on.
"""
from __future__ import annotations

import argparse
import gc
import time

import numpy as np
import torch

from repro_torch.common import resolve_device, tree_leaves, tree_map
from repro_torch.configs.registry import get_config
from repro_torch.models import model as tf_mod


class CapturedDecode:
    """``decode_step`` captured once on the card for one batch size, one
    cache layout and one set of parameters, replayed per token.

    Token and position lie in static device buffers that each call
    updates before the replay; the caches passed at the capture are
    adopted as the static caches (donated: the replays update them in
    place, as the eager step does).  Caches of another request batch are
    copied into them once, at that batch's first step.  The warm-up that
    PyTorch's graph rules ask for runs on zero caches of the same shapes,
    so the caller's caches stay as they are.  A failed capture raises."""

    def __init__(self, cfg, params, token, pos, caches, window: int,
                 stream):
        dev = token.device
        self.params = tree_leaves(params)
        self.token = token.clone()
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self._set_pos(pos)
        self.caches = caches
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            tf_mod.decode_step(cfg, params, self.token, self.pos,
                               tree_map(torch.zeros_like, caches),
                               window=window)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.logits, _ = tf_mod.decode_step(cfg, params, self.token,
                                                self.pos, self.caches,
                                                window=window)

    def _set_pos(self, pos):
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(int(pos))

    def takes(self, params, token, caches) -> bool:
        """This graph runs ``params`` at ``token``'s batch and ``caches``'
        layout."""
        mine = tree_leaves(self.caches)
        theirs = tree_leaves(caches)
        return (token.shape == self.token.shape
                and token.dtype == self.token.dtype
                and len(mine) == len(theirs)
                and all(a.shape == b.shape and a.dtype == b.dtype
                        for a, b in zip(mine, theirs))
                and all(a is b for a, b in zip(self.params,
                                               tree_leaves(params))))

    def __call__(self, token, pos, caches):
        for s, x in zip(tree_leaves(self.caches), tree_leaves(caches)):
            if x is not s:          # another request batch's caches
                s.copy_(x)
        self.token.copy_(token)
        self._set_pos(pos)
        self.graph.replay()
        return self.logits.clone(), self.caches


def make_serving_fns(cfg, window: int = 0, device="cuda", cache_len: int = 0):
    """``(prefill(params, inputs), decode(params, token, pos, caches))``.

    Prefill runs eagerly (``cache_len``: pad the attention caches, see
    :func:`repro_torch.models.model.prefill`).  On the card, decode
    replays a :class:`CapturedDecode`, captured at its first call for
    each batch size, cache layout and parameter set; on the CPU it is the
    eager ``decode_step``."""
    dev = resolve_device(device)

    def prefill(params, inputs):
        return tf_mod.prefill(cfg, params, inputs, window=window,
                              cache_len=cache_len)

    if dev.type != "cuda":
        def decode(params, token, pos, caches):
            return tf_mod.decode_step(cfg, params, token, pos, caches,
                                      window=window)
        return prefill, decode

    graphs: list = []
    side: list = []             # one side stream for every capture

    def decode(params, token, pos, caches):
        for g in graphs:
            if g.takes(params, token, caches):
                return g(token, pos, caches)
        if not side:
            side.append(torch.cuda.Stream(token.device))
        g = CapturedDecode(cfg, params, token, pos, caches, window, side[0])
        graphs.append(g)
        return g(token, pos, caches)

    decode.graphs = graphs
    return prefill, decode


def draw_params(cfg, seed: int, device):
    """``init_params`` from a generator seeded ``seed`` on ``device`` (on
    the card, drawn there: a full-width host draw takes longer than the
    serving run)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        return tf_mod.init_params(cfg, gen, device=dev)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--num-batches", type=int, default=3)
    add_size_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' asks for "
                         "the CPU)")
    return ap


def add_size_args(ap: argparse.ArgumentParser):
    """--size {reduced,full} (default reduced) + --reduced/--full aliases."""
    ap.add_argument("--size", choices=("reduced", "full"), default="reduced")
    ap.add_argument("--reduced", dest="size", action="store_const",
                    const="reduced", help="alias for --size reduced")
    ap.add_argument("--full", dest="size", action="store_const",
                    const="full", help="alias for --size full")
    return ap


def main(argv=None):
    """Serve ``--num-batches`` batches; returns the last batch's generated
    tokens ``[B, gen]`` (on the device)."""
    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    cfg = get_config(args.arch)
    if args.size == "reduced":
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step "
                         "(DESIGN §Skips)")
    params = draw_params(cfg, 0, device)
    prefill, decode = make_serving_fns(
        cfg, device=device, cache_len=args.prompt_len + args.gen)

    rng = np.random.default_rng(0)
    total_tokens, t_total, out = 0, 0.0, None
    for bi in range(args.num_batches):
        inputs = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         dtype=np.int32)).to(device)}
        if cfg.family == "vlm":     # the stub frontend's patch embeddings
            inputs["image_embeds"] = torch.from_numpy(rng.normal(
                size=(args.batch, cfg.num_image_tokens, cfg.d_model)).astype(
                    np.float32)).to(device)
        t0 = time.time()
        logits, caches = prefill(params, inputs)
        tok = logits.argmax(-1).to(torch.int32)
        out = [tok]
        for step in range(args.gen - 1):
            logits, caches = decode(params, tok, args.prompt_len + step,
                                    caches)
            tok = logits.argmax(-1).to(torch.int32)
            out.append(tok)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        toks = args.batch * args.gen
        total_tokens += toks
        t_total += dt
        print(f"batch {bi}: {toks} tokens in {dt:.2f}s "
              f"({toks/dt:.1f} tok/s)")
    print(f"\ntotal: {total_tokens} tokens, {total_tokens/t_total:.1f} tok/s")
    return torch.stack(out, 1)


if __name__ == "__main__":
    main()
