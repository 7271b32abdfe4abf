"""Serving example: batched prefill + greedy decode through the split model.

After CSE-FSL training the deployed network is the merged (client stage +
server stage) model; this example serves it with a KV/SSM cache through
``prefill`` / ``decode_step`` (on the card the decode step replays a CUDA
graph, ``launch.serve.make_serving_fns``), for one dense and one
attention-free (Mamba) architecture, reduced.

  python -m repro_torch.examples.serve_split_model [--arch qwen3-0.6b] \\
      [--batch 4] [--prompt-len 32] [--gen 16] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import draw_params, make_serving_fns


def _wait(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch: int, prompt_len: int, gen: int, device):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens greedily; returns the tokens ``[batch, gen]``."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    params = draw_params(cfg, 0, dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (batch, prompt_len),
                                            dtype=np.int32)).to(dev)
    prefill_fn, decode_fn = make_serving_fns(cfg, device=dev,
                                             cache_len=prompt_len + gen)

    t0 = time.time()
    logits, caches = prefill_fn(params, {"tokens": prompts})
    _wait(dev)
    t_prefill = time.time() - t0

    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    t0 = time.time()
    for step in range(gen - 1):
        logits, caches = decode_fn(params, tok, prompt_len + step, caches)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    _wait(dev)
    t_decode = time.time() - t0

    toks = torch.stack(out, 1)
    print(f"[{arch}] prefill {batch}x{prompt_len} in {t_prefill:.2f}s; "
          f"decoded {gen} tokens in {t_decode:.2f}s "
          f"({batch * gen / max(t_decode, 1e-9):.1f} tok/s)")
    print(f"  first sequence: {toks[0].cpu().numpy()[:12]} ...")
    assert toks.shape == (batch, gen)
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card)")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ["qwen3-0.6b", "falcon-mamba-7b"]
    return {arch: serve(arch, args.batch, args.prompt_len, args.gen,
                        args.device) for arch in archs}


if __name__ == "__main__":
    main()
