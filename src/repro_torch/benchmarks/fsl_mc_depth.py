"""How deep FSL_MC fits on one card: full-width Qwen3-0.6B (bf16, the
kernels on) with FSL_MC's four server replicas, int8 up and down, n = 4
clients, h = 2, B = 1, S = 4096 (``chip_smoke.py``'s Qwen3 setup), two
rounds through ``Trainer.run`` at each depth asked for, deepest first.
Prints each depth's peak device memory (``torch.cuda.max_memory_allocated``)
or, where an allocation ran out, the memory held when it did.  The config
recomputes each layer in its backward (``remat=True``), so only the
layers' inputs stay saved; with ``remat=False`` the replicas' saved
activations decide the depth (20 of 28 layers fit).  Run from the repo root on
a machine with a GPU:

    PYTHONPATH=src python -m repro_torch.benchmarks.fsl_mc_depth \\
        --layers 28 24 20
"""
from __future__ import annotations

import argparse
import gc
import json

import torch

from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.launch.train import LMBatcher, build_data
from repro_torch.transport import make_transport

N, H, B, S, LR, SAMPLES, ROUNDS = 4, 2, 1, 4096, 0.1, 8, 2


def peak_at(layers: int, dev: torch.device) -> dict:
    """Two FSL_MC rounds at ``layers`` layers (cut 4); the peak memory and
    whether the run fitted."""
    cfg = get_config("qwen3-0.6b").with_(use_pallas=True, num_layers=layers)
    fsl = FSLConfig(num_clients=N, h=H, lr=LR, method="fsl_mc")
    fed = build_data(cfg, fsl, S, SAMPLES, non_iid=False, seed=0)
    tr = Trainer(transformer_bundle(cfg, device=dev), fsl,
                 transport=make_transport("int8", "int8"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        _, hist = tr.run(tr.init(0), LMBatcher(cfg, fed, B, H, seed=0),
                         ROUNDS, log_every=1)
        fits = all(torch.isfinite(torch.tensor(r["loss"])) for r in hist)
    except torch.OutOfMemoryError:
        fits = False
    return {"layers": layers, "fits": fits,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[28, 24, 20])
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(dev), flush=True)
    rows = []
    for layers in sorted(args.layers, reverse=True):
        rows.append(peak_at(layers, dev))
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
