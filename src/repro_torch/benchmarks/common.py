"""Shared helpers of the table and figure scripts (``benchmarks/common.py``):
the output folder, a banner, a plain-text table, the split CNN's test
accuracy and the deterministic setting the accuracy claims are read under."""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, List

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.models.cnn import stages

OUT_DIR = os.environ.get("REPRO_BENCH_OUT", "experiments/bench")


def save(name: str, payload: Dict[str, Any]) -> str:
    """``payload`` as JSON at ``OUT_DIR/<name>.json``; returns the path."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    return path


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms, cuDNN's too, for the block (or the function
    it decorates), the previous setting restored after.  The figures' claims
    compare accuracies near chance, where the card's nondeterministic
    library kernels move a method's final accuracy by several points from
    one run to the next; under this setting repeated runs are bitwise
    equal, so a claim holds or fails on every run."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic = was[2]


def banner(title: str):
    print(f"\n{'=' * 72}\n{title}\n{'=' * 72}")


def table(rows: List[Dict[str, Any]], cols: List[str]):
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    line = "  ".join(c.ljust(widths[c]) for c in cols)
    print(line)
    print("-" * len(line))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))


def accuracy(bundle, cfg, params, x: np.ndarray, y: np.ndarray) -> float:
    """Top-1 accuracy of the merged split CNN ``params`` (client stage, then
    server stage) on ``(x, y)``, computed on the bundle's device."""
    dev = bundle.device
    with torch.no_grad():
        sm = bundle.client_smashed(params["client"],
                                   torch.from_numpy(x).to(dev))
        logits = functional_call(stages(cfg)["server"], params["server"],
                                 (sm,))
        hits = logits.argmax(-1) == torch.from_numpy(y).to(dev)
    return float(hits.float().mean())
