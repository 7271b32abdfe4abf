"""Shared helpers of the table scripts (``benchmarks/common.py``): the
output folder, a banner and a plain-text table."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

OUT_DIR = os.environ.get("REPRO_BENCH_OUT", "experiments/bench")


def save(name: str, payload: Dict[str, Any]) -> str:
    """``payload`` as JSON at ``OUT_DIR/<name>.json``; returns the path."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    return path


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
