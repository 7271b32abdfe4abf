"""Serving-launch helpers (``repro.launch.serve``).

For now the size flags the training CLI shares; the serving driver
(``main``: prefill, then greedy decode at a fixed batch) comes with the
port's prefill and decode branches (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import argparse


def add_size_args(ap: argparse.ArgumentParser):
    """--size {reduced,full} (default reduced) + --reduced/--full aliases."""
    ap.add_argument("--size", choices=("reduced", "full"), default="reduced")
    ap.add_argument("--reduced", dest="size", action="store_const",
                    const="reduced", help="alias for --size reduced")
    ap.add_argument("--full", dest="size", action="store_const",
                    const="full", help="alias for --size full")
    return ap
