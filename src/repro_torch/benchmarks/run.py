"""Benchmark driver: one module per paper table/figure, and perf_bench
(``benchmarks/run.py``).

  python -m repro_torch.benchmarks.run [--only NAME] [--smoke] [--device cpu]

The suites are the port's drivers.  ``--smoke`` is forwarded to every
suite whose ``main`` takes it, ``--device`` (default the card) to every
suite whose ``main`` takes a device; a suite that raises is reported and
the driver exits non-zero.  The JAX driver's ``roofline_report`` joins
with the sharded launch and the H100's roofline (ROADMAP Queue 1 item 5);
its ``assert_x64_disabled`` guard has no PyTorch meaning.
"""
from __future__ import annotations

import argparse
import inspect
import sys
import time
import traceback

from repro_torch.benchmarks import fig6_async_order, fig9_codec_tradeoff, \
    fig45_convergence, fig78_aux_arch, fig_faults, fig_population, \
    fig_sched, fig_wallclock, perf_bench, table2_comm_storage, \
    table5_tradeoff, table34_aux_params

SUITES = [
    ("table2_comm_storage", table2_comm_storage.main),
    ("table34_aux_params", table34_aux_params.main),
    ("fig45_convergence", fig45_convergence.main),
    ("fig6_async_order", fig6_async_order.main),
    ("fig78_aux_arch", fig78_aux_arch.main),
    ("fig9_codec_tradeoff", fig9_codec_tradeoff.main),
    ("fig_wallclock", fig_wallclock.main),
    ("fig_sched", fig_sched.main),
    ("fig_faults", fig_faults.main),
    ("table5_tradeoff", table5_tradeoff.main),
    ("perf_bench", perf_bench.main),
    ("fig_population", fig_population.main),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    choices=[name for name, _ in SUITES])
    ap.add_argument("--smoke", action="store_true",
                    help="fast path: forwarded to suites that take it")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card)")
    args = ap.parse_args(argv)

    failures, ran = [], 0
    for name, fn in SUITES:
        if args.only and args.only != name:
            continue
        params = inspect.signature(fn).parameters
        kwargs = {}
        if args.smoke and "smoke" in params:
            kwargs["smoke"] = True
        if "device" in params:
            kwargs["device"] = args.device
        ran += 1
        t0 = time.time()
        try:
            fn(**kwargs)
            print(f"\n[{name}] OK in {time.time() - t0:.1f}s")
        except Exception:
            traceback.print_exc()
            failures.append(name)
            print(f"\n[{name}] FAILED after {time.time() - t0:.1f}s")
    print(f"\n{'=' * 72}\nbenchmarks: {ran - len(failures)}/{ran} OK"
          + (f"; failed: {failures}" if failures else ""))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
