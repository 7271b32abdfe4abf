"""Population scale on the port: the cohort engine against the dense fleet
(``benchmarks/fig_population.py``).

Three asserted demonstrations (the population engine's acceptance bars):

  a. THROUGHPUT: at equal fleet size (cohort C == population N) the
     cohort engine's device-resident pool path reaches at least the dense
     trainer's host-staged ``run_compiled(device_data=False)`` rounds a
     second: only int64 index plans cross to the device a segment, not
     stacked batch arrays, and the engine builds them while the card
     replays the segment before.  Best of 3 runs a side, the two sides
     taking turns.  ``REPRO_POP_MIN_SPEEDUP`` overrides the bar.
  b. MEMORY: the same cohort config run over N = 10^4 and N = 10^6
     ``VirtualPool`` fleets reports equal ``memory_report()["engine_total"]``,
     and that total sits far below the dense per-client extrapolation
     ``N * row_bytes``.
  c. NO HOST STAGING: a counter wrapped around the trainer's
     ``_stack_rounds`` reads zero across every pooled run (and nonzero on
     the staged dense path, which proves the counter works).

The model is the JAX script's smoke CNN (8x8x1 inputs, two 2-channel
convs), so the rounds' device work is small and the host side of the
loop (what the pool path removes) is what is measured.  Results land in
``torch_fig_population.json`` under ``REPRO_BENCH_OUT`` (default
``experiments/bench``).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_population \\
        [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import os
import time

import torch

import repro_torch.core.trainer as trainer_mod
from repro_torch.benchmarks.common import banner, save, table
from repro_torch.configs.base import FSLConfig
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.models.cnn import CNNConfig
from repro_torch.network import TieredNetwork
from repro_torch.population import FederatedPool, Population, VirtualPool

SMOKE = CNNConfig("smoke_cnn", (8, 8, 1), 10, conv_channels=(2, 2),
                  kernel=3, server_widths=(8,), aux_channels=2, lrn=False)


def _timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


class _staging_counter:
    """Counts ``_stack_rounds`` calls (acceptance c), over every ``with``
    block it is entered in."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        self._orig = trainer_mod._stack_rounds

        def counting(*xs):
            self.calls += 1
            return self._orig(*xs)

        trainer_mod._stack_rounds = counting
        return self

    def __exit__(self, *a):
        trainer_mod._stack_rounds = self._orig


def bench_throughput(n: int, h: int, rounds: int, chunk: int,
                     batch_size: int, seed: int = 0, device="cuda"):
    """Cohort engine (C == N, FederatedPool) against the dense host-staged
    run_compiled on the same data stream: acceptance (a) and (c)."""
    bundle = cnn_bundle(SMOKE, device=device)
    x, y = synthetic_classification(24 * n, SMOKE.in_shape,
                                    SMOKE.num_classes, seed=seed,
                                    signal=12.0)
    fed = partition_iid(x, y, n, seed=seed)
    fsl = FSLConfig(num_clients=n, h=h, lr=0.05, method="cse_fsl")
    repeats = 3                 # best of N against scheduler noise

    # -- dense fleet, host-staged batches ----------------------------------
    tr = Trainer(bundle, fsl)
    box = {"state": tr.init(seed)}
    batcher = FederatedBatcher(fed, batch_size, h, seed=seed)

    def dense(r):
        box["state"], _ = tr.run_compiled(box["state"], batcher, r,
                                          chunk=chunk, device_data=False)

    # -- population cohort engine, device-resident pool --------------------
    pop = Population(bundle, fsl, population=n,
                     data=FederatedPool(fed, batch_size, h, seed=seed))
    pop.init(seed)
    staged, pooled = _staging_counter(), _staging_counter()
    with staged:
        _, compile_dense = _timed(lambda: dense(chunk), device)
    with pooled:
        _, compile_pop = _timed(lambda: pop.run(chunk, chunk=chunk), device)
    # the two sides take turns, so each meets the card (its clocks) and
    # the host in the states the other does
    t_dense = t_pop = float("inf")
    for _ in range(repeats):
        with staged:
            _, t = _timed(lambda: dense(rounds), device)
        t_dense = min(t_dense, t)
        with pooled:
            _, t = _timed(lambda: pop.run(rounds, chunk=chunk), device)
        t_pop = min(t_pop, t)
    assert staged.calls > 0, "counter broken: the staged path never staged"
    assert pooled.calls == 0, \
        "_stack_rounds ran inside the cohort engine's hot loop"
    dense_sps, pop_sps = rounds / t_dense, rounds / t_pop

    return {
        "fleet": n, "h": h, "rounds": rounds, "chunk": chunk,
        "batch": batch_size,
        "dense_steps_per_s": round(dense_sps, 2),
        "population_steps_per_s": round(pop_sps, 2),
        "speedup": round(pop_sps / dense_sps, 2),
        "compile_dense_s": round(compile_dense, 2),
        "compile_population_s": round(compile_pop, 2),
        "stack_rounds_calls_pooled": pooled.calls,
    }


def bench_memory(rounds: int, chunk: int,
                 populations=(10_000, 1_000_000), cohort: int = 8,
                 device="cuda"):
    """The same cohort config over N = 10^4 and N = 10^6 fleets:
    acceptance (b), engine bytes do not move with N and sit far below the
    dense ``N * row_bytes`` extrapolation."""
    fsl = FSLConfig(num_clients=cohort, h=2, method="cse_fsl", agg_every=4)
    bundle = cnn_bundle(SMOKE, device=device)
    reports, summary = [], None
    for population in populations:
        vp = VirtualPool.synthetic((8, 8, 1), 10, pool_size=128, d_local=24,
                                   batch_size=4, h=2, seed=0)
        pop = Population(bundle, fsl, population=population, data=vp,
                         sampler="stratified", network=TieredNetwork())
        pop.init(seed=0)
        with _staging_counter() as cnt:
            (_, hist), seconds = _timed(lambda: pop.run(rounds, chunk=chunk),
                                        device)
        assert cnt.calls == 0, \
            "_stack_rounds ran inside the cohort engine's hot loop"
        rep = pop.memory_report()
        rep["run_seconds"] = round(seconds, 2)
        reports.append(rep)
        summary = pop.population_summary(hist)    # keep the largest N's
    small, big = reports[0], reports[-1]
    assert small["engine_total"] == big["engine_total"], \
        (small, big)                # engine memory independent of N
    assert big["engine_total"] * 1000 < big["dense_extrapolated"], big
    return reports, summary


def main(device="cuda", smoke: bool = False):
    n = 4 if smoke else 8
    rounds, chunk = (48, 16) if smoke else (160, 40)
    row = bench_throughput(n=n, h=1, rounds=rounds, chunk=chunk,
                           batch_size=2, device=device)
    mem_rounds, mem_chunk = (12, 4) if smoke else (24, 8)
    mem_reports, summary = bench_memory(mem_rounds, mem_chunk, device=device)

    banner("fig_population — cohort engine vs dense fleet "
           f"({'smoke' if smoke else 'full'}, {device})")
    table([row], ["fleet", "h", "dense_steps_per_s",
                  "population_steps_per_s", "speedup", "compile_dense_s",
                  "compile_population_s"])
    print("\nmemory (same cohort config, fleet size varies):")
    table([{"population": r["population"], "cohort": r["cohort"],
            "engine_total": r["engine_total"],
            "dense_extrapolated": r["dense_extrapolated"],
            "ratio": f'{r["dense_extrapolated"] / r["engine_total"]:.0f}x',
            "run_seconds": r["run_seconds"]} for r in mem_reports],
          ["population", "cohort", "engine_total", "dense_extrapolated",
           "ratio", "run_seconds"])
    if "straggler_seconds" in summary:
        s = summary["straggler_seconds"]
        print(f'\nN=10^6 cohort stragglers: p50={s["p50"]:.1f}s '
              f'p90={s["p90"]:.1f}s p99={s["p99"]:.1f}s; '
              f'tiers {summary["per_tier"]}')

    # Acceptance (a): the device-resident pool path at least matches host
    # staging at equal fleet size (the bar is 1.0: the win is removing
    # host-to-device batch traffic, not a kernel speed-up).
    min_speedup = float(os.environ.get("REPRO_POP_MIN_SPEEDUP", "1.0"))
    assert row["speedup"] >= min_speedup, row

    dev = torch.device(device)
    payload = {"throughput": [row], "memory": mem_reports,
               "population_summary": summary, "device": str(dev),
               "device_count": torch.cuda.device_count()
               if dev.type == "cuda" else 1}
    path = save("torch_fig_population", payload)
    print(f"\nwrote {path}")
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="smaller fleet, fewer rounds")
    main(**vars(ap.parse_args()))
