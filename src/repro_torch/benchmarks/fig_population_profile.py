"""Where ``fig_population``'s throughput claim (a) spends its host time,
and how far the claim's speed-up moves from run to run.

- ``--repeats K`` runs of ``fig_population.bench_throughput`` at the
  driver's own settings (the smoke CNN, a fleet of 8, h = 1, 160 rounds
  at chunk 40): the speed-up of each, with its min, median and max;
- one run of each side, the cohort engine (``Population.run`` over a
  ``FederatedPool``, the device pool) and the dense trainer's staged
  ``run_compiled(device_data=False)``, with a telemetry recorder: the
  host seconds a round of their ``chunk/build`` spans (the host staging:
  the index plans, or the stacked batches) and ``chunk/execute`` spans
  (the replays and the one fetch of their metrics; the cohort engine's
  run from a segment's launch to its landing, around the next segment's
  build), then each side again under ``cProfile``: the host functions
  with the most own time;
- with ``--turns T``, T runs of each side taking turns in one process,
  then one replayed round of each side's graph alone (device and host
  ms).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_population_profile \\
        [--device cpu] [--repeats 7] [--top 12] [--turns 0]

The last line of the output is the JSON of the numbers.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import time

import torch

from repro_torch.benchmarks import fig_population as fp
from repro_torch.configs.base import FSLConfig
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.population import FederatedPool, Population
from repro_torch.telemetry import Telemetry

N, H, ROUNDS, CHUNK, BATCH = 8, 1, 160, 40, 2     # fig_population's main


def _sides(device, tele=None, trainers=None):
    """The two sides of claim (a), built as ``bench_throughput`` builds
    them: ``{name: run(rounds)}``; ``trainers`` (a dict), if given, gets
    each side's Trainer."""
    bundle = cnn_bundle(fp.SMOKE, device=device)
    x, y = synthetic_classification(24 * N, fp.SMOKE.in_shape,
                                    fp.SMOKE.num_classes, seed=0,
                                    signal=12.0)
    fed = partition_iid(x, y, N, seed=0)
    fsl = FSLConfig(num_clients=N, h=H, lr=0.05, method="cse_fsl")
    tr = Trainer(bundle, fsl, telemetry=tele)
    box = {"state": tr.init(0)}
    batcher = FederatedBatcher(fed, BATCH, H, seed=0)
    pop = Population(bundle, fsl, population=N, telemetry=tele,
                     data=FederatedPool(fed, BATCH, H, seed=0)).init(0)

    def staged(rounds):
        box["state"], _ = tr.run_compiled(box["state"], batcher, rounds,
                                          chunk=CHUNK, device_data=False)

    if trainers is not None:
        trainers.update(staged=tr, pooled=pop.trainer)

    return {"staged": staged, "pooled": lambda r: pop.run(r, chunk=CHUNK)}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def spans(device) -> dict:
    """Host seconds a round of each side's build and execute spans (after
    one chunk that captures)."""
    out = {}
    for name in ("staged", "pooled"):
        tele = Telemetry()
        run = _sides(device, tele)[name]
        run(CHUNK)
        _sync(device)
        tele.spans.clear()
        run(ROUNDS)
        _sync(device)
        out[name] = {kind: sum(s.dur for s in tele.spans
                               if s.name == f"chunk/{kind}") / ROUNDS
                     for kind in ("build", "execute")}
        out[name]["captures"] = sum(bool(s.labels.get("capture"))
                                    for s in tele.spans)
    return out


def host_profile(device, top: int) -> dict:
    """Each side's ``ROUNDS`` rounds under cProfile (after one chunk that
    captures): the functions with the most own seconds, a round."""
    out = {}
    for name in ("staged", "pooled"):
        run = _sides(device)[name]
        run(CHUNK)
        _sync(device)
        prof = cProfile.Profile()
        prof.enable()
        run(ROUNDS)
        _sync(device)
        prof.disable()
        st = pstats.Stats(prof, stream=io.StringIO())
        rows = sorted(((v[2], f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})")
                       for k, v in st.stats.items()), reverse=True)[:top]
        out[name] = {"total_ms_per_round": st.total_tt / ROUNDS * 1e3,
                     "top_own_ms_per_round": [
                         [fn, t / ROUNDS * 1e3] for t, fn in rows]}
    return out


def alternating(device, runs: int) -> dict:
    """Steps a second of each side's ``ROUNDS`` rounds, the two sides
    taking turns ``runs`` times in one process (after one chunk each that
    captures); on the card also one replayed round of each side's
    aggregating graph alone: its device ms (CUDA events around ``CHUNK``
    replays back to back) and the host ms of the replay calls."""
    trainers = {}
    sides = _sides(device, trainers=trainers)
    for run in sides.values():
        run(CHUNK)
    _sync(device)
    out = {name: [] for name in sides}
    for _ in range(runs):
        for name, run in sides.items():
            t0 = time.perf_counter()
            run(ROUNDS)
            _sync(device)
            out[name].append(ROUNDS / (time.perf_counter() - t0))
    if torch.device(device).type == "cuda":
        for name, tr in trainers.items():
            cap = tr._captured
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            cap.step.zero_()
            a.record()
            t0 = time.perf_counter()
            for _ in range(CHUNK):
                cap.graphs[True].replay()
            host = time.perf_counter() - t0
            b.record()
            b.synchronize()
            out[f"{name}_replay_device_ms"] = a.elapsed_time(b) / CHUNK
            out[f"{name}_replay_host_ms"] = host * 1e3 / CHUNK
    return out


def main(device="cuda", repeats: int = 7, top: int = 12, turns: int = 0):
    speedups = []
    for _ in range(repeats):
        row = fp.bench_throughput(n=N, h=H, rounds=ROUNDS, chunk=CHUNK,
                                  batch_size=BATCH, device=device)
        speedups.append(row["population_steps_per_s"]
                        / row["dense_steps_per_s"])
        print(f"  speed-up {speedups[-1]:.4f} ({row})", flush=True)
    res = {"speedups": speedups, "min": min(speedups),
           "median": statistics.median(speedups), "max": max(speedups),
           "spans_s_per_round": spans(device),
           "host_profile": host_profile(device, top)}
    if turns:
        res["alternating"] = alt = alternating(device, turns)
        print(f"  taking turns: staged {[round(x, 2) for x in alt['staged']]}"
              f" steps/s; pooled {[round(x, 2) for x in alt['pooled']]}")
        for k in sorted(k for k in alt if k.endswith("_ms")):
            print(f"  {k} {alt[k]:.4f}")
    for name, sp in res["spans_s_per_round"].items():
        print(f"  {name}: build {sp['build'] * 1e3:.4f} ms a round, "
              f"execute {sp['execute'] * 1e3:.4f} ms a round, "
              f"{sp['captures']} capture(s)")
    for name, hp in res["host_profile"].items():
        print(f"  {name} under cProfile: {hp['total_ms_per_round']:.4f} ms "
              "a round; own ms a round:")
        for fn, ms in hp["top_own_ms_per_round"]:
            print(f"    {ms:9.4f}  {fn}")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--repeats", type=int, default=7,
                    help="runs of the claim's benchmark")
    ap.add_argument("--top", type=int, default=12,
                    help="host functions listed a side")
    ap.add_argument("--turns", type=int, default=0,
                    help="runs of each side taking turns in one process, "
                         "then one replayed round of each alone (0: none)")
    main(**vars(ap.parse_args()))
