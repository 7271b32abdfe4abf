"""Throughput benchmark: per-round loop vs compiled chunk runner
(``benchmarks/perf_bench.py``).

For each method this measures, on the same data stream and seeds:

  - ``compile_loop_s`` / ``compile_chunk_s``  the first call of each path
                        (on the card the chunk runner's first call warms up
                        and captures its CUDA graphs);
  - ``steps_per_s``     steady-state global rounds per second after that,
                        host loop included (the best of 3 calls, the card
                        synchronized around each whole call);
  - ``dispatch_ms``     the per-round host overhead the chunk runner
                        removes: ``1/loop_sps - 1/compiled_sps`` (both paths
                        run the same math, bitwise: tests/test_torch_compiled.py).

The smoke CNN at h=1 is the regime the chunk runner targets (per-round
compute is tiny, so host dispatch dominates); the bar asserted below is
compiled >= 2x loop steps/s there (``REPRO_PERF_MIN_SPEEDUP``), and a live
telemetry recorder must keep the compiled runner's steps/s within 5 % of
the no-op one (``REPRO_TELEMETRY_MIN_RATIO``).  Both bars are claims about
the card.  Results land in ``torch_perf_bench.json`` under
``REPRO_BENCH_OUT`` (default ``experiments/bench``).

  python -m repro_torch.benchmarks.perf_bench [--smoke] [--device cpu]

The JAX driver also asserts that two Trainer builds lower to the same
chunk program (rule R001, ``Trainer.chunk_fingerprint``); the port has no
fingerprint yet (ROADMAP Queue 1 item 6), so its rows have no
``chunk_fingerprint``.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.benchmarks.common import banner, save, table
from repro_torch.common import resolve_device
from repro_torch.configs.base import FSLConfig
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.models.cnn import CIFAR10, CNNConfig

METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")

# Deliberately tiny: per-round device compute in the sub-ms band, so the
# per-round dispatch/sync overhead of the Python loop is the bottleneck.
# A mid-size CNN rides along in the full sweep to show the gap narrowing
# as compute grows.
SMOKE = CNNConfig("smoke_cnn", (8, 8, 1), 10, conv_channels=(2, 2),
                  kernel=3, server_widths=(8,), aux_channels=2, lrn=False)
MID = CNNConfig("mid_cnn", (12, 12, 3), 10, conv_channels=(8, 8),
                kernel=3, server_widths=(32,), aux_channels=8, lrn=False)


def _timed(fn, device):
    """``fn()`` and its wall seconds, the card synchronized before and
    after the whole call."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def bench_one(cfg, method: str, h: int, rounds: int, chunk: int,
              batch_size: int, n: int = 2, samples: int = 240, seed: int = 0,
              device="cuda"):
    device = resolve_device(device)
    bundle = cnn_bundle(cfg, device=device)
    x, y = synthetic_classification(samples, cfg.in_shape, cfg.num_classes,
                                    seed=seed, signal=12.0)
    fed = partition_iid(x, y, n, seed=seed)
    fsl = FSLConfig(num_clients=n, h=h, lr=0.05, method=method,
                    grad_clip=1.0 if method == "fsl_oc" else 0.0)

    def fresh():
        tr = Trainer(bundle, fsl)
        return tr, tr.init(seed), FederatedBatcher(fed, batch_size, h,
                                                   seed=seed)

    repeats = 3                 # best-of-N: shields steady-state numbers
                                # from scheduler noise on shared hosts

    # -- per-round Python loop (the reference) ------------------------------
    tr, state, batcher = fresh()
    (state, _), compile_loop = _timed(lambda: tr.run(state, batcher, 1),
                                      device)
    t_loop = float("inf")
    for _ in range(repeats):
        (state, _), t = _timed(lambda: tr.run(state, batcher, rounds), device)
        t_loop = min(t_loop, t)
    loop_sps = rounds / t_loop

    # -- compiled chunk runner ---------------------------------------------
    tr, state, batcher = fresh()
    (state, _), compile_chunk = _timed(
        lambda: tr.run_compiled(state, batcher, chunk, chunk=chunk), device)
    t_chunk = float("inf")
    for _ in range(repeats):
        (state, _), t = _timed(
            lambda: tr.run_compiled(state, batcher, rounds, chunk=chunk),
            device)
        t_chunk = min(t_chunk, t)
    compiled_sps = rounds / t_chunk

    return {
        "arch": cfg.name, "method": method, "h": h, "rounds": rounds,
        "chunk": chunk, "batch": batch_size,
        "loop_steps_per_s": round(loop_sps, 2),
        "compiled_steps_per_s": round(compiled_sps, 2),
        "speedup": round(compiled_sps / loop_sps, 2),
        "dispatch_ms_per_round": round(
            (1.0 / loop_sps - 1.0 / compiled_sps) * 1e3, 3),
        "compile_loop_s": round(compile_loop, 2),
        "compile_chunk_s": round(compile_chunk, 2),
    }


def bench_telemetry_overhead(rounds: int, chunk: int,
                             method: str = "cse_fsl", n: int = 2,
                             batch_size: int = 2, seed: int = 0,
                             device="cuda", repeats: int = 3,
                             turns: bool = False):
    """The compiled runner's steady-state steps/s with a live recorder
    divided by the no-op baseline's, best of ``repeats`` calls each.  The
    recorder only appends to host lists after the chunk's one fetch of
    its metrics, so the ratio must stay about 1.  The JAX driver's order
    (the default): the no-op side's calls, then the recorder's; with
    ``turns`` the two sides take turns.  On an H100 80GB HBM3 at 700 W
    the two orders read alike (0.981-0.985 in the JAX order, best of 3,
    against 0.975-0.981 in turns, best of 5; ``chip_smoke.py`` phase 26),
    and the JAX order read 0.918 on a slower machine.  Every timed call's
    seconds come back in order, ``*_calls_s``."""
    from repro_torch.telemetry import Telemetry
    device = resolve_device(device)
    bundle = cnn_bundle(SMOKE, device=device)
    x, y = synthetic_classification(240, SMOKE.in_shape, SMOKE.num_classes,
                                    seed=seed, signal=12.0)
    fed = partition_iid(x, y, n, seed=seed)
    fsl = FSLConfig(num_clients=n, h=1, lr=0.05, method=method)
    sides = []
    for telemetry in (None, Telemetry()):
        tr = Trainer(bundle, fsl, telemetry=telemetry)
        box = {"state": tr.init(seed),
               "batcher": FederatedBatcher(fed, batch_size, 1, seed=seed)}

        def call(tr=tr, box=box, r=rounds):
            box["state"], _ = tr.run_compiled(box["state"], box["batcher"],
                                              r, chunk=chunk)
        call(r=chunk)               # the first call captures the graphs
        sides.append(call)
    order = [0, 1] * repeats if turns else [0] * repeats + [1] * repeats
    calls = [[], []]
    for i in order:
        calls[i].append(_timed(sides[i], device)[1])
    off_sps, on_sps = rounds / min(calls[0]), rounds / min(calls[1])
    return {"arch": SMOKE.name, "method": method, "rounds": rounds,
            "chunk": chunk, "turns": turns,
            "telemetry_off_steps_per_s": round(off_sps, 2),
            "telemetry_on_steps_per_s": round(on_sps, 2),
            "telemetry_overhead_ratio": round(on_sps / off_sps, 3),
            "telemetry_off_calls_s": calls[0],
            "telemetry_on_calls_s": calls[1]}


def main(smoke: bool = False, device="cuda"):
    device = resolve_device(device)
    rounds, chunk = (80, 20) if smoke else (160, 40)
    rows = []
    for method in METHODS:
        rows.append(bench_one(SMOKE, method, h=1, rounds=rounds, chunk=chunk,
                              batch_size=2, device=device))
    if not smoke:
        # the h-lever (CSE trains h batches per dispatch) and bigger CNNs,
        # where compute narrows the dispatch gap
        rows.append(bench_one(SMOKE, "cse_fsl", h=5, rounds=rounds // 2,
                              chunk=chunk // 2, batch_size=2, device=device))
        rows.append(bench_one(MID, "cse_fsl", h=1, rounds=60, chunk=20,
                              batch_size=4, device=device))
        rows.append(bench_one(CIFAR10, "cse_fsl", h=1, rounds=30, chunk=10,
                              batch_size=16, device=device))

    banner("perf_bench — per-round loop vs compiled chunk runner "
           f"({'smoke' if smoke else 'full'}, {device.type})")
    table(rows, ["arch", "method", "h", "loop_steps_per_s",
                 "compiled_steps_per_s", "speedup", "dispatch_ms_per_round",
                 "compile_chunk_s"])

    # where dispatch dominates (smoke CNN, h=1) the compiled runner must at
    # least double throughput; REPRO_PERF_MIN_SPEEDUP overrides the bar
    min_speedup = float(os.environ.get("REPRO_PERF_MIN_SPEEDUP", "2.0"))
    for r in rows:
        if r["arch"] == SMOKE.name and r["h"] == 1:
            assert r["speedup"] >= min_speedup, r

    # telemetry must be free on the dispatch-dominated smoke CNN, the worst
    # case for any added host work
    tele = bench_telemetry_overhead(rounds, chunk, device=device)
    table([tele], ["arch", "method", "telemetry_off_steps_per_s",
                   "telemetry_on_steps_per_s", "telemetry_overhead_ratio"])
    min_ratio = float(os.environ.get("REPRO_TELEMETRY_MIN_RATIO", "0.95"))
    assert tele["telemetry_overhead_ratio"] >= min_ratio, tele

    payload = {"rows": rows,
               "telemetry_overhead": tele,
               "backend": device.type,
               "device_count": torch.cuda.device_count()
               if device.type == "cuda" else 1,
               "device_name": torch.cuda.get_device_name(device)
               if device.type == "cuda" else "cpu"}
    path = save("torch_perf_bench", payload)
    print(f"\nwrote {path}")
    return rows, tele


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="smoke CNN only, fewer rounds")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card)")
    main(**vars(ap.parse_args()))
