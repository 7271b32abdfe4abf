"""Fig. F (beyond-paper) on the port: fault injection — accuracy, exact
retry-byte accounting and the failure-aware wall-clock against loss and
crash rates (``benchmarks/fig_faults.py``).

Each fault model of :mod:`repro_torch.faults` trains the same small split
CNN (CSE-FSL, 4 clients, h = 2, B = 16, 12 rounds) under the same seed
through ``Trainer.run``; lost transmissions are billed from the pre-drawn
fault trace, crashed clients drop out of their window's FedAvg through
masked participation.  Keeps the JAX script's claims as assertions:
  - exact accounting: on the lossy wire the meter's uplink, label and
    frame totals equal the trace's attempt counts times the per-unit wire
    bytes, and ``FaultStats.retransmit_bytes`` equals the expectation
    computed here from the trace alone;
  - graceful degradation: at a 10 % crash rate the final accuracy is at
    least the fault-free run's less 0.15;
  - the failure-aware wall-clock estimate (``UniformNetwork``) of the
    lossy run is above the clean one.
All are read off a run under deterministic algorithms
(``common.deterministic``).  Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_faults \\
        [--device cpu] [--smoke] [--rounds R]
"""
from __future__ import annotations

import argparse
import warnings

import numpy as np

from repro_torch.benchmarks.common import (accuracy, banner, deterministic,
                                          save, table)
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.faults import (FRAME_BYTES, CrashyClients, LossyWire,
                                NoFaults, OutageServer)
from repro_torch.models.cnn import CNNConfig
from repro_torch.network import UniformNetwork

ROUNDS = 12
BS = 16
N_CLIENTS = 4
H = 2
MODEL = CNNConfig("faults_cnn", (8, 8, 1), 10, conv_channels=(4, 4),
                  kernel=3, server_widths=(16,), aux_channels=2, lrn=False)
MiB = 1024.0 * 1024.0


def fault_grid(smoke: bool):
    grid = [NoFaults(),
            LossyWire(loss_rate=0.1, seed=7),
            CrashyClients(crash_rate=0.1, seed=5)]
    if not smoke:
        grid += [LossyWire(loss_rate=0.3, name="lossy30", seed=5),
                 CrashyClients(crash_rate=0.3, name="crashy30", seed=5),
                 OutageServer(outage_rate=0.2, outage_s=10.0, seed=5)]
    return grid


def _cost_model(n: int, rounds: int) -> CostModel:
    return CostModel(n=n, q=8, d_local=BS * rounds, w_client=100,
                     w_server=100, aux=10)


def run_one(bundle, fed, test, fm, rounds: int, seed=0, state=None):
    """One fault model's run; ``state`` (default ``trainer.init(seed)``) is
    the initial state."""
    fsl = FSLConfig(num_clients=fed.num_clients, h=H, lr=0.15,
                    method="cse_fsl")
    trainer = Trainer(bundle, fsl, faults=fm)
    meter = CommMeter()
    cm = _cost_model(fed.num_clients, rounds)
    state = trainer.init(seed) if state is None else state
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # all-crashed windows warn
        state, _ = trainer.run(state, FederatedBatcher(fed, BS, H, seed=seed),
                               rounds, log_every=rounds, meter=meter,
                               cost_model=cm)
    acc = accuracy(bundle, MODEL, trainer.merged_params(state), *test)
    est = trainer.wallclock_estimate(
        cm, BS, rounds, UniformNetwork(),
        batch=FederatedBatcher(fed, BS, H, seed=seed).next_round())
    summary = trainer.participation_summary()
    fstats = (summary or {}).get("faults")
    return {"trainer": trainer, "meter": meter, "acc": acc,
            "wallclock_s": est.total, "faults": fstats}


def expected_lossy_bytes(trainer, fm, rounds: int, meter):
    """The trace-derived byte expectation, computed independently of every
    engine: attempts * per-unit wire bytes, frame per attempt."""
    n, K = trainer.fsl.num_clients, trainer._uploads_per_round()
    per_up, per_label, per_down = trainer.comm_profile(
        _cost_model(n, rounds), BS).unit_wire_bytes(n, K)
    trace = fm.trace(rounds, n, K)
    up_att = int(trace.up_attempts.sum())
    retr = int(np.maximum(trace.up_attempts - 1, 0).sum())
    return {
        "uplink_smashed": per_up * up_att,
        "uplink_labels": per_label * up_att,
        "fault_frames": FRAME_BYTES * up_att,
        "retransmit_bytes": retr * (per_up + per_label + FRAME_BYTES),
    }


@deterministic()
def main(device="cuda", rounds: int = ROUNDS, smoke: bool = False):
    bundle = cnn_bundle(MODEL, device=device)
    x, y = synthetic_classification(1200, MODEL.in_shape, 10, signal=12.0)
    xt, yt = synthetic_classification(300, MODEL.in_shape, 10, seed=99,
                                      signal=12.0)
    fed = partition_iid(x, y, N_CLIENTS)

    results = {}
    for fm in fault_grid(smoke):
        results[fm.name] = run_one(bundle, fed, (xt, yt), fm, rounds)

    rows = []
    for name, r in results.items():
        fs = r["faults"] or {}
        rows.append({
            "faults": name, "acc": round(r["acc"], 3),
            "est_wallclock_s": round(r["wallclock_s"], 1),
            "retries": fs.get("retries", 0),
            "retry_mib": round(fs.get("retransmit_bytes", 0) / MiB, 3),
            "wire_drops": fs.get("wire_drops", 0),
            "crash_drops": fs.get("crash_drops", 0),
            "empty_windows": fs.get("empty_windows", 0),
            "mean_part": round(fs.get("mean_participants") or N_CLIENTS,
                               2)})
    banner(f"Fig F — fault injection ({N_CLIENTS} clients, {rounds} "
           f"rounds, cse_fsl h={H}; {bundle.device})")
    table(rows, ["faults", "acc", "est_wallclock_s", "retries", "retry_mib",
                 "wire_drops", "crash_drops", "empty_windows", "mean_part"])

    # 1. exact accounting on the lossy wire: the engine's billing equals
    # the trace-derived expectation, to the byte
    lossy = results["lossy"]
    fm = next(f for f in fault_grid(smoke) if f.name == "lossy")
    expect = expected_lossy_bytes(lossy["trainer"], fm, rounds,
                                  lossy["meter"])
    counts = lossy["meter"].counts
    for kind in ("uplink_smashed", "uplink_labels", "fault_frames"):
        assert counts[kind] == expect[kind], (kind, counts[kind], expect)
    assert lossy["faults"]["retransmit_bytes"] \
        == expect["retransmit_bytes"], (lossy["faults"], expect)
    assert lossy["faults"]["retries"] > 0, lossy["faults"]

    # 2. graceful degradation: a 10% crash rate costs accuracy, not
    # correctness — masked FedAvg keeps the run near the fault-free one
    clean, crashy = results["none"], results["crashy"]
    assert crashy["acc"] >= clean["acc"] - 0.15, (crashy["acc"],
                                                  clean["acc"])
    assert crashy["faults"]["crash_drops"] > 0, crashy["faults"]

    # 3. retransmissions cost wall-clock: the failure-aware estimate is
    # strictly above the clean barrier time
    assert lossy["wallclock_s"] > clean["wallclock_s"], \
        (lossy["wallclock_s"], clean["wallclock_s"])

    save("torch_fig_faults", {
        "rows": rows,
        "expected_lossy_bytes": expect,
        "meter": {name: dict(r["meter"].counts)
                  for name, r in results.items()},
        "fault_stats": {name: r["faults"] for name, r in results.items()},
        "device": str(bundle.device),
    })
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="4 rounds and the 3-model grid (still asserts the "
                         "exact bytes and the degradation)")
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args()
    main(args.device, rounds=4 if args.smoke else (args.rounds or ROUNDS),
         smoke=args.smoke)
