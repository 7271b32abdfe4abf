"""Asynchronous federated split learning — thin driver over AsyncTrainer.

The vmapped round step executes clients in lockstep; `repro_torch.core.async_trainer`
simulates the paper's *wall-clock* story instead (Fig. 3 / Fig. 6): every
client gets a compute/network latency profile from a pluggable model, the
server consumes smashed uploads event-triggered in ARRIVAL order (a
priority queue of upload-completion times), and aggregation fires on the
C-batch cadence.  This driver runs any registered method under any latency
model, reports the straggler time saved vs a synchronous barrier, and
re-runs the same training under a different latency seed to show the final
accuracy is arrival-order insensitive (Fig. 6).

  python -m repro_torch.examples.async_sim [--clients 8] [--rounds 20] \
      [--method cse_fsl] [--latency straggler] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.benchmarks.common import accuracy
from repro_torch.configs.base import FSLConfig
from repro_torch.core.async_trainer import AsyncTrainer, make_latency
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.methods import available_methods
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.faults import FAULT_MODELS, fault_from_flags
from repro_torch.models.cnn import CIFAR10
from repro_torch.network import NETWORK_MODELS, network_from_flags
from repro_torch.sched import available_policies, scheduler_from_flags
from repro_torch.transport import available_codecs


def run(args, latency_seed: int, telemetry=None):
    bundle = cnn_bundle(CIFAR10, device=args.device)
    x, y = synthetic_classification(args.clients * 300, CIFAR10.in_shape, 10,
                                    signal=12.0, seed=1)
    fed = partition_iid(x, y, args.clients, seed=1)
    fsl = FSLConfig(num_clients=args.clients, h=args.h, lr=args.lr,
                    method=args.method, codec=args.codec,
                    model_codec=args.model_codec,
                    grad_clip=1.0 if args.method == "fsl_oc" else 0.0)
    latency = make_latency(args.latency)
    network = network_from_flags(args.network, args.bandwidth_mbps)
    if not network.is_ideal:
        # a real network owns all transfer time; latency narrows to compute
        latency = latency.compute_only()
    scheduler = scheduler_from_flags(args.scheduler, args.deadline_s)
    faults = fault_from_flags(args.faults, args.loss_rate, args.crash_rate,
                              args.max_retries)
    trainer = AsyncTrainer(bundle, fsl, latency=latency, network=network,
                           scheduler=scheduler, faults=faults,
                           seed=latency_seed, telemetry=telemetry)
    state = trainer.init(args.seed)
    batcher = FederatedBatcher(fed, 20, args.h, seed=1)
    state, history = trainer.run(state, batcher, args.rounds,
                                 log_every=max(args.rounds // 4, 1))
    xt, yt = synthetic_classification(400, CIFAR10.in_shape, 10, seed=9,
                                      signal=12.0)
    acc = accuracy(bundle, CIFAR10, trainer.merged_params(state), xt, yt)
    return acc, history, trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--h", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--method", default="cse_fsl",
                    choices=list(available_methods()))
    ap.add_argument("--latency", default="lognormal",
                    choices=("constant", "lognormal", "straggler"))
    ap.add_argument("--codec", default="none",
                    choices=list(available_codecs()),
                    help="uplink wire codec applied to every upload event")
    ap.add_argument("--model-codec", default="none",
                    choices=list(available_codecs()),
                    help="model-sync (FedAvg up/download) wire codec")
    ap.add_argument("--network", default="ideal",
                    choices=sorted(NETWORK_MODELS),
                    help="per-client link model: upload events take "
                         "wire_bytes/bandwidth + rtt simulated seconds "
                         "(ideal = infinite bandwidth, the legacy default)")
    ap.add_argument("--bandwidth-mbps", type=float, default=10.0,
                    help="mean uplink rate for --network uniform/lognormal/"
                         "trace (downlink 5x; tiered has per-tier rates)")
    ap.add_argument("--scheduler", default="wait_all",
                    choices=list(available_policies()),
                    help="aggregation-barrier scheduling policy (wait_all "
                         "= legacy everyone-participates barrier, bitwise)")
    ap.add_argument("--deadline-s", type=float, default=30.0,
                    help="per-round wall-clock budget for --scheduler "
                         "deadline; late arrivals are dropped and FedAvg "
                         "renormalizes over the participants")
    ap.add_argument("--faults", default="none",
                    choices=sorted(FAULT_MODELS),
                    help="deterministic fault model: lossy uploads are "
                         "checksum-verified and retransmitted with backoff "
                         "in the event queue, crashed clients sit the round "
                         "out, outages stall the server")
    ap.add_argument("--loss-rate", type=float, default=None)
    ap.add_argument("--crash-rate", type=float, default=None)
    ap.add_argument("--max-retries", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write the telemetry round-record JSONL to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the simulated timeline as Chrome "
                         "trace-event JSON (open in Perfetto)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card)")
    args = ap.parse_args(argv)

    tele = None
    if args.telemetry or args.trace:
        from repro_torch.telemetry import Telemetry
        tele = Telemetry()
    acc1, hist, trainer = run(args, latency_seed=1, telemetry=tele)
    stats = trainer.stats
    for row in hist:
        keys = [k for k in row if k not in ("round", "aggregated")]
        print(f"round {row['round']:3d}  " +
              "  ".join(f"{k}={row[k]:.4f}" if isinstance(row[k], float)
                        else f"{k}={row[k]}" for k in keys))
    acc2, _, _ = run(args, latency_seed=2)
    participation = trainer.participation_summary()
    print(f"\narrival order A: top-1 = {acc1:.3f}")
    print(f"arrival order B: top-1 = {acc2:.3f}   "
          f"(|diff| = {abs(acc1 - acc2):.3f} — Fig. 6: order-insensitive)")
    s = stats.as_dict()
    print(f"simulated wall-clock: async server = {s['async_time']:.1f}s, "
          f"synchronous barrier = {s['sync_time']:.1f}s "
          f"({s['speedup']:.2f}x straggler overhead removed); "
          f"server idle {s['server_idle']:.1f}s over {s['events']} uploads")
    if args.network != "ideal":
        print(f"network ({args.network}): transfer {s['comm_time']:.1f}s, "
              f"model sync {s['model_sync_time']:.1f}s of the async total")
    if participation is not None and "mean_cohort" in participation:
        print(f"scheduler {args.scheduler!r}: mean cohort "
              f"{participation['mean_cohort']}/{args.clients}, "
              f"dropped {s['dropped']} late / skipped {s['skipped']} "
              f"planned-out uploads")
    fa = (participation or {}).get("faults")
    if fa is not None:
        print(f"faults {args.faults!r}: {fa['retries']} retransmissions "
              f"({fa['retry_seconds']:.1f}s backoff), "
              f"{fa['crash_drops']} crashes, {fa['wire_drops']} wire drops, "
              f"{fa['outages']} outages survived; "
              f"{fa['empty_windows']}/{fa['windows']} windows empty")
    if tele is not None:
        if args.telemetry:
            tele.export_jsonl(args.telemetry)
            print(f"telemetry: {len(tele.records)} records -> "
                  f"{args.telemetry}")
        if args.trace:
            tele.export_trace(args.trace)
            print(f"telemetry: {len(tele.spans)} simulated-timeline spans "
                  f"-> {args.trace} (open in Perfetto)")
    assert np.isfinite(acc1) and np.isfinite(acc2)
    if args.rounds >= 10:        # short smoke runs are too noisy to compare
        assert abs(acc1 - acc2) < 0.08, (acc1, acc2)
    return acc1, acc2, hist, stats


if __name__ == "__main__":
    main()
