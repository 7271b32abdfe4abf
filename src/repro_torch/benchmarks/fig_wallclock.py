"""Fig. W (beyond-paper) on the port: accuracy against *simulated
wall-clock* per codec and network tier (``benchmarks/fig_wallclock.py``).

Every upload event of the event engine takes ``wire_bytes / bandwidth +
rtt`` simulated seconds (``repro_torch.network``), so an int8 uplink does
not just shrink ``CommMeter`` totals -- it finishes each round sooner, and
the run reaches a target accuracy earlier on any finite link.  The
model-sync wire is coded too, so FedAvg rounds are not time-free.  The
full CIFAR-10 CNN, CSE-FSL, 4 clients, h = 2, B = 20, lr 0.15, 12 rounds,
0.5 s compute a unit, 0.02 s service an upload, over the 3g / 4g / wifi
tiers and the none / int8 / topk codecs (the model sync coded alike).
Keeps the JAX script's claims as assertions:
  - on every tier int8 reaches the target accuracy in strictly less
    simulated time than the identity codec, and ends the budget strictly
    sooner;
  - model-sync bytes are metered compressed (int8 < fp32 / 3.5);
  - tighter links stretch wall-clock: the same run takes strictly longer
    on 3g than on wifi.
Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_wallclock \\
        [--device cpu] [--smoke] [--rounds R]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import accuracy, banner, save, table
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.async_trainer import AsyncTrainer, ConstantLatency
from repro_torch.core.bundle import cnn_bundle
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.models.cnn import CIFAR10
from repro_torch.network import MBPS, TIERS, UniformNetwork

ROUNDS = 12
BS = 20
N_CLIENTS = 4
H = 2
COMPUTE_S = 0.5                 # per-unit client compute seconds
SERVER_S = 0.02
NET_TIERS = ("3g", "4g", "wifi")
CODECS = ("none", "int8", "topk")


def tier_network(tier: str) -> UniformNetwork:
    link = TIERS[tier]
    return UniformNetwork(up_mbps=link.up_bps / MBPS,
                          down_mbps=link.down_bps / MBPS, rtt=link.rtt)


def run_one(bundle, fed, test, cm, tier: str, codec: str, rounds: int,
            lr=0.15, seed=0):
    """One (network tier, codec) training run; returns the (sim_time,
    accuracy) curve and the CommMeter."""
    fsl = FSLConfig(num_clients=fed.num_clients, h=H, lr=lr,
                    method="cse_fsl", codec=codec, model_codec=codec)
    trainer = AsyncTrainer(bundle, fsl,
                           latency=ConstantLatency(COMPUTE_S, 0.0, 0.0),
                           network=tier_network(tier),
                           server_time=SERVER_S, seed=1)
    meter = CommMeter()
    curve = []

    def record(rnd, m, state):
        curve.append({"round": rnd, "t": trainer.stats.async_time,
                      "acc": accuracy(bundle, CIFAR10,
                                      trainer.merged_params(state), *test)})

    state = trainer.init(seed)
    trainer.run(state, FederatedBatcher(fed, BS, H, seed=seed), rounds,
                log_every=max(rounds // 4, 1), callback=record,
                meter=meter, cost_model=cm)
    return curve, meter


def time_to(curve, target: float):
    """First simulated second at which the curve reaches ``target``."""
    for p in curve:
        if p["acc"] >= target:
            return p["t"]
    return None


def main(device="cuda", rounds: int = ROUNDS, tiers=NET_TIERS,
         codecs=CODECS):
    bundle = cnn_bundle(CIFAR10, device=device)
    x, y = synthetic_classification(1200, CIFAR10.in_shape, 10, signal=12.0)
    xt, yt = synthetic_classification(400, CIFAR10.in_shape, 10, seed=99,
                                      signal=12.0)
    fed = partition_iid(x, y, N_CLIENTS)
    cm = CostModel(n=N_CLIENTS, q=bundle.smashed_bytes_per_sample,
                   d_local=len(x) // N_CLIENTS,
                   w_client=bytes_of(bundle.specs["client"]),
                   w_server=bytes_of(bundle.specs["server"]),
                   aux=bytes_of(bundle.specs["aux"]))

    out, rows, meters = {}, [], {}
    for tier in tiers:
        for codec in codecs:
            curve, meter = run_one(bundle, fed, (xt, yt), cm, tier, codec,
                                   rounds)
            out[f"{tier}/{codec}"] = curve
            meters[(tier, codec)] = meter

    # target: a band every codec's curve reaches
    target = 0.8 * min(max(p["acc"] for p in c) for c in out.values())
    for tier in tiers:
        for codec in codecs:
            curve, meter = out[f"{tier}/{codec}"], meters[(tier, codec)]
            t = time_to(curve, target)
            rows.append({
                "network": tier, "codec": codec,
                "acc": round(curve[-1]["acc"], 3),
                "sim_h": round(curve[-1]["t"] / 3600, 3),
                "t_to_target_s": round(t, 1) if t is not None else None,
                "wire_MiB": round(meter.total / 2 ** 20, 2),
                "model_sync_MiB": round(
                    meter.counts["model_sync"] / 2 ** 20, 2)})
    banner(f"Fig W — accuracy vs simulated wall-clock "
           f"({N_CLIENTS} clients, {rounds} rounds, cse_fsl h={H}; "
           f"target acc {target:.3f}; {bundle.device})")
    table(rows, ["network", "codec", "acc", "sim_h", "t_to_target_s",
                 "wire_MiB", "model_sync_MiB"])

    # assertions compare the UNROUNDED curve/meter values
    for tier in tiers:
        t_none = time_to(out[f"{tier}/none"], target)
        t_int8 = time_to(out[f"{tier}/int8"], target)
        # compression wins wall-clock, strictly
        assert t_none is not None and t_int8 is not None, (tier, rows)
        assert t_int8 < t_none, (tier, t_int8, t_none)
        assert out[f"{tier}/int8"][-1]["t"] < out[f"{tier}/none"][-1]["t"], \
            (tier, rows)
        # model sync is metered compressed
        ms_none = meters[(tier, "none")].counts["model_sync"]
        ms_int8 = meters[(tier, "int8")].counts["model_sync"]
        assert 0 < ms_int8 < ms_none / 3.5, (tier, ms_int8, ms_none)
    if "3g" in tiers and "wifi" in tiers:
        assert out["3g/none"][-1]["t"] > out["wifi/none"][-1]["t"]

    save("torch_fig_wallclock", {"target_acc": target, "curves": out,
                                 "rows": rows,
                                 "device": str(bundle.device)})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="4 rounds, one tier, 2 codecs")
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args()
    if args.smoke:
        main(args.device, rounds=4, tiers=("4g",), codecs=("none", "int8"))
    else:
        main(args.device, rounds=args.rounds or ROUNDS)
