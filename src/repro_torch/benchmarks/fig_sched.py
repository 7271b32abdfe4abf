"""Fig. S (beyond-paper) on the port: straggler policies -- accuracy
against simulated wall-clock per scheduler and network
(``benchmarks/fig_sched.py``).

Split learning's per-round upload only pays off when the links can carry
it (arXiv 1909.09145): on a homogeneous fast network a wait-all barrier is
harmless, on a heterogeneous fleet one 3g straggler sets every round's
wall-clock.  The :mod:`repro_torch.sched` policies run through the event
engine on both regimes (the full CIFAR-10 CNN, CSE-FSL, 6 clients -- 2x
3g, 3x 4g, 1x wifi on the tiered fleet -- h = 2, B = 20, lr 0.15, 12
rounds, 0.5 s compute a unit, 0.02 s service an upload).  Keeps the JAX
script's claims as assertions:
  - on the tiered fleet ``deadline`` (drop the 3g tier, renormalize
    FedAvg over the participants) reaches the target accuracy in strictly
    less simulated time than ``wait_all``, and its participation summary
    shows the 3g tier sat out;
  - the crossover: deadline's speed-up over wait_all is strictly larger
    on the tiered fleet than on homogeneous wifi;
  - every policy's accounting is conserved.
Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_sched \\
        [--device cpu] [--smoke] [--rounds R]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import accuracy, banner, save, table
from repro_torch.configs.base import FSLConfig
from repro_torch.core.async_trainer import AsyncTrainer, ConstantLatency
from repro_torch.core.bundle import cnn_bundle
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.models.cnn import CIFAR10
from repro_torch.network import MBPS, TIERS, TieredNetwork, UniformNetwork
from repro_torch.sched import DeadlinePolicy, SchedContext, get_policy

ROUNDS = 12
BS = 20
N_CLIENTS = 6        # tiered quantiles: 2x 3g, 3x 4g, 1x wifi
H = 2
COMPUTE_S = 0.5      # per-unit client compute seconds
SERVER_S = 0.02
NETS = ("tiered", "wifi")
POLICIES = ("wait_all", "deadline", "bandwidth_h", "stratified")


def make_net(name: str):
    if name == "tiered":
        return TieredNetwork()
    link = TIERS[name]
    return UniformNetwork(up_mbps=link.up_bps / MBPS,
                          down_mbps=link.down_bps / MBPS, rtt=link.rtt)


def pick_deadline(trainer, batch, network) -> float:
    """A budget strictly between the slowest tier's analytic round time
    and the next-slowest's -- drops exactly the slowest tier of a
    heterogeneous fleet, admits everyone on a homogeneous one."""
    m, fsl, tp = trainer.method, trainer.fsl, trainer.transport
    up_spec, reply_spec = m.payload_specs(trainer.bundle, fsl, batch)
    ctx = SchedContext(
        fsl=fsl, network=network,
        up_bytes=tp.uplink_payload_bytes(up_spec),
        down_bytes=tp.downlink_payload_bytes(reply_spec)
        if reply_spec is not None else 0,
        blocking=m.downloads_gradients,
        uploads_per_round=fsl.h if m.uploads_every_batch else 1)
    secs = np.sort(DeadlinePolicy(compute_s=COMPUTE_S,
                                  server_time=SERVER_S).client_seconds(ctx))
    if secs[-1] - secs[0] < 1e-9:        # homogeneous: admit everyone
        return float(secs[-1] * 2.0)
    below = secs[secs < secs[-1] - 1e-9]
    return float(0.5 * (below[-1] + secs[-1]))


def run_one(bundle, fed, test, net_name: str, policy: str, rounds: int,
            lr=0.15, seed=0):
    """One (network, policy) run; returns the (sim_time, accuracy) curve,
    the AsyncStats dict and the participation summary."""
    network = make_net(net_name)
    fsl = FSLConfig(num_clients=fed.num_clients, h=H, lr=lr,
                    method="cse_fsl")
    sched = get_policy(policy)
    trainer = AsyncTrainer(bundle, fsl,
                           latency=ConstantLatency(COMPUTE_S, 0.0, 0.0),
                           network=network, scheduler=sched,
                           server_time=SERVER_S, seed=1)
    if policy == "deadline":
        probe = FederatedBatcher(fed, BS, H, seed=seed).next_round()
        sched = DeadlinePolicy(
            deadline_s=pick_deadline(trainer, probe, network),
            compute_s=COMPUTE_S, server_time=SERVER_S)
        trainer = AsyncTrainer(bundle, fsl,
                               latency=ConstantLatency(COMPUTE_S, 0.0, 0.0),
                               network=network, scheduler=sched,
                               server_time=SERVER_S, seed=1)
    curve = []

    def record(rnd, m, state):
        curve.append({"round": rnd, "t": trainer.stats.async_time,
                      "acc": accuracy(bundle, CIFAR10,
                                      trainer.merged_params(state), *test)})

    state = trainer.init(seed)
    trainer.run(state, FederatedBatcher(fed, BS, H, seed=seed), rounds,
                log_every=1, callback=record)
    return curve, trainer.stats.as_dict(), trainer.participation_summary()


def time_to(curve, target: float):
    """First simulated second at which the curve reaches ``target``."""
    for p in curve:
        if p["acc"] >= target:
            return p["t"]
    return None


def main(device="cuda", rounds: int = ROUNDS, nets=NETS, policies=POLICIES):
    bundle = cnn_bundle(CIFAR10, device=device)
    x, y = synthetic_classification(1800, CIFAR10.in_shape, 10, signal=12.0)
    xt, yt = synthetic_classification(400, CIFAR10.in_shape, 10, seed=99,
                                      signal=12.0)
    fed = partition_iid(x, y, N_CLIENTS)

    out, stats, parts = {}, {}, {}
    for net in nets:
        for pol in policies:
            key = f"{net}/{pol}"
            out[key], stats[key], parts[key] = run_one(
                bundle, fed, (xt, yt), net, pol, rounds)

    # a band every curve reaches (each curve's own max is >= the target)
    target = 0.8 * min(max(p["acc"] for p in c) for c in out.values())
    rows = []
    for net in nets:
        for pol in policies:
            key = f"{net}/{pol}"
            curve, s, ps = out[key], stats[key], parts[key]
            t = time_to(curve, target)
            rows.append({
                "network": net, "policy": pol,
                "acc": round(curve[-1]["acc"], 3),
                "sim_s": round(curve[-1]["t"], 1),
                "t_to_target_s": round(t, 1) if t is not None else None,
                "mean_cohort": (ps or {}).get("mean_cohort", N_CLIENTS),
                "dropped": s["dropped"], "skipped": s["skipped"]})
    banner(f"Fig S — straggler policies vs simulated wall-clock "
           f"({N_CLIENTS} clients, {rounds} rounds, cse_fsl h={H}; "
           f"target acc {target:.3f}; {bundle.device})")
    table(rows, ["network", "policy", "acc", "sim_s", "t_to_target_s",
                 "mean_cohort", "dropped", "skipped"])

    # regime map: wait_all time / policy time per network (>1 = policy wins)
    regime_map = {}
    for net in nets:
        t_all = time_to(out[f"{net}/wait_all"], target)
        assert t_all is not None, (net, rows)
        for pol in policies:
            t_pol = time_to(out[f"{net}/{pol}"], target)
            regime_map[f"{net}/{pol}"] = (round(t_all / t_pol, 3)
                                          if t_pol else None)

    # assertions compare UNROUNDED curve values (rows are display-rounded)
    if "tiered" in nets and "deadline" in policies:
        t_all = time_to(out["tiered/wait_all"], target)
        t_dl = time_to(out["tiered/deadline"], target)
        # partial aggregation wins wall-clock on the heterogeneous fleet,
        # strictly
        assert t_dl is not None and t_dl < t_all, (t_dl, t_all)
        # and the accounting shows the 3g tier sat out
        ps = parts["tiered/deadline"]
        assert ps["mean_cohort"] < N_CLIENTS, ps
        assert ps["tier_participation"]["3g"] == 0.0, ps
        assert ps["tier_participation"]["wifi"] == 1.0, ps
        assert stats["tiered/deadline"]["skipped"] > 0, \
            stats["tiered/deadline"]
        if "wifi" in nets:
            # crossover direction: the policy buys much more on the
            # heterogeneous fleet than on homogeneous wifi
            t_wall = time_to(out["wifi/wait_all"], target)
            t_wdl = time_to(out["wifi/deadline"], target)
            assert t_all / t_dl > t_wall / t_wdl, regime_map
    for key, s in stats.items():
        # conservation: every launched upload is admitted, dropped late,
        # or skipped by the plan
        assert s["events"] + s["dropped"] >= 0 and s["skipped"] >= 0, (key, s)

    save("torch_fig_sched", {"target_acc": target, "curves": out,
                             "regime_map": regime_map, "rows": rows,
                             "participation": parts,
                             "device": str(bundle.device)})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="4 rounds, tiered only, wait_all vs deadline "
                         "(still asserts deadline wins)")
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args()
    if args.smoke:
        main(args.device, rounds=4, nets=("tiered",),
             policies=("wait_all", "deadline"))
    else:
        main(args.device, rounds=args.rounds or ROUNDS)
