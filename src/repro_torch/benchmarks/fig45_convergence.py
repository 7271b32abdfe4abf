"""Paper Figs. 4 & 5 on the port: top-1 accuracy against communication
rounds (``benchmarks/fig45_convergence.py``).

Runs all four methods (FSL_MC / FSL_OC / FSL_AN, and CSE_FSL at h = 1 and
5) on the paper's CIFAR-10 CNN over the planted-signal synthetic data, iid
and Dirichlet, 5 clients, B = 24, 12 rounds, each through
``Trainer.run_compiled`` with the chunk equal to the log cadence, so the
callback reads accuracy off the exact state of each logged round.  Keeps
the JAX script's claims as assertions, unchanged in value: on the iid half
the per-batch methods end below a loss of 2.32, CSE-FSL h = 5 below 2.45,
and CSE-FSL h = 1's accuracy is above FSL_OC's less 0.1, all read off a
run under deterministic algorithms (``common.deterministic``), so that a
claim holds or fails on every run.  Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig45_convergence \\
        [--device cpu] [--rounds R]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import (accuracy, banner, deterministic,
                                          save, table)
from repro_torch.configs.base import FSLConfig
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_dirichlet,
                              partition_iid, synthetic_classification)
from repro_torch.models.cnn import CIFAR10

ROUNDS = 12
BS = 24
N_CLIENTS = 5


def run_method(bundle, fed, test, method: str, h: int, rounds: int, lr=0.15,
               seed=0, state=None):
    """One method's curve: ``[{"round", "acc", "loss"}]`` every 6 rounds.
    ``state`` (default ``trainer.init(seed)``) is the initial state."""
    fsl = FSLConfig(num_clients=fed.num_clients, h=h, lr=lr, method=method,
                    grad_clip=1.0 if method == "fsl_oc" else 0.0)
    trainer = Trainer(bundle, fsl)
    state = trainer.init(seed) if state is None else state
    batcher = FederatedBatcher(fed, BS, h, seed=seed)
    curve = []

    def record(rnd, m, state):
        acc = accuracy(bundle, CIFAR10, trainer.merged_params(state), *test)
        curve.append({"round": rnd, "acc": acc,
                      "loss": m.get("client_loss", m.get("loss"))})

    trainer.run_compiled(state, batcher, rounds, chunk=6, log_every=6,
                         callback=record)
    return curve


@deterministic()
def main(device="cuda", rounds: int = ROUNDS):
    bundle = cnn_bundle(CIFAR10, device=device)
    x, y = synthetic_classification(1500, CIFAR10.in_shape, 10, signal=12.0)
    xt, yt = synthetic_classification(500, CIFAR10.in_shape, 10, seed=99,
                                      signal=12.0)
    out = {}
    for dist, fed in (("iid", partition_iid(x, y, N_CLIENTS)),
                      ("non_iid", partition_dirichlet(x, y, N_CLIENTS))):
        rows = []
        for method in ("fsl_mc", "fsl_oc", "fsl_an"):
            curve = run_method(bundle, fed, (xt, yt), method, 1, rounds)
            rows.append({"method": method, **curve[-1]})
            out[f"{dist}/{method}"] = curve
        for h in (1, 5):
            curve = run_method(bundle, fed, (xt, yt), "cse_fsl", h, rounds)
            rows.append({"method": f"cse_fsl_h{h}", **curve[-1]})
            out[f"{dist}/cse_fsl_h{h}"] = curve
        banner(f"Fig 4/5 — CIFAR-10 CNN, {dist} ({N_CLIENTS} clients, "
               f"{rounds} rounds; {bundle.device})")
        table(rows, ["method", "round", "acc", "loss"])
        if dist == "iid":
            accs = {r["method"]: r["acc"] for r in rows}
            losses = {r["method"]: r["loss"] for r in rows}
            # the JAX script's claims: the per-batch methods below 2.32,
            # h=5 in the same loss band, the paper's ordering (qualitative)
            per_batch = [l for m, l in losses.items() if not m.endswith("h5")]
            assert all(l < 2.32 for l in per_batch), losses
            assert losses["cse_fsl_h5"] < 2.45, losses
            assert accs["cse_fsl_h1"] > accs["fsl_oc"] - 0.1, accs
    save("torch_fig45_convergence", {**out, "device": str(bundle.device)})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    main(args.device, args.rounds)
