"""Fig. 9 (beyond-paper) on the port: accuracy against cumulative uplink
wire bytes per method x codec (``benchmarks/fig9_codec_tradeoff.py``).

CSE-FSL cuts uplink traffic by uploading once per h batches; the wire
codecs cut the bytes of each upload instead.  This script trains every
method under every codec (``none``/``int8``/``fp8``/``topk``) on the
paper's CIFAR-10 CNN over the planted-signal synthetic data, 4 clients,
B = 24, 10 rounds, through ``Trainer.run_compiled`` with the chunk equal to
the log cadence, and records (cumulative uplink wire bytes, top-1
accuracy) curves metered from the codec-aware CommProfile.  Keeps the JAX
script's claims as assertions: int8's uplink is 3.5-4.05x below fp32's
for every method, and the cheapest uplink of the sweep is CSE-FSL with a
codec.  Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig9_codec_tradeoff \\
        [--device cpu] [--smoke | --scale paper [--epochs 200]]

``--smoke`` runs 2 rounds of two methods under two codecs; ``--scale
paper`` the Table V budget (200 F-EMNIST epochs per method and h).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import accuracy, banner, save, table
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.models.cnn import CIFAR10, FEMNIST

ROUNDS = 10
BS = 24
N_CLIENTS = 4
CODECS = ("none", "int8", "fp8", "topk")
METHODS = (("fsl_mc", 1), ("fsl_oc", 1), ("fsl_an", 1), ("cse_fsl", 5))

# --scale paper: the Table V grid (hit CSE-FSL at both upload periods)
PAPER_METHODS = (("fsl_mc", 1), ("fsl_oc", 1), ("fsl_an", 1),
                 ("cse_fsl", 5), ("cse_fsl", 10))
PAPER_BS = 20
PAPER_D_LOCAL = 600             # F-EMNIST samples per client (per writer)


def run_one(bundle, cfg, fed, test, cm, method: str, h: int, codec: str,
            rounds: int, bs=BS, lr=0.15, seed=0, state=None):
    """One (method, codec) curve: ``[{"round", "uplink_bytes",
    "wire_bytes", "acc"}]`` at a third of the rounds.  ``state`` (default
    ``trainer.init(seed)``) is the initial state."""
    fsl = FSLConfig(num_clients=fed.num_clients, h=h, lr=lr, method=method,
                    codec=codec,
                    grad_clip=1.0 if method == "fsl_oc" else 0.0)
    trainer = Trainer(bundle, fsl)
    meter = CommMeter()
    curve = []

    def record(rnd, m, state):
        curve.append({"round": rnd,
                      "uplink_bytes": meter.counts["uplink_smashed"],
                      "wire_bytes": meter.total,
                      "acc": accuracy(bundle, cfg,
                                      trainer.merged_params(state), *test)})

    cadence = max(rounds // 3, 1)
    trainer.run_compiled(trainer.init(seed) if state is None else state,
                         FederatedBatcher(fed, bs, h, seed=seed), rounds,
                         chunk=cadence, log_every=cadence, callback=record,
                         meter=meter, cost_model=cm)
    return curve


def main(device="cuda", rounds: int = ROUNDS, codecs=CODECS,
         methods=METHODS, *, cnn=CIFAR10, n_clients=N_CLIENTS, bs=BS,
         samples=1200, lr=0.15, rounds_for=None,
         tag="torch_fig9_codec_tradeoff"):
    """``rounds_for(h) -> rounds`` pins a fixed *batch* budget across
    methods with different upload periods (the paper-scale preset);
    default: the same ``rounds`` for everyone."""
    rounds_for = rounds_for or (lambda h: rounds)
    bundle = cnn_bundle(cnn, device=device)
    x, y = synthetic_classification(samples, cnn.in_shape, cnn.num_classes,
                                    signal=12.0)
    xt, yt = synthetic_classification(max(samples // 3, 400), cnn.in_shape,
                                      cnn.num_classes, seed=99, signal=12.0)
    fed = partition_iid(x, y, n_clients)
    cm = CostModel(n=n_clients, q=bundle.smashed_bytes_per_sample,
                   d_local=len(x) // n_clients,
                   w_client=bytes_of(bundle.specs["client"]),
                   w_server=bytes_of(bundle.specs["server"]),
                   aux=bytes_of(bundle.specs["aux"]))

    out, rows = {}, []
    for method, h in methods:
        for codec in codecs:
            curve = run_one(bundle, cnn, fed, (xt, yt), cm, method, h,
                            codec, rounds_for(h), bs=bs, lr=lr)
            out[f"{method}_h{h}/{codec}"] = curve
            last = curve[-1]
            rows.append({"method": f"{method}(h={h})", "codec": codec,
                         "acc": round(last["acc"], 3),
                         "uplink_MiB": round(last["uplink_bytes"] / 2**20,
                                             3)})
    banner(f"Fig 9 — accuracy vs cumulative uplink wire bytes "
           f"({cnn.name}, {n_clients} clients; {bundle.device})")
    table(rows, ["method", "codec", "acc", "uplink_MiB"])
    # written before the claims are asserted, so a failed claim keeps its
    # curves
    save(tag, {**out, "device": str(bundle.device)})

    # int8 uplink is ~4x below fp32 for every method (exact wire metering)
    by = {(r["method"], r["codec"]): r for r in rows}
    if "none" in codecs and "int8" in codecs:
        for method, h in methods:
            m = f"{method}(h={h})"
            ratio = by[(m, "none")]["uplink_MiB"] \
                / by[(m, "int8")]["uplink_MiB"]
            assert 3.5 < ratio <= 4.05, (m, ratio)
    # the h-lever and the codec lever compose: cse_fsl with a codec has the
    # smallest uplink of the sweep
    cheapest = min(rows, key=lambda r: r["uplink_MiB"])
    assert cheapest["method"].startswith("cse_fsl"), cheapest
    assert cheapest["codec"] in ("int8", "fp8", "topk"), cheapest
    return out


def paper_main(device="cuda", epochs: int = 200, codecs=CODECS):
    """The codec x h frontier at the paper's Table V budget: every (method,
    h) trains ``epochs`` F-EMNIST epochs (synthetic F-EMNIST-shaped data:
    28x28x1, 62 classes, 600 samples a writer), i.e. ``epochs * 600 / (20
    h)`` global rounds, through the compiled chunk runner."""
    n = 5
    return main(
        device, codecs=codecs, methods=PAPER_METHODS, cnn=FEMNIST,
        n_clients=n, bs=PAPER_BS, samples=n * PAPER_D_LOCAL, lr=0.05,
        rounds_for=lambda h: max(epochs * PAPER_D_LOCAL // (PAPER_BS * h),
                                 1),
        tag="torch_fig9_codec_tradeoff_paper")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="2 rounds, 2 codecs")
    ap.add_argument("--scale", default="default",
                    choices=("default", "paper"),
                    help="paper: the 200-epoch F-EMNIST Table V budget")
    ap.add_argument("--epochs", type=int, default=200,
                    help="--scale paper epoch budget")
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args()
    if args.smoke:
        main(args.device, rounds=2, codecs=("none", "int8"),
             methods=(("cse_fsl", 2), ("fsl_an", 1)))
    elif args.scale == "paper":
        paper_main(args.device, epochs=args.epochs)
    else:
        main(args.device, rounds=args.rounds or ROUNDS)
