"""Paper Table V / Fig. 9 on the port: accuracy x communication load x
storage (``benchmarks/table5_tradeoff.py``).

Runs every method for a fixed round budget on the paper's CIFAR-10 CNN
through ``Trainer.run_compiled``, as the JAX script does (the compiled
runner is bitwise equal to ``Trainer.run`` on the CPU; on the card each
round is a CUDA-graph replay), meters the communication from each
method's CommProfile and reports its Table II storage, then asserts the
paper's claims: CSE-FSL stores less than FSL_AN and FSL_MC, and per
trained batch communicates less than half of FSL_AN's load, less again at
a longer period.  Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.table5_tradeoff
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
from repro_torch.models.cnn import CIFAR10

N, BS, ROUNDS = 5, 24, 8


def main(device="cuda", rounds: int = ROUNDS):
    bundle = cnn_bundle(CIFAR10, device=device)
    x, y = synthetic_classification(1500, CIFAR10.in_shape, 10, signal=12.0)
    xt, yt = synthetic_classification(500, CIFAR10.in_shape, 10, seed=99,
                                      signal=12.0)
    fed = partition_iid(x, y, N)
    cm = CostModel(n=N, q=bundle.smashed_bytes_per_sample,
                   d_local=len(x) // N,
                   w_client=bytes_of(bundle.specs["client"]),
                   w_server=bytes_of(bundle.specs["server"]),
                   aux=bytes_of(bundle.specs["aux"]))
    rows = []

    def run(method: str, h: int):
        fsl = FSLConfig(num_clients=N, h=h, lr=0.05, method=method,
                        lr_decay=1.0,
                        grad_clip=1.0 if method == "fsl_oc" else 0.0)
        trainer = Trainer(bundle, fsl)
        meter = CommMeter()
        state, _ = trainer.run_compiled(trainer.init(), FederatedBatcher(
            fed, BS, h, seed=0), rounds, chunk=rounds, meter=meter,
            cost_model=cm)
        acc = accuracy(bundle, CIFAR10, trainer.merged_params(state), xt,
                       yt)
        profile = trainer.comm_profile(cm, BS)
        label = f"cse_fsl_h{h}" if method == "cse_fsl" else method
        rows.append({"method": label, "acc": round(acc, 4),
                     "batches": rounds * h,
                     "load_MiB": round(meter.total / 2 ** 20, 2),
                     "load_per_batch_MiB": round(
                         meter.total / 2 ** 20 / (rounds * h), 3),
                     "storage_Mparams": round(
                         profile.total_storage / 4 / 1e6, 3)})

    for method in ("fsl_mc", "fsl_oc", "fsl_an"):
        run(method, h=1)
    for h in (5, 10):
        run("cse_fsl", h=h)

    banner(f"Table V — accuracy / load / storage ({rounds} rounds, {N} "
           f"clients; CSE trains h batches per round; {bundle.device})")
    table(rows, ["method", "acc", "batches", "load_MiB",
                 "load_per_batch_MiB", "storage_Mparams"])
    by = {r["method"]: r for r in rows}
    # Table V's claims: CSE stores less than FSL_AN and FSL_MC; per unit of
    # training, CSE's communication is a fraction of FSL_AN's
    assert by["cse_fsl_h5"]["storage_Mparams"] \
        < by["fsl_an"]["storage_Mparams"]
    assert by["cse_fsl_h5"]["storage_Mparams"] \
        < by["fsl_mc"]["storage_Mparams"]
    assert by["cse_fsl_h5"]["load_per_batch_MiB"] \
        < 0.5 * by["fsl_an"]["load_per_batch_MiB"]
    assert by["cse_fsl_h10"]["load_per_batch_MiB"] \
        < by["cse_fsl_h5"]["load_per_batch_MiB"]
    save("torch_table5_tradeoff", {"rows": rows, "device": str(bundle.device)})
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    main(args.device, args.rounds)
