"""Quickstart: CSE-FSL in ~50 lines.

Trains the paper's CIFAR-10 split CNN with the CSE-FSL protocol (auxiliary
head + h-periodic smashed upload + single server model) on synthetic data,
printing loss and the Table II communication meter.  Swap ``method=`` in
the FSLConfig for any registered method ("fsl_mc", "fsl_oc", "fsl_an"):
the Trainer, metering and evaluation code below stay identical.

  python -m repro_torch.examples.quickstart [--device cpu] [--rounds 10]
"""
import argparse

from repro_torch.benchmarks.common import accuracy
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.models.cnn import CIFAR10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card)")
    args = ap.parse_args(argv)
    n_clients, h, batch = 4, 3, 16

    # 1. model bundle: client stage | aux head | server stage
    bundle = cnn_bundle(CIFAR10, device=args.device)

    # 2. federated data (synthetic stand-in for CIFAR-10)
    x, y = synthetic_classification(1000, CIFAR10.in_shape, 10, signal=12.0)
    fed = partition_iid(x, y, n_clients)
    batcher = FederatedBatcher(fed, batch, h)

    # 3. the protocol: h local steps per round, single server model
    fsl = FSLConfig(num_clients=n_clients, h=h, lr=0.15,  # paper CIFAR-10 lr
                    method="cse_fsl")
    trainer = Trainer(bundle, fsl)
    state = trainer.init(seed=0)

    # 4. Table II communication meter, driven by the method's CommProfile
    pa = bundle.specs                   # shapes only (meta tensors)
    cm = CostModel(n=n_clients, q=bundle.smashed_bytes_per_sample,
                   d_local=len(x) // n_clients,
                   w_client=bytes_of(pa["client"]),
                   w_server=bytes_of(pa["server"]), aux=bytes_of(pa["aux"]))
    meter = CommMeter()

    def report(rnd, m, _state):
        print(f"round {rnd:3d}  client_loss={m['client_loss']:.4f}  "
              f"server_loss={m['server_loss']:.4f}  "
              f"comm={meter.total / 2 ** 20:.1f} MiB")

    state, history = trainer.run(state, batcher, args.rounds, log_every=2,
                                 callback=report, meter=meter, cost_model=cm)

    # 5. the deployed model = aggregated client stage + server stage
    params = trainer.merged_params(state)
    xt, yt = synthetic_classification(400, CIFAR10.in_shape, 10, seed=9,
                                      signal=12.0)
    acc = accuracy(bundle, CIFAR10, params, xt, yt)
    print(f"\nfinal top-1 accuracy: {acc:.3f} "
          f"(chance = 0.100); total comm {meter.total / 2 ** 20:.1f} MiB")
    return acc, history, meter


if __name__ == "__main__":
    main()
