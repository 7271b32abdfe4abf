"""Paper Figs. 7 & 8 on the port: the auxiliary-network architecture sweep
(``benchmarks/fig78_aux_arch.py``).

CSE-FSL with the MLP aux head against 1x1-conv + MLP heads at fewer
channels, on the paper's CIFAR-10 (54 and 27 channels, h = 5) and F-EMNIST
(64 and 8 channels, h = 2) CNNs over the planted-signal synthetic data, 5
clients, B = 20, lr 0.05, 10 rounds each through ``Trainer.run_compiled``.
Keeps the JAX script's claim as an assertion: the 27-channel CNN aux ends
within 0.1 of the MLP's accuracy, read off a run under deterministic
algorithms (``common.deterministic``).  Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig78_aux_arch \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.benchmarks.common import (accuracy, banner, deterministic,
                                          save, table)
from repro_torch.common import count_params
from repro_torch.configs.base import FSLConfig
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.models.cnn import CIFAR10, FEMNIST

ROUNDS = 10


def run_variant(base_cfg, aux_kind: str, channels: int, h: int,
                rounds: int = ROUNDS, n: int = 5, seed: int = 0,
                device="cuda", state=None):
    """``(accuracy, aux params)`` of one aux head after ``rounds`` rounds;
    ``state`` (default ``trainer.init(seed)``) is the initial state."""
    cfg = dataclasses.replace(base_cfg, aux_kind=aux_kind,
                              aux_channels=channels)
    bundle = cnn_bundle(cfg, device=device)
    x, y = synthetic_classification(1200, cfg.in_shape, cfg.num_classes,
                                    signal=12.0)
    xt, yt = synthetic_classification(400, cfg.in_shape, cfg.num_classes,
                                      seed=99, signal=12.0)
    fed = partition_iid(x, y, n)
    trainer = Trainer(bundle, FSLConfig(num_clients=n, h=h, lr=0.05))
    state = trainer.init(seed) if state is None else state
    batcher = FederatedBatcher(fed, 20, h, seed=seed)
    state, _ = trainer.run_compiled(state, batcher, rounds, chunk=rounds)
    merged = trainer.merged_params(state)
    return accuracy(bundle, cfg, merged, xt, yt), count_params(merged["aux"])


def sweep(base_cfg, name: str, channel_list, h: int, device="cuda"):
    rows = []
    acc, ap = run_variant(base_cfg, "mlp", base_cfg.aux_channels, h,
                          device=device)
    rows.append({"aux": "MLP", "aux_params": ap, "acc": round(acc, 4)})
    for ch in channel_list:
        acc, ap = run_variant(base_cfg, "conv1x1", ch, h, device=device)
        rows.append({"aux": f"CNN+MLP({ch}ch)", "aux_params": ap,
                     "acc": round(acc, 4)})
    banner(f"Fig 7/8 — aux architecture sweep ({name}, h={h}; {device})")
    table(rows, ["aux", "aux_params", "acc"])
    return rows


@deterministic()
def main(device="cuda"):
    out = {
        "cifar10_h5": sweep(CIFAR10, "CIFAR-10", (54, 27), 5, device),
        "femnist_h2": sweep(FEMNIST, "F-EMNIST", (64, 8), 2, device),
    }
    # the paper's claim: the half-size CNN aux stays within the MLP's band
    mlp = out["cifar10_h5"][0]["acc"]
    cnn27 = [r for r in out["cifar10_h5"] if "27ch" in r["aux"]][0]["acc"]
    assert cnn27 > mlp - 0.1, (mlp, cnn27)
    save("torch_fig78_aux_arch", {**out, "device": str(device)})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    main(ap.parse_args().device)
