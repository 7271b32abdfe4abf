"""Paper Table II on the port: analytic communication and storage per
global epoch (``benchmarks/table2_comm_storage.py``).

Evaluates the Table II cost model with the byte sizes of the paper's
CIFAR-10 CNN and of a transformer config per family (qwen3-0.6b,
olmoe-1b-7b, falcon-mamba-7b: the JAX script's), across h in {1, 5, 10,
25, 50}, and asserts the paper's claim that CSE-FSL's uplink at period
h is FSL_AN's divided by h.  Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_comm_storage
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import banner, save, table
from repro_torch.common import bytes_of
from repro_torch.configs.registry import get_config
from repro_torch.core.accounting import (CostModel, comm_one_epoch,
                                         server_storage, total_storage)
from repro_torch.core.bundle import cnn_bundle, transformer_bundle
from repro_torch.models.cnn import CIFAR10

METHODS = ("fsl_mc", "fsl_oc", "fsl_an", "cse_fsl")
HS = (1, 5, 10, 25, 50)
ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "falcon-mamba-7b")


def cost_model_for(bundle, n: int, d_local: int, seq: int = 1) -> CostModel:
    return CostModel(n=n, q=bundle.smashed_bytes_per_sample * seq,
                     d_local=d_local,
                     w_client=bytes_of(bundle.specs["client"]),
                     w_server=bytes_of(bundle.specs["server"]),
                     aux=bytes_of(bundle.specs["aux"]))


def run_for(name: str, cm: CostModel):
    rows = []
    for method in METHODS:
        for h in (HS if method == "cse_fsl" else (1,)):
            c = comm_one_epoch(cm, method, h=h)
            rows.append({
                "method": method if method != "cse_fsl" else f"cse_fsl_h{h}",
                "uplink_MiB": round(c["uplink_smashed"] / 2 ** 20, 2),
                "downlink_MiB": round(c["downlink_grads"] / 2 ** 20, 2),
                "model_sync_MiB": round(c["model_sync"] / 2 ** 20, 2),
                "total_MiB": round(c["total"] / 2 ** 20, 2),
                "server_storage_MiB": round(
                    server_storage(cm, method) / 2 ** 20, 3),
                "total_storage_MiB": round(
                    total_storage(cm, method) / 2 ** 20, 3)})
    banner(f"Table II — {name} (n={cm.n}, |D_i|={cm.d_local}, q={cm.q}B)")
    table(rows, ["method", "uplink_MiB", "downlink_MiB", "model_sync_MiB",
                 "total_MiB", "server_storage_MiB", "total_storage_MiB"])
    return rows


def main(device="cuda"):
    out = {}
    # the paper's CIFAR-10 CNN: 5 clients, 10k samples each
    cm = cost_model_for(cnn_bundle(CIFAR10, device=device), n=5,
                        d_local=10_000)
    out["cifar10_cnn"] = run_for("cifar10_cnn (paper setup)", cm)
    an = comm_one_epoch(cm, "fsl_an")
    for h in HS:        # the paper's claim: CSE uplink at h == AN's / h
        cse = comm_one_epoch(cm, "cse_fsl", h=h)
        assert cse["uplink_smashed"] == an["uplink_smashed"] // h
    # a transformer per family (512 tokens a sample)
    for arch in ARCHS:
        cmx = cost_model_for(transformer_bundle(get_config(arch),
                                                device=device),
                             n=8, d_local=2_000, seq=512)
        out[arch] = run_for(arch, cmx)
    save("torch_table2_comm_storage", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the bundles (default: the card)")
    main(ap.parse_args().device)
