"""Paper Tables III & IV on the port: auxiliary-network parameter counts
(``benchmarks/table34_aux_params.py``).

The MLP against the CNN(1x1) + MLP aux heads of the paper's CIFAR-10 and
F-EMNIST models, and the low-rank aux heads of the transformer archs in
the port's registry.  Every count comes from the parameters' shapes on the
``meta`` device (``models.cnn.stages``, ``models.model.param_specs``):
nothing is allocated, so the script needs no device.  Keeps the JAX
script's claims as assertions: the CIFAR-10 MLP aux has 20k-30k params,
1.5-3 % of the model, and the 27-channel CNN aux fewer than 0.6 of the
MLP's.  Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.table34_aux_params
"""
from __future__ import annotations

import dataclasses

from repro_torch.benchmarks.common import banner, save, table
from repro_torch.common import count_params
from repro_torch.configs.registry import arch_names, get_config
from repro_torch.models.cnn import CIFAR10, FEMNIST, stages
from repro_torch.models.model import param_specs


def _counts(cfg):
    st = stages(cfg)
    return tuple(sum(p.numel() for p in st[k].parameters())
                 for k in ("client", "aux", "server"))


def cnn_table(base, name: str, channels):
    rows = []
    for kind, ch in [("mlp", None)] + [("conv1x1", c) for c in channels]:
        cfg = dataclasses.replace(base, aux_kind=kind,
                                  aux_channels=ch or base.aux_channels)
        c, a, s = _counts(cfg)
        rows.append({
            "aux": "MLP" if kind == "mlp" else f"CNN+MLP({ch}ch)",
            "aux_params": a,
            "client_params": c,
            "pct_of_model": round(100 * a / (c + a + s), 2),
        })
    banner(f"Table III/IV — auxiliary networks ({name})")
    table(rows, ["aux", "aux_params", "client_params", "pct_of_model"])
    return rows


def transformer_table():
    rows = []
    for arch in arch_names():
        cfg = get_config(arch)
        p = param_specs(cfg)
        c = count_params(p["client"])
        a = count_params(p["aux"])
        s = count_params(p["server"])
        rows.append({
            "arch": arch,
            "aux_kind": f"{cfg.aux_kind}(r={cfg.aux_rank})",
            "aux_params": a,
            "pct_of_model": round(100 * a / (c + a + s), 3),
            "pct_of_client": round(100 * a / c, 2),
        })
    banner("Low-rank aux heads for the port's archs (beyond-paper)")
    table(rows, ["arch", "aux_kind", "aux_params", "pct_of_model",
                 "pct_of_client"])
    return rows


def main():
    out = {
        "cifar10": cnn_table(CIFAR10, "CIFAR-10", (54, 27, 14, 7)),
        "femnist": cnn_table(FEMNIST, "F-EMNIST", (64, 32, 8, 2)),
        "transformers": transformer_table(),
    }
    # the paper's claim: CIFAR-10 MLP aux ~= 23k params ~= 2.16% of the model
    mlp = out["cifar10"][0]
    assert 20_000 < mlp["aux_params"] < 30_000, mlp
    assert 1.5 < mlp["pct_of_model"] < 3.0, mlp
    # CNN(27ch) roughly halves the MLP aux (paper: 11,485 vs 23,050)
    cnn27 = [r for r in out["cifar10"] if "27ch" in r["aux"]][0]
    assert cnn27["aux_params"] < 0.6 * mlp["aux_params"]
    save("torch_table34_aux_params", out)
    return out


if __name__ == "__main__":
    main()
