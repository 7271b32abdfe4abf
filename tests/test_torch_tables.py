"""The port's paper-table scripts (``repro_torch.benchmarks``): Table II's
rows equal the JAX script's, byte for byte, for the CNN and the ported
transformer families; Table V runs every method through ``Trainer.run``
on the CPU and its own claims hold (a short round budget here; the card
runs the full one)."""
from pathlib import Path

import pytest

from repro.configs.registry import get_config as jget_config
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.models.cnn import CIFAR10 as JCIFAR10
from repro_torch.benchmarks import common, table2_comm_storage, \
    table5_tradeoff
from repro_torch.configs.registry import get_config
from repro_torch.core.bundle import cnn_bundle, transformer_bundle
from repro_torch.models.cnn import CIFAR10

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def jtable2(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import table2_comm_storage as jt2
    return jt2


@pytest.mark.parametrize("arch", ["cnn"] + list(table2_comm_storage.ARCHS))
def test_table2_rows_match_reference(arch, jtable2):
    if arch == "cnn":
        kw = dict(n=5, d_local=10_000)
        jb, b = jcnn_bundle(JCIFAR10), cnn_bundle(CIFAR10, device="cpu")
    else:
        kw = dict(n=8, d_local=2_000, seq=512)
        jb = jtransformer_bundle(jget_config(arch))
        b = transformer_bundle(get_config(arch), device="cpu")
    jcm = jtable2.cost_model_for(jb, **kw)
    cm = table2_comm_storage.cost_model_for(b, **kw)
    assert vars(cm) == vars(jcm)
    assert table2_comm_storage.run_for(arch, cm) \
        == jtable2.run_for(arch, jcm)


def test_table5_runs_every_method_and_its_claims_hold(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    rows = table5_tradeoff.main(device="cpu", rounds=2)
    assert [r["method"] for r in rows] == ["fsl_mc", "fsl_oc", "fsl_an",
                                           "cse_fsl_h5", "cse_fsl_h10"]
    assert [r["batches"] for r in rows] == [2, 2, 2, 10, 20]
    assert all(0.0 <= r["acc"] <= 1.0 for r in rows)
    assert (tmp_path / "torch_table5_tradeoff.json").exists()
