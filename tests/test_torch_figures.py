"""The port's figure scripts (``repro_torch.benchmarks``) against the JAX
package's (``benchmarks/``): each script's unit function run on both sides
at a cut size, the port's from the reference's initial state carried
across by ``repro_torch.convert`` (the unit's ``state=`` argument), both
on the same synthetic data (the port's numpy generators are bitwise the
reference's).

- fig45 ``run_method``: FSL_OC (clipped) at h = 1 and CSE-FSL at h = 5, 2
  clients, 6 rounds (one logged point: the script logs every 6 rounds),
  240 training and 100 test samples of the full CIFAR-10 CNN;
- fig9 ``run_one``: FSL_AN with the ``topk`` uplink and CSE-FSL h = 2 with
  none, 3 rounds (a point a round) on a narrow CNN;
- fig78 ``run_variant``: the 27-channel conv1x1 aux at h = 2, 2 rounds, on
  a narrow CNN (the script's own 1,200 / 400 samples);
- table34: every row, exactly;
- fig_faults ``run_one`` and ``expected_lossy_bytes``: the lossy wire and
  the crashy clients, 3 rounds of the script's own model and data.

Tolerances: curves' losses at rtol 1e-4 (fp32 sums in other orders,
as ``test_torch_cse_fsl.py`` holds the training loop); accuracies within
one test sample of the reference's (an argmax may flip on a near tie
after such a difference); metered bytes, fault statistics, the
trace-derived byte expectation and the wall-clock estimate exactly.  The
scripts' ``main`` runs on the CPU (``device="cpu"``) in the cheapest of
them here; the card runs every ``main`` at its own settings
(``chip_smoke.py`` phase 23).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.data import partition_iid as jpartition_iid
from repro.data import synthetic_classification as jsynthetic
from repro.models.cnn import CIFAR10 as JCIFAR10
from repro.models.cnn import CNNConfig as JCNNConfig
from repro_torch.benchmarks import (common, fig9_codec_tradeoff,
                                    fig45_convergence, fig78_aux_arch,
                                    fig_faults, table34_aux_params)
from repro_torch.common import bytes_of
from repro_torch.convert import state_from_numpy
from repro_torch.core.accounting import CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.data import partition_iid, synthetic_classification
from repro_torch.models.cnn import CIFAR10, CNNConfig

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jbench(monkeypatch):
    """The JAX package's scripts (``benchmarks/`` at the repo root)."""
    monkeypatch.syspath_prepend(str(ROOT))
    import importlib
    return lambda name: importlib.import_module(f"benchmarks.{name}")


def _state0(jb, jfsl, method="cse_fsl", **kw):
    """The reference's ``Trainer.init(0)`` of the script's setup, in the
    port's layout on the CPU."""
    jstate = JTrainer(jb, jfsl, donate=False, **kw).init(0)
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                            device="cpu", method=method)


def _data(shape, classes, n, samples, test):
    """Both packages' partitions and test sets from their own generators."""
    x, y = synthetic_classification(samples, shape, classes, signal=12.0)
    xt, yt = synthetic_classification(test, shape, classes, seed=99,
                                      signal=12.0)
    jx, jy = jsynthetic(samples, shape, classes, signal=12.0)
    jxt, jyt = jsynthetic(test, shape, classes, seed=99, signal=12.0)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(xt, jxt)
    return (partition_iid(x, y, n), (xt, yt)), \
        (jpartition_iid(jx, jy, n), (jxt, jyt))


def _close_curves(got, want, n_test, keys=("loss",), exact=()):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        assert abs(g["acc"] - w["acc"]) <= 1.0 / n_test + 1e-7, (g, w)
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        for k in exact:
            assert g[k] == w[k], k


@pytest.mark.parametrize("method,h", [("fsl_oc", 1), ("cse_fsl", 5)])
def test_fig45_run_method_matches_reference(jbench, method, h):
    jfig = jbench("fig45_convergence")
    n = 2
    (fed, test), (jfed, jtest) = _data(CIFAR10.in_shape, 10, n, 240, 100)
    jb = jcnn_bundle(JCIFAR10)
    state0 = _state0(jb, JFSLConfig(
        num_clients=n, h=h, lr=0.15, method=method,
        grad_clip=1.0 if method == "fsl_oc" else 0.0), method)
    want = jfig.run_method(jb, jfed, jtest, method, h, 6)
    got = fig45_convergence.run_method(cnn_bundle(CIFAR10, device="cpu"),
                                       fed, test, method, h, 6,
                                       state=state0)
    _close_curves(got, want, 100)


@pytest.mark.parametrize("method,h,codec", [("fsl_an", 1, "topk"),
                                            ("cse_fsl", 2, "none")])
def test_fig9_run_one_matches_reference(jbench, method, h, codec):
    jfig = jbench("fig9_codec_tradeoff")
    n, bs = 3, 8
    (fed, test), (jfed, jtest) = _data(NARROW["in_shape"], 10, n, 144, 60)
    jcfg, cfg = JCNNConfig(**NARROW), CNNConfig(**NARROW)
    jb, b = jcnn_bundle(jcfg), cnn_bundle(cfg, device="cpu")
    pa = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    jcm = JCostModel(n=n, q=jb.smashed_bytes_per_sample, d_local=48,
                     w_client=jbytes_of(pa["client"]),
                     w_server=jbytes_of(pa["server"]),
                     aux=jbytes_of(pa["aux"]))
    cm = CostModel(n=n, q=b.smashed_bytes_per_sample, d_local=48,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    assert vars(cm) == vars(jcm)
    state0 = _state0(jb, JFSLConfig(num_clients=n, h=h, lr=0.15,
                                    method=method, codec=codec), method)
    want = jfig.run_one(jb, jcfg, jfed, jtest, jcm, method, h, codec, 3,
                        bs=bs)
    got = fig9_codec_tradeoff.run_one(b, cfg, fed, test, cm, method, h,
                                      codec, 3, bs=bs, state=state0)
    _close_curves(got, want, 60, keys=(),
                  exact=("uplink_bytes", "wire_bytes"))


def test_fig78_run_variant_matches_reference(jbench):
    jfig = jbench("fig78_aux_arch")
    jcfg = JCNNConfig(**NARROW, aux_kind="conv1x1", aux_channels=27)
    jstate = _state0(jcnn_bundle(jcfg), JFSLConfig(num_clients=5, h=2,
                                                   lr=0.05))
    jacc, jap = jfig.run_variant(JCNNConfig(**NARROW), "conv1x1", 27, 2,
                                 rounds=2)
    acc, ap = fig78_aux_arch.run_variant(CNNConfig(**NARROW), "conv1x1", 27,
                                         2, rounds=2, device="cpu",
                                         state=jstate)
    assert ap == jap
    assert abs(acc - jacc) <= 1.0 / 400 + 1e-7, (acc, jacc)


def test_table34_rows_equal_reference(jbench, tmp_path, monkeypatch):
    jt = jbench("table34_aux_params")
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    out = table34_aux_params.main()
    assert out["cifar10"] == jt.cnn_table(JCIFAR10, "CIFAR-10",
                                          (54, 27, 14, 7))
    from repro.models.cnn import FEMNIST as JFEMNIST
    assert out["femnist"] == jt.cnn_table(JFEMNIST, "F-EMNIST",
                                          (64, 32, 8, 2))
    jrows = {r["arch"]: r for r in jt.transformer_table()}
    assert [r["arch"] for r in out["transformers"]] == [
        "zamba2-7b", "olmoe-1b-7b", "qwen3-0.6b", "qwen2-72b",
        "qwen2-vl-72b", "falcon-mamba-7b", "qwen2-1.5b", "glm4-9b",
        "phi3.5-moe-42b-a6.6b", "hubert-xlarge"]
    for r in out["transformers"]:
        assert r == jrows[r["arch"]]
    assert (tmp_path / "torch_table34_aux_params.json").exists()


@pytest.mark.parametrize("model", ["lossy", "crashy"])
def test_fig_faults_run_one_matches_reference(jbench, model):
    jfig = jbench("fig_faults")
    rounds = 3
    fm = next(f for f in fig_faults.fault_grid(True) if f.name == model)
    jfm = next(f for f in jfig.fault_grid(True) if f.name == model)
    (fed, test), (jfed, jtest) = _data(fig_faults.MODEL.in_shape, 10,
                                       fig_faults.N_CLIENTS, 1200, 300)
    jb = jcnn_bundle(jfig.MODEL)
    state0 = _state0(jb, JFSLConfig(num_clients=fig_faults.N_CLIENTS,
                                    h=fig_faults.H, lr=0.15), faults=jfm)
    want = jfig.run_one(jb, jfed, jtest, jfm, rounds)
    got = fig_faults.run_one(cnn_bundle(fig_faults.MODEL, device="cpu"),
                             fed, test, fm, rounds, state=state0)
    assert dict(got["meter"].counts) == dict(want["meter"].counts)
    assert got["faults"] == want["faults"]
    assert got["wallclock_s"] == want["wallclock_s"]
    assert abs(got["acc"] - want["acc"]) <= 1.0 / 300 + 1e-7
    expect = fig_faults.expected_lossy_bytes(got["trainer"], fm, rounds,
                                             got["meter"])
    assert expect == jfig.expected_lossy_bytes(want["trainer"], jfm, rounds,
                                               want["meter"])
    if model == "lossy":       # the script's claim 1, to the byte
        for kind in ("uplink_smashed", "uplink_labels", "fault_frames"):
            assert got["meter"].counts[kind] == expect[kind]
        assert got["faults"]["retransmit_bytes"] == expect["retransmit_bytes"]


def test_fig_faults_main_runs_its_claims_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    rows = fig_faults.main(device="cpu", rounds=4, smoke=True)
    assert [r["faults"] for r in rows] == ["none", "lossy", "crashy"]
    assert (tmp_path / "torch_fig_faults.json").exists()


@pytest.mark.parametrize("before", [(False, False), (True, False),
                                    (True, True)])
def test_deterministic_sets_and_restores(before):
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    try:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = False
        with pytest.raises(ValueError):
            with common.deterministic():
                assert torch.are_deterministic_algorithms_enabled()
                assert torch.is_deterministic_algorithms_warn_only_enabled()
                assert torch.backends.cudnn.deterministic
                raise ValueError
        assert (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                torch.backends.cudnn.deterministic) == (*before, False)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic = was[2]


def test_fig45_main_trains_under_deterministic_algorithms(tmp_path,
                                                          monkeypatch):
    """Every run of fig45's main is under ``common.deterministic``: its
    claims compare accuracies near chance."""
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    seen = []

    def run_method(*a, **kw):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return [{"round": 2, "acc": 0.5, "loss": 2.0}]

    monkeypatch.setattr(fig45_convergence, "run_method", run_method)
    was = torch.are_deterministic_algorithms_enabled()
    fig45_convergence.main(device="cpu", rounds=2)
    assert seen == [True] * 10
    assert torch.are_deterministic_algorithms_enabled() == was
