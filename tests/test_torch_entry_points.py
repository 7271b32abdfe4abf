"""The port's entry points besides the CLI: the examples
(``repro_torch.examples``), ``perf_bench`` and the ``run`` driver, at tiny
settings with ``--device cpu``.

- ``quickstart`` trains the CIFAR-10 CNN a round and reports accuracy and
  the Table II meter; ``async_sim`` runs the event engine under two
  latency seeds; ``train_federated_lm`` runs its ~100M model's recipe on
  reduced Qwen3 (the test swaps the width for the CPU) and its loss falls;
  the ~100M config's parameter count equals the JAX example's (meta
  tensors, nothing drawn).
- ``run --only perf_bench --smoke --device cpu`` runs perf_bench and
  writes ``torch_perf_bench.json``; its rows carry the JAX driver's keys
  except ``chunk_fingerprint`` (the port has no R001 fingerprint yet).
  The two bars are claims about the card (held there by
  ``chip_smoke.py``), so this CPU run sets the environment overrides the
  driver documents to 0.
- ``run`` exits non-zero when a suite fails and names it.
- The isolation test scans every module this slice adds.
"""
import ast
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.common import count_params
from repro.models.model import abstract_params as jabstract_params
from repro_torch.benchmarks import common as bench_common
from repro_torch.benchmarks import run as run_mod
from repro_torch.common import tree_leaves
from repro_torch.configs.registry import get_config
from repro_torch.examples import async_sim, quickstart, train_federated_lm
from repro_torch.models.model import abstract_params

ROOT = Path(__file__).resolve().parents[1]
NEW_MODULES = ("launch/train.py", "launch/serve.py", "examples/__init__.py",
               "examples/quickstart.py", "examples/train_federated_lm.py",
               "examples/async_sim.py", "benchmarks/perf_bench.py",
               "benchmarks/run.py", "configs/glm4_9b.py",
               "configs/qwen2_1_5b.py", "configs/qwen2_72b.py")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_quickstart():
    acc, hist, meter = quickstart.main(["--device", "cpu", "--rounds", "2"])
    assert 0.0 <= acc <= 1.0 and len(hist) == 1
    assert np.isfinite(hist[0]["client_loss"])
    assert meter.counts["uplink_smashed"] > 0


def test_async_sim():
    acc1, acc2, hist, stats = async_sim.main(
        ["--device", "cpu", "--rounds", "1", "--clients", "2", "--h", "1"])
    assert np.isfinite(acc1) and np.isfinite(acc2) and len(hist) == 1
    s = stats.as_dict()
    assert s["events"] == 2 and s["async_time"] <= s["sync_time"]


def test_train_federated_lm(monkeypatch):
    """The example's recipe on reduced Qwen3 (kernels on: their plain
    versions here): 3 rounds of 2 clients at h 2, the loss falls, as the
    example asserts."""
    cfg = train_federated_lm.build_100m_config()
    want = count_params(jabstract_params(cfg))
    assert sum(t.numel() for t in tree_leaves(abstract_params(cfg))) == want
    assert cfg.use_pallas and 90e6 < want < 130e6
    monkeypatch.setattr(
        train_federated_lm, "build_100m_config",
        lambda: get_config("qwen3-0.6b").reduced().with_(use_pallas=True))
    hist, meter = train_federated_lm.main(
        ["--device", "cpu", "--rounds", "3", "--clients", "2", "--h", "2",
         "--batch", "1", "--seq", "16"])
    assert hist[-1]["client_loss"] < hist[0]["client_loss"]
    assert meter.counts["model_sync"] > 0


def _reference_row_keys():
    """The keys of the dict the JAX ``bench_one`` returns (read with
    ``ast``: running it needs its R001 fingerprint)."""
    tree = ast.parse((ROOT / "benchmarks" / "perf_bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "bench_one")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)
           and isinstance(n.value, ast.Dict)]
    assert len(ret) == 1
    return {k.value for k in ret[0].value.keys}


def test_run_perf_bench_smoke(monkeypatch, tmp_path):
    monkeypatch.setattr(bench_common, "OUT_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_PERF_MIN_SPEEDUP", "0")
    monkeypatch.setenv("REPRO_TELEMETRY_MIN_RATIO", "0")
    assert run_mod.main(["--only", "perf_bench", "--smoke", "--device",
                         "cpu"]) == 0
    with open(tmp_path / "torch_perf_bench.json") as f:
        out = json.load(f)
    assert out["backend"] == "cpu"
    rows = out["rows"]
    assert [r["method"] for r in rows] == ["cse_fsl", "fsl_mc", "fsl_oc",
                                           "fsl_an"]
    assert _reference_row_keys() - set(rows[0]) == {"chunk_fingerprint"}
    assert set(rows[0]) <= _reference_row_keys()
    for r in rows:
        assert r["rounds"] == 80 and r["chunk"] == 20 and r["h"] == 1
        assert r["loop_steps_per_s"] > 0 and r["compiled_steps_per_s"] > 0
    assert out["telemetry_overhead"]["telemetry_overhead_ratio"] > 0


def test_run_reports_a_failing_suite(monkeypatch, capsys):
    def boom(device="cuda"):
        raise RuntimeError("boom")
    monkeypatch.setattr(run_mod, "SUITES", run_mod.SUITES[:1]
                        + [("boom", boom)])
    assert run_mod.main(["--only", "boom", "--device", "cpu"]) == 1
    assert "failed: ['boom']" in capsys.readouterr().out


def test_run_table34(monkeypatch, tmp_path):
    monkeypatch.setattr(bench_common, "OUT_DIR", str(tmp_path))
    assert run_mod.main(["--only", "table34_aux_params", "--device",
                         "cpu"]) == 0
    assert {name for name, _ in run_mod.SUITES} >= {
        "perf_bench", "fig_population", "table2_comm_storage"}


def test_isolation_covers_the_new_modules():
    spec = importlib.util.spec_from_file_location(
        "torch_isolation", ROOT / "tests" / "test_torch_isolation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    scanned = set(mod.PORT_FILES)
    for rel in NEW_MODULES:
        path = ROOT / "src" / "repro_torch" / rel
        assert path in scanned, rel
        mod.test_no_jax_or_reference_imports(path)
    assert os.path.exists(ROOT / "src" / "repro_torch" / "examples")
