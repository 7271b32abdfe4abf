"""The port's training CLI (``python -m repro_torch.launch.train``) against
the JAX package's (``python -m repro.launch.train``).

Both run reduced Qwen3-0.6B (bf16, as ``--size reduced`` gives it) at the
same flags with ``--out``, three ways: the per-round loop (``--chunk 0``);
``--chunk 2`` under ``--scheduler deadline --faults lossy --network
tiered``; and ``--population 1000 --cohort 2 --sampler stratified
--network tiered`` (the port also with ``--mesh host``, one device: the
run without a mesh).  The reference's CLI is called in-process with a
patched ``sys.argv``; the port's ``main([... "--device", "cpu"])`` starts
from the reference's initial state, converted (``repro_torch.convert``)
and patched into ``Trainer.init`` / ``Population.init`` by the test.

The ``--out`` JSON: ``comm``, ``participation``, ``faults``,
``population``, ``memory``, ``wallclock`` and the flat ``record``
exactly; the ``args`` keys (the port adds ``device``); the rows' host
columns exactly and their losses at rtol 2e-2: the port runs its kernel
ops' plain versions (``use_pallas=True``), the reference its plain path,
both in bf16, so a loss moves by a few bf16 ulps of the activations.
The port's ``--telemetry/--trace/--prom`` files pass its validators;
``--profile-dir`` writes a Chrome trace; without ``--device cpu`` and
with no card the CLI exits with the no-card message.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.launch import train as jtrain
from repro_torch.convert import state_from_numpy
from repro_torch.core.trainer import Trainer
from repro_torch.launch import train
from repro_torch.population import Population
from repro_torch.telemetry import validate_record

COMMON = ["--size", "reduced", "--rounds", "2", "--clients", "2", "--h",
          "2", "--batch", "1", "--seq", "16", "--samples", "4",
          "--log-every", "1"]
RUNS = {
    "loop": ["--chunk", "0"],
    "sched": ["--chunk", "2", "--scheduler", "deadline", "--faults",
              "lossy", "--network", "tiered"],
    "population": ["--chunk", "2", "--population", "1000", "--cohort", "2",
                   "--sampler", "stratified", "--network", "tiered"],
}
PORT_ONLY = {"population": ["--mesh", "host"]}
HOST = ("comm", "participation", "faults", "population", "memory",
        "wallclock", "record")
EXACT = {"round", "aggregated", "comm_bytes", "participants",
         "dropped_updates", "fault_retries", "fault_drops"}
LOSS_RTOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX CLI's ``--out`` JSON of each run, and the initial state it
    trained from (its ``Trainer.init()`` at seed 0)."""
    d = tmp_path_factory.mktemp("ref")
    out = {}
    argv0 = sys.argv
    try:
        for name, extra in RUNS.items():
            path = str(d / f"{name}.json")
            sys.argv = ["train"] + COMMON + extra + ["--out", path]
            jtrain.main()
            with open(path) as f:
                out[name] = json.load(f)
    finally:
        sys.argv = argv0
    jcfg = jget_config("qwen3-0.6b").reduced()
    jtr = JTrainer(jtransformer_bundle(jcfg),
                   JFSLConfig(num_clients=2, h=2, lr=0.1), donate=False)
    out["init"] = jax.tree_util.tree_map(np.asarray, jtr.init(0))
    return out


def _from_reference(monkeypatch, init):
    """The port's Trainer and Population start from ``init``."""
    monkeypatch.setattr(Trainer, "init", lambda self, seed=0:
                        state_from_numpy(init, device=self.device))
    orig = Population.init

    def pop_init(self, seed=0, state=None):
        return orig(self, seed=seed,
                    state=state_from_numpy(init, device=self.trainer.device))
    monkeypatch.setattr(Population, "init", pop_init)


def _port(name, tmp_path, extra=()):
    path = str(tmp_path / f"{name}.json")
    train.main(COMMON + RUNS[name] + PORT_ONLY.get(name, [])
               + list(extra) + ["--out", path, "--device", "cpu"])
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(RUNS))
def test_out_json_matches_reference(name, reference, monkeypatch, tmp_path):
    _from_reference(monkeypatch, reference["init"])
    got, want = _port(name, tmp_path), reference[name]
    assert set(got) == set(want)
    assert set(got["args"]) - {"device"} == set(want["args"])
    assert got["args"]["device"] == "cpu"
    for key in HOST:
        assert got[key] == want[key], key
    assert len(got["history"]) == len(want["history"]) == 2
    for row, jrow in zip(got["history"], want["history"]):
        assert set(row) == set(jrow)
        for k in set(row) & EXACT:
            assert row[k] == jrow[k], (row["round"], k)
        for k in set(row) - EXACT:
            np.testing.assert_allclose(row[k], jrow[k], rtol=LOSS_RTOL,
                                       err_msg=f"round {row['round']} {k}")
    if name == "sched":
        assert got["faults"] is not None and got["wallclock"] is not None
    if name == "population":
        assert got["population"]["windows"] == 2
        assert got["memory"]["population"] == 1000


def test_telemetry_files_pass_the_validators(tmp_path):
    """``--telemetry``, ``--trace`` and ``--prom`` on the compiled runner:
    every JSONL line a valid record (a round record a round, then the run
    summary), a Chrome trace-event file, Prometheus text."""
    paths = {k: str(tmp_path / f"t.{k}") for k in ("jsonl", "json", "prom")}
    _, hist = train.main(COMMON + ["--chunk", "2", "--device", "cpu",
                                   "--telemetry", paths["jsonl"],
                                   "--trace", paths["json"],
                                   "--prom", paths["prom"]])
    with open(paths["jsonl"]) as f:
        recs = [validate_record(json.loads(line)) for line in f]
    assert [r["round"] for r in recs if r["type"] == "round"] == [1, 2]
    assert recs[-1]["type"] == "summary"
    with open(paths["json"]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"chunk/build", "chunk/execute"} <= names
    with open(paths["prom"]) as f:
        prom = f.read()
    assert prom.startswith("#") and "repro_" in prom
    assert len(hist) == 2


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    train.main(COMMON + ["--rounds", "1", "--chunk", "0", "--device", "cpu",
                         "--profile-dir", d])
    with open(os.path.join(d, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_exits_with_the_message():
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        train.main(COMMON)


def test_population_refuses_a_barrier_scheduler():
    with pytest.raises(SystemExit):
        train.main(COMMON + ["--population", "100", "--scheduler",
                             "deadline", "--device", "cpu"])


def _reference_registries():
    """The JAX package's open registries that the JAX CLI's choices read:
    methods, codecs, network models, policies, fault models, cohort
    samplers."""
    from repro import transport as jtransport
    from repro.core.methods import base as jmethods
    from repro.faults import model as jfaults
    from repro.network import model as jnetwork
    from repro.sched import cohort as jcohort
    from repro.sched import policy as jpolicy
    return (jmethods._REGISTRY, jtransport._CODECS, jnetwork.NETWORK_MODELS,
            jpolicy._POLICIES, jfaults.FAULT_MODELS, jcohort.COHORT_SAMPLERS)


def _own_entries_only(monkeypatch):
    """Each reference registry limited, for the test, to the entries the
    ``repro`` package defines: other test files register their own (e.g.
    ``tests/test_sched.py``'s ``test_odd_rounds`` policy), which stay in
    the process for the rest of a pytest worker's session."""
    for reg in _reference_registries():
        for name, entry in list(reg.items()):
            cls = entry if isinstance(entry, type) else type(entry)
            if not cls.__module__.startswith("repro."):
                monkeypatch.delitem(reg, name)


def test_flags_match_reference(monkeypatch):
    """Every JAX flag, with its default and choices, plus ``--device``;
    the reference's registries hold only the ``repro`` package's own
    entries while its parser is built."""
    import argparse
    _own_entries_only(monkeypatch)
    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured["ap"] = self
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = grab
    argv0 = sys.argv
    try:
        sys.argv = ["train"]
        with pytest.raises(SystemExit):
            jtrain.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
        sys.argv = argv0

    def flags(ap):
        return {a.dest: (tuple(a.option_strings), a.default,
                         tuple(a.choices) if a.choices else None)
                for a in ap._actions if a.dest != "help"}
    got, want = flags(train.build_parser()), flags(captured["ap"])
    assert got.pop("device") == (("--device",), "cuda", None)
    assert got == want
