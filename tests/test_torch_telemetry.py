"""The port's telemetry (``repro_torch.telemetry``) against the JAX
package's, and its contract on the port's four engines.

- The recorder: the shared no-op ``NullTelemetry``, schema-v1 records and
  ``validate_record`` (the reference's accepts what the port's accepts and
  rejects what it rejects), labelled counters and gauges.
- The exporters: the same emissions into both packages' recorders give
  the same JSONL lines, Prometheus text and Chrome trace, byte for byte.
- The record streams of all four engines (``Trainer.run`` under the lossy
  preset, ``run_compiled``, ``AsyncTrainer`` under a lognormal latency and
  the lossy preset, ``Population`` over a VirtualPool under it) against
  the JAX engines' from the reference's converted initial state on the
  narrow CNN: every field exact but the training metrics (rtol 1e-4, the
  identity wire's fp32 sum order, as ``tests/test_torch_faults.py``
  states); the counters; the summaries' keys and their host values.
- Telemetry only observes: each engine's state, history and meter (and
  the event engine's stats) bitwise the same with it on and off; the
  loop folds unlogged rounds' records at its next fetch, unchanged.
- The event engine's simulated timeline adds up to its accounting exactly
  (compute, wire, backoff, service); the compiled path's and the
  population engine's host spans, a pair a chunk.
"""
import functools
import json
import math
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import network as jnetwork
from repro import population as jpopulation
from repro import telemetry as jtelemetry
from repro.configs.base import FSLConfig as JFSLConfig
from repro.core import async_trainer as jat
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.faults import make_fault as jmake_fault
from repro.models.cnn import CNNConfig as JCNNConfig
from repro_torch import data, network, population, telemetry
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.convert import state_from_numpy
from repro_torch.core import async_trainer as at
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.graphs import state_leaves
from repro_torch.core.trainer import Trainer
from repro_torch.faults import FaultStats, make_fault
from repro_torch.models.cnn import CNNConfig
from repro_torch.telemetry import (NULL_TELEMETRY, NullTelemetry, Telemetry,
                                   make_round_record, resolve_telemetry,
                                   validate_record)

N, H, B = 3, 2, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
LOSSY = dict(loss_rate=0.4, max_retries=1, seed=3)
ENGINES = ("loop", "compiled", "async", "population")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops run on one intra-op thread (pytest-xdist workers share the
    cores); both sides of every comparison run under the same setting."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _bundles():
    return (jcnn_bundle(JCNNConfig(**NARROW)),
            cnn_bundle(CNNConfig(**NARROW), device="cpu"))


def _cost_models():
    _, b = _bundles()
    kw = dict(n=N, q=b.smashed_bytes_per_sample, d_local=40,
              w_client=bytes_of(b.specs["client"]),
              w_server=bytes_of(b.specs["server"]),
              aux=bytes_of(b.specs["aux"]))
    return CostModel(**kw), JCostModel(**kw)


def _fed(pkg):
    x, y = pkg.synthetic_classification(120, NARROW["in_shape"], 10, seed=0,
                                        signal=12.0)
    return pkg.partition_iid(x, y, N, seed=0)


def _fkw(method="cse_fsl"):
    return dict(num_clients=N, h=H, lr=0.1, method=method)


def _virtual(pkg):
    return pkg.VirtualPool.synthetic(NARROW["in_shape"], 10, pool_size=96,
                                     d_local=24, batch_size=B, h=H, seed=0)


def _port_state(jstate, method="cse_fsl"):
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                            device="cpu", method=method)


def _engine_runs(engine, tele, jtele, method="cse_fsl", rounds=4):
    """``engine`` in both packages with their recorders, from the
    reference's initial state; returns the port's (state, hist, meter,
    runner) and the reference's."""
    jb, b = _bundles()
    cm, jcm = _cost_models()
    meter, jmeter = CommMeter(), JCommMeter()
    fkw = _fkw(method)
    run_kw = dict(log_every=1, meter=meter, cost_model=cm)
    jrun_kw = dict(log_every=1, meter=jmeter, cost_model=jcm)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if engine in ("loop", "compiled"):
            faults = engine == "loop"
            jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False,
                           telemetry=jtele,
                           faults=jmake_fault("lossy", **LOSSY)
                           if faults else None)
            tr = Trainer(b, FSLConfig(**fkw), telemetry=tele,
                         faults=make_fault("lossy", **LOSSY)
                         if faults else None)
            jstate = jtr.init(0)
            state = _port_state(jstate, method)
            if engine == "loop":
                js = jtr.run(jstate, jdata.FederatedBatcher(_fed(jdata), B, H),
                             rounds, **jrun_kw)
                ps = tr.run(state, data.FederatedBatcher(_fed(data), B, H),
                            rounds, **run_kw)
            else:
                js = jtr.run_compiled(jstate, jdata.FederatedBatcher(
                    _fed(jdata), B, H), rounds, chunk=3, **jrun_kw)
                ps = tr.run_compiled(state, data.FederatedBatcher(
                    _fed(data), B, H), rounds, chunk=3, **run_kw)
            return (*ps, meter, tr), (*js, jmeter, jtr)
        if engine == "async":
            common = dict(seed=5, server_time=0.05)
            jtr = jat.AsyncTrainer(
                jb, JFSLConfig(**fkw), telemetry=jtele,
                latency=jat.LognormalLatency(compute=1.0, sigma=1.0,
                                             spread=1.0),
                network=jnetwork.UniformNetwork(up_mbps=2.0, down_mbps=8.0),
                faults=jmake_fault("lossy", **LOSSY), **common)
            tr = at.AsyncTrainer(
                b, FSLConfig(**fkw), telemetry=tele,
                latency=at.LognormalLatency(compute=1.0, sigma=1.0,
                                            spread=1.0),
                network=network.UniformNetwork(up_mbps=2.0, down_mbps=8.0),
                faults=make_fault("lossy", **LOSSY), **common)
            jstate = jtr.init(0)
            state = _port_state(jstate, method)
            js = jtr.run(jstate, jdata.FederatedBatcher(_fed(jdata), B, H),
                         rounds, **jrun_kw)
            ps = tr.run(state, data.FederatedBatcher(_fed(data), B, H),
                        rounds, **run_kw)
            return (*ps, meter, tr), (*js, jmeter, jtr)
        kw = dict(population=5000, sampler="stratified")
        jpop = jpopulation.Population(
            jb, JFSLConfig(**fkw), data=_virtual(jpopulation),
            network=jnetwork.TieredNetwork(), donate=False,
            faults=jmake_fault("lossy", **LOSSY), telemetry=jtele, **kw)
        jpop.init(seed=0)
        pop = population.Population(
            b, FSLConfig(**fkw), data=_virtual(population),
            network=network.TieredNetwork(),
            faults=make_fault("lossy", **LOSSY), telemetry=tele, **kw)
        pop.init(state=_port_state(jpop._state, method))
        js = jpop.run(rounds, chunk=3, **jrun_kw)
        ps = pop.run(rounds, chunk=3, **run_kw)
        return (*ps, meter, pop), (*js, jmeter, jpop)


# ---------------------------------------------------------------------------
# Recorder and schema
# ---------------------------------------------------------------------------


def test_null_recorder_is_shared_noop():
    assert resolve_telemetry(None) is NULL_TELEMETRY
    assert not NULL_TELEMETRY.enabled
    t = Telemetry()
    assert resolve_telemetry(t) is t and t.enabled
    with pytest.raises(TypeError, match="Telemetry or None"):
        resolve_telemetry(42)
    NULL_TELEMETRY.counter("x", 3, engine="loop")
    NULL_TELEMETRY.gauge("y", 1.0)
    NULL_TELEMETRY.sim_span("s", 0.0, 1.0, track="server")
    NULL_TELEMETRY.host_span("h", 0.0, 1.0)
    NULL_TELEMETRY.round_record("loop", 1, {"loss": 1.0}, True)
    NULL_TELEMETRY.run_summary("loop", comm=CommMeter())
    with NULL_TELEMETRY.timed("t"):
        pass
    assert not NULL_TELEMETRY.counters and not NULL_TELEMETRY.gauges
    assert not NULL_TELEMETRY.spans and not NULL_TELEMETRY.records
    assert isinstance(NULL_TELEMETRY, NullTelemetry)
    assert telemetry.ENGINES == jtelemetry.ENGINES == ENGINES
    assert telemetry.SCHEMA_VERSION == jtelemetry.SCHEMA_VERSION == 1


def test_schema_matches_reference():
    """The same records are valid or invalid in both packages."""
    rec = make_round_record("loop", 3, {"loss": 1.5}, True, comm_bytes=10,
                            sim_time=2.5, extra={"participants": 2})
    assert rec == jtelemetry.make_round_record(
        "loop", 3, {"loss": 1.5}, True, comm_bytes=10, sim_time=2.5,
        extra={"participants": 2})
    assert validate_record(rec) is rec
    summ = telemetry.make_summary_record("async", {"comm.total": 3})
    assert summ == jtelemetry.make_summary_record("async", {"comm.total": 3})
    bad = [dict(rec, v=99), dict(rec, engine="cuda"), dict(rec, round=0),
           dict(rec, aggregated="yes"), dict(rec, metrics={1: 2.0}),
           dict(rec, metrics={"loss": "nan?"}), dict(rec, comm_bytes=1.5),
           dict(rec, sim_time="late"), dict(rec, type="summary"),
           dict(rec, type="other"), [rec], dict(summ, summary=None)]
    for b in bad:
        for validate in (validate_record, jtelemetry.validate_record):
            with pytest.raises(ValueError):
                validate(b)
    for e in ENGINES:
        validate_record(dict(rec, engine=e))


def test_counters_and_gauges_are_labelled():
    t = Telemetry()
    t.counter("ticks", 1, engine="loop")
    t.counter("ticks", 2, engine="loop")
    t.counter("ticks", 5, engine="async")
    t.gauge("depth", 3.0, engine="loop")
    t.gauge("depth", 7.0, engine="loop")          # latest wins
    assert t.counters[("ticks", (("engine", "loop"),))] == 3
    assert t.counters[("ticks", (("engine", "async"),))] == 5
    assert t.gauges[("depth", (("engine", "loop"),))] == 7.0


def _emit(t):
    """One fixed set of emissions (no host timing)."""
    t.round_record("loop", 1, {"loss": 1.25, "aux": 0.5}, False,
                   comm_bytes=100)
    t.round_record("loop", 2, {"loss": 1.0}, True, comm_bytes=250,
                   extra={"participants": 2, "dropped_updates": 1})
    t.round_record("async", 1, {"loss": 2.0}, True, sim_time=3.5)
    t.counter("retries", 3, engine="async", channel="uplink")
    t.gauge("depth.max", 7.25, engine="loop")
    t.sim_span("compute", 0.0, 1.5, track="client/1", unit=0)
    t.sim_span("wire/up", 1.5, 0.25, track="client/1", unit=0, attempt=1,
               channel="uplink", delivered=True)
    t.sim_span("serve", 1.75, 0.05, track="server", client=1, unit=0)
    t.sim_span("compute", 0.0, 2.0, track="client/0", unit=0)
    t.host_span("chunk/build", 100.0, 0.5, chunk=0, rounds=2)
    t.host_span("chunk/execute", 100.5, 1.25, chunk=0, rounds=2)
    t.run_summary("loop", comm={"total": 250, "up": {"a": 1, "b": 2}},
                  stats={"async_time": 3.5, "ok": True}, faults=None)


def test_exporters_match_reference(tmp_path):
    t, jt = Telemetry(), jtelemetry.Telemetry()
    _emit(t)
    _emit(jt)
    assert t.records == jt.records
    assert t.prometheus_text() == jt.prometheus_text()
    assert t.prometheus_text() == t.prometheus_text()
    assert json.dumps(t.chrome_trace(), sort_keys=True) == \
        json.dumps(jt.chrome_trace(), sort_keys=True)
    t.export_jsonl(str(tmp_path / "a.jsonl"))
    jt.export_jsonl(str(tmp_path / "b.jsonl"))
    lines = (tmp_path / "a.jsonl").read_text().splitlines()
    assert lines == (tmp_path / "b.jsonl").read_text().splitlines()
    assert [validate_record(json.loads(x)) for x in lines] == t.records
    for ln in lines:
        assert ln == json.dumps(json.loads(ln), sort_keys=True)
    t.export_prometheus(str(tmp_path / "a.prom"))
    t.export_trace(str(tmp_path / "a.trace.json"))
    assert (tmp_path / "a.prom").read_text() == t.prometheus_text()
    assert json.loads((tmp_path / "a.trace.json").read_text()) == \
        t.chrome_trace()
    for line in t.prometheus_text().splitlines():
        if line and not line.startswith("#"):
            name = line.split("{")[0].split(" ")[0]
            assert all(c.isalnum() or c in "_:" for c in name), line


# ---------------------------------------------------------------------------
# The four engines' record streams against the reference's
# ---------------------------------------------------------------------------


def _is_training_metric(key: str) -> bool:
    return key.split(".")[-1].endswith(("loss", "accuracy"))


@pytest.mark.parametrize("engine", ENGINES)
def test_record_streams_match_reference(engine):
    tele, jtele = Telemetry(), jtelemetry.Telemetry()
    (state, hist, meter, tr), (_, jhist, jmeter, jtr) = _engine_runs(
        engine, tele, jtele)
    assert meter.as_dict() == jmeter.as_dict()
    recs, jrecs = tele.records, jtele.records
    assert [(r["type"], r["engine"]) for r in recs] == \
        [(r["type"], r["engine"]) for r in jrecs]
    assert [r["engine"] for r in recs] == [engine] * len(recs)
    assert [r["type"] for r in recs] == ["round"] * 4 + ["summary"]
    for r, jr in zip(recs[:-1], jrecs[:-1]):
        assert {k: v for k, v in r.items() if k != "metrics"} == \
            {k: v for k, v in jr.items() if k != "metrics"}
        assert set(r["metrics"]) == set(jr["metrics"])
        for k, v in r["metrics"].items():
            assert isinstance(v, float)
            np.testing.assert_allclose(v, jr["metrics"][k], rtol=1e-4)
    # the record metrics ARE the history metrics, row for row
    assert [r["metrics"] for r in recs[:-1]] == [
        {k: v for k, v in row.items() if k in recs[0]["metrics"]}
        for row in hist]
    s, js = recs[-1]["summary"], jrecs[-1]["summary"]
    assert list(s) == list(js) and list(s) == sorted(s)
    for k, v in s.items():
        if _is_training_metric(k):
            np.testing.assert_allclose(v, js[k], rtol=1e-4)
        else:
            assert v == js[k], k
    assert tele.counters == jtele.counters
    assert set(tele.gauges) == set(jtele.gauges)
    if engine in ("loop", "async", "population"):
        assert any(r.get("extra") for r in recs[:-1])
    if engine == "async":
        assert all(r["sim_time"] > 0 for r in recs[:-1])
    if engine == "population":
        assert "population.windows" in s and s["population.windows"] == 4
    sim = sorted((sp.name, sp.track, sp.start, sp.dur,
                  tuple(sorted(sp.labels.items()))) for sp in tele.spans
                 if sp.cat == "sim")
    jsim = sorted((sp.name, sp.track, sp.start, sp.dur,
                   tuple(sorted(sp.labels.items()))) for sp in jtele.spans
                  if sp.cat == "sim")
    assert sim == jsim
    # in start order: the port's population engine lands a segment (its
    # execute span ends) after it has built the next one
    host = [(sp.name, sp.labels.get("chunk", sp.labels.get("window")),
             sp.labels["rounds"]) for sp in sorted(
                 tele.spans, key=lambda sp: sp.start) if sp.cat == "host"]
    jhost = [(sp.name, sp.labels.get("chunk", sp.labels.get("window")),
              sp.labels["rounds"]) for sp in jtele.spans if sp.cat == "host"]
    assert host == jhost


# ---------------------------------------------------------------------------
# On and off: bitwise
# ---------------------------------------------------------------------------


def _port_run(engine, tele, method):
    """``engine`` on the port alone (its own initial draw), under faults
    where the engine takes them."""
    _, b = _bundles()
    fkw = _fkw(method)
    cm, _ = _cost_models()
    meter = CommMeter()
    kw = dict(log_every=1, meter=meter, cost_model=cm)
    lossy = make_fault("lossy", **LOSSY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if engine in ("loop", "compiled"):
            tr = Trainer(b, FSLConfig(**fkw), telemetry=tele, faults=lossy)
            batcher = data.FederatedBatcher(_fed(data), B, H)
            if engine == "loop":
                state, hist = tr.run(tr.init(0), batcher, 4, **kw)
            else:
                state, hist = tr.run_compiled(tr.init(0), batcher, 4,
                                              chunk=3, **kw)
            return state, hist, meter, None
        if engine == "async":
            tr = at.AsyncTrainer(b, FSLConfig(**fkw), telemetry=tele,
                                 latency=at.LognormalLatency(), seed=7,
                                 faults=lossy)
            state, hist = tr.run(tr.init(0), data.FederatedBatcher(
                _fed(data), B, H), 4, **kw)
            return state, hist, meter, tr.stats.as_dict()
        pop = population.Population(
            b, FSLConfig(**fkw), population=5000, data=_virtual(population),
            sampler="stratified", network=network.TieredNetwork(),
            faults=lossy, telemetry=tele).init(seed=0)
        state, hist = pop.run(4, chunk=3, **kw)
        return state, hist, meter, pop.population_summary(hist)


@pytest.mark.parametrize("method", ["cse_fsl", "fsl_mc"])
@pytest.mark.parametrize("engine", ENGINES)
def test_bitwise_with_telemetry(engine, method):
    tele = Telemetry()
    s1, h1, m1, x1 = _port_run(engine, tele, method)
    s2, h2, m2, x2 = _port_run(engine, None, method)
    assert s1["round"] == s2["round"]
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(s1),
                                                 state_leaves(s2)))
    assert h1 == h2 and m1.as_dict() == m2.as_dict() and x1 == x2
    rounds = [r for r in tele.records if r["type"] == "round"]
    assert len(rounds) == 4 and tele.records[-1]["type"] == "summary"
    for rec in tele.records:
        validate_record(rec)
    assert tele.gauges[("comm.total", (("engine", engine),))] == m1.total


@pytest.mark.parametrize("log_every,folds", [(0, [5]), (2, [2, 2, 1]),
                                             (3, [3, 2])])
def test_loop_defers_unlogged_records(log_every, folds, monkeypatch):
    """``Trainer.run`` keeps an unlogged round's metrics on the device and
    folds its record when the next logged round fetches, or at the run's
    end (one fetch for each): the record stream, counters and gauges are
    those of a run that logs every round, exactly, and state, history
    and meter those of the same run without a recorder, bitwise."""
    _, b = _bundles()
    cm, _ = _cost_models()
    fetched = []
    fold = Trainer._fold_pending

    def counting(self, pending):
        if pending:
            fetched.append(len(pending))
        return fold(self, pending)

    def run(tele, every):
        tr = Trainer(b, FSLConfig(**_fkw()), telemetry=tele,
                     faults=make_fault("lossy", **LOSSY))
        meter = CommMeter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            state, hist = tr.run(tr.init(0), data.FederatedBatcher(
                _fed(data), B, H), 5, log_every=every, meter=meter,
                cost_model=cm)
        return state, hist, meter.as_dict()

    every_round = Telemetry()
    run(every_round, 1)
    monkeypatch.setattr(Trainer, "_fold_pending", counting)
    fetched.clear()
    tele = Telemetry()
    s1, h1, m1 = run(tele, log_every)
    assert fetched == folds
    assert tele.records == every_round.records
    assert [r["type"] for r in tele.records] == ["round"] * 5 + ["summary"]
    assert any(r.get("extra") for r in tele.records[:-1])
    assert tele.counters == every_round.counters
    assert tele.gauges == every_round.gauges
    s0, h0, m0 = run(None, log_every)
    assert all(torch.equal(x, y) for x, y in zip(state_leaves(s1),
                                                 state_leaves(s0)))
    assert h1 == h0 and m1 == m0
    assert [r["round"] for r in h1] == list(
        range(log_every, 6, log_every) if log_every else [])


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


def _span_sum(tele, name):
    return sum(s.dur for s in tele.spans if s.name == name)


@pytest.mark.parametrize("method", ["cse_fsl", "fsl_mc"])
def test_async_spans_reconcile_with_stats(method):
    """Every accounting total of the event engine is the sum of its spans:
    wire, compute, service exactly; backoff exactly for the streaming
    method (a blocking one's billed backoff counts replies never waited
    for)."""
    _, b = _bundles()
    tele = Telemetry()
    tr = at.AsyncTrainer(b, FSLConfig(**_fkw(method)), telemetry=tele,
                         latency=at.LognormalLatency().compute_only(),
                         network=network.UniformNetwork(), faults="lossy",
                         seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr.run(tr.init(0), data.FederatedBatcher(_fed(data), B, H), 5)
    st = tr.stats
    fs = tr.participation_summary()["faults"]
    assert fs["retries"] > 0
    wire = _span_sum(tele, "wire/up") + _span_sum(tele, "wire/down")
    assert math.isclose(wire, st.comm_time, rel_tol=1e-9)
    assert math.isclose(_span_sum(tele, "compute"), st.compute_time,
                        rel_tol=1e-9)
    assert math.isclose(_span_sum(tele, "serve"), st.server_busy,
                        rel_tol=1e-9)
    if method == "cse_fsl":
        assert math.isclose(_span_sum(tele, "retry_backoff"),
                            fs["retry_seconds"], rel_tol=1e-9)
    else:
        assert any(s.name == "wire/down" for s in tele.spans)
        assert _span_sum(tele, "retry_backoff") <= fs["retry_seconds"] + 1e-9
    assert max(s.start + s.dur for s in tele.spans) <= st.async_time + 1e-9
    trace = tele.chrome_trace()
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(tele.spans)
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in xs)


def test_compiled_and_population_chunk_spans():
    """A build and an execute span a chunk (a segment in the population
    engine, whose execute span holds the next segment's build), on the
    host; no chunk captures on the CPU."""
    _, b = _bundles()
    tele = Telemetry()
    tr = Trainer(b, FSLConfig(**_fkw()), telemetry=tele)
    tr.run_compiled(tr.init(0), data.FederatedBatcher(_fed(data), B, H), 5,
                    chunk=2)
    builds = [s for s in tele.spans if s.name == "chunk/build"]
    execs = [s for s in tele.spans if s.name == "chunk/execute"]
    assert len(builds) == len(execs) == 3          # ceil(5 / 2)
    assert all(s.cat == "host" and s.dur >= 0 for s in builds + execs)
    assert [s.labels["chunk"] for s in execs] == [0, 1, 2]
    assert [s.labels["rounds"] for s in execs] == [2, 2, 1]
    assert not any(s.labels["capture"] for s in execs)
    tele = Telemetry()
    pop = population.Population(
        b, FSLConfig(**_fkw()), population=5000, data=_virtual(population),
        refresh=False, telemetry=tele).init(seed=0)
    pop.run(5, chunk=4)
    execs = [s for s in tele.spans if s.name == "chunk/execute"]
    builds = [s for s in tele.spans if s.name == "chunk/build"]
    # refresh=False cuts segments at each window (one round each here)
    assert [s.labels["window"] for s in execs] == [0, 1, 2, 3, 4]
    assert not any(s.labels["capture"] for s in execs)
    # a segment runs from its launch to its metrics' landing, which waits
    # until the next segment's host plan is built
    assert all(e.start <= b.start and b.start + b.dur <= e.start + e.dur
               for e, b in zip(execs, builds[1:]))
    assert tele.records[-1]["summary"]["population.windows"] == 5
    assert tele.records[-1]["engine"] == "population"


def test_zero_round_summary_is_valid():
    """Summaries of runs with no rounds fold into a valid record (objects
    with ``as_dict`` pass as they are)."""
    t = Telemetry()
    t.run_summary("loop", faults=FaultStats(), comm=CommMeter(),
                  stats=at.AsyncStats())
    assert validate_record(t.records[-1])["type"] == "summary"
    assert t.records[-1]["summary"]["faults.windows"] == 0
    json.dumps(t.records)
