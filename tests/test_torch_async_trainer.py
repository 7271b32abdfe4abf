"""The event engine (``repro_torch.core.async_trainer``) against the JAX
package's (``repro.core.async_trainer``) and against the port's own sync
``Trainer.run``.

- The latency models draw bitwise the reference's traces for every model
  and seed (numpy generators, the same draw order), and ``AsyncStats``
  gives the reference's keys.
- At zero latency the engine realizes ``Trainer.run``'s aggregation
  schedule and states within rtol 1e-5 / atol 1e-6 (per-client calls
  against the sync path's ``vmap``, as the reference holds its own engine,
  ``tests/test_async_trainer.py``), for every method.
- The port's engine against the JAX engine on the same traces (each
  package draws them from the same seeds), four methods, from the
  reference's initial state (``repro_torch.convert``): int8 up (and down
  for the blocking methods) under a lognormal latency and a uniform
  network, the port fed the reference's ``jax.random`` bits through
  ``Transport.bits_fn`` with the true client index; a deadline policy on
  the tiered network; the ``lossy``, ``crashy`` and ``outage`` faults.
  ``AsyncStats.as_dict()``, ``arrival_order``, the fault statistics,
  ``participation_summary()``, the meter and the rows' exact columns are
  equal; losses and params within the tolerances of
  ``tests/test_torch_baselines.py`` (identity wire: rtol 1e-4 and atol
  1e-5; a coded wire moves an element across a stochastic-rounding
  boundary after an fp32 sum-order difference, so losses at rtol 1e-3
  there and params compared on the identity wire only).
- A resumed run (3 + 2 rounds) keeps the cadence of a 5-round one.

The CNN is ``tests/test_torch_baselines.py``'s narrow one.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import network as jnetwork
from repro import sched as jsched
from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.core import async_trainer as jat
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.faults import make_fault as jmake_fault
from repro.models.cnn import CNNConfig as JCNNConfig
from repro.transport import make_transport as jmake_transport
from repro_torch import data, network, sched
from repro_torch.common import bytes_of, tree_leaves
from repro_torch.configs.base import FSLConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import async_trainer as at
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.faults import make_fault
from repro_torch.models.cnn import CNNConfig
from repro_torch.transport import Transport, get_codec

ALL_METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")
BLOCKING = ("fsl_mc", "fsl_oc")
N, B = 3, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
EXACT = {"round", "aggregated", "sim_time", "comm_bytes", "participants",
         "dropped_updates", "skipped_updates", "fault_retries",
         "fault_drops"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _bundles():
    return (jcnn_bundle(JCNNConfig(**NARROW)),
            cnn_bundle(CNNConfig(**NARROW), device="cpu"))


@functools.lru_cache(maxsize=None)
def _cost_models():
    jb, b = _bundles()
    pa = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    jcm = JCostModel(n=N, q=jb.smashed_bytes_per_sample, d_local=40,
                     w_client=jbytes_of(pa["client"]),
                     w_server=jbytes_of(pa["server"]),
                     aux=jbytes_of(pa["aux"]))
    cm = CostModel(n=N, q=b.smashed_bytes_per_sample, d_local=40,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    assert dict(vars(cm)) == dict(vars(jcm))
    return cm, jcm


def _fed(pkg, n=N):
    x, y = pkg.synthetic_classification(120, NARROW["in_shape"], 10, seed=0,
                                        signal=12.0)
    return pkg.partition_iid(x, y, n, seed=0)


def _fkw(method, h=2, c=2):
    return dict(num_clients=N, h=h, agg_every=c, lr=0.1, method=method,
                grad_clip=1.0 if method == "fsl_oc" else 0.0)


# ---------------------------------------------------------------------------
# Latency models and stats
# ---------------------------------------------------------------------------

LATENCIES = {
    "constant": lambda m: m.ConstantLatency(),
    "constant_zero": lambda m: m.ConstantLatency(0.0, 0.0, 0.0),
    "lognormal": lambda m: m.LognormalLatency(),
    "lognormal_wide": lambda m: m.LognormalLatency(compute=0.5, sigma=1.0,
                                                   spread=1.0),
    "straggler": lambda m: m.StragglerLatency(frac=0.5),
    "straggler_base": lambda m: m.StragglerLatency(
        base=m.ConstantLatency(2.0, 0.0, 0.0), frac=0.25, slowdown=3.0),
    "compute_only": lambda m: m.LognormalLatency().compute_only(),
    "make_latency": lambda m: m.make_latency("straggler", frac=0.3),
}


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("name", list(LATENCIES))
def test_latency_trace_matches_reference_bitwise(name, seed):
    got = LATENCIES[name](at).draw(np.random.default_rng(seed), 4, 5, 2)
    want = LATENCIES[name](jat).draw(np.random.default_rng(seed), 4, 5, 2)
    assert got.shape == want.shape == (4, 5, 2)
    for f in ("compute", "up", "down"):
        a, w = getattr(got, f), getattr(want, f)
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a.view(np.uint64), w.view(np.uint64))


def test_registry_streams_and_stats_match_reference():
    assert set(at.LATENCY_MODELS) == set(jat.LATENCY_MODELS)
    assert at._NET_STREAM == jat._NET_STREAM
    assert at.ComputeOnlyLatency(at.ConstantLatency()).compute_only() \
        .base == at.ConstantLatency()
    with pytest.raises(KeyError, match="unknown latency model"):
        at.make_latency("uniform")
    kw = dict(rounds=2, events=7, async_time=3.5, sync_time=5.25,
              server_busy=1.0, client_wait=0.5, comm_time=0.25,
              compute_time=2.0, model_sync_time=0.125, dropped=1, skipped=2,
              agg_participants=[3, 2], arrival_order=[1, 0, 2])
    for k in ({}, kw):
        assert at.AsyncStats(**k).as_dict() == jat.AsyncStats(**k).as_dict()
        assert at.AsyncStats(**k).to_record("a.") == \
            jat.AsyncStats(**k).to_record("a.")


# ---------------------------------------------------------------------------
# Zero latency against the port's sync Trainer
# ---------------------------------------------------------------------------


def _states_close(a, b, rtol, atol):
    for key in set(a) - {"round"}:
        for x, y in zip(tree_leaves(a[key]), tree_leaves(b[key])):
            np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                       rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("h,agg_every", [(3, 2), (2, 5)])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_zero_latency_matches_sync_trainer(method, h, agg_every):
    """5 rounds: the aggregation schedule equal to the sync Trainer's and
    to the threshold crossings of C, the unit counter and the metered
    bytes equal, the states within rtol 1e-5 / atol 1e-6."""
    b = _bundles()[1]
    cm = _cost_models()[0]
    fsl = FSLConfig(**_fkw(method, h, agg_every))
    tr = Trainer(b, fsl)
    meters = CommMeter(), CommMeter()
    s_sync, h_sync = tr.run(tr.init(0), data.FederatedBatcher(_fed(data), B,
                                                              h), 5,
                            log_every=1, meter=meters[0], cost_model=cm)
    eng = at.AsyncTrainer(b, fsl, latency=at.ConstantLatency(0.0, 0.0, 0.0))
    s_async, h_async = eng.run(eng.init(0), data.FederatedBatcher(
        _fed(data), B, h), 5, log_every=1, meter=meters[1], cost_model=cm)
    flags = [r["aggregated"] for r in h_sync]
    assert flags == [r["aggregated"] for r in h_async] == [
        (r * h) // agg_every > ((r - 1) * h) // agg_every
        for r in range(1, 6)]
    assert s_sync["round"] == s_async["round"]
    assert meters[0].as_dict() == meters[1].as_dict()
    assert [r["comm_bytes"] for r in h_sync] == \
        [r["comm_bytes"] for r in h_async]
    _states_close(s_sync, s_async, 1e-5, 1e-6)
    k = fsl.h if eng.method.uploads_every_batch else 1
    assert eng.stats.events == N * k * 5


def test_resume_keeps_cadence():
    """3 + 2 rounds realize the aggregation schedule and the unit counter
    of one 5-round run (h = 3, C = 2), and the same state, bitwise."""
    b = _bundles()[1]
    fsl = FSLConfig(**_fkw("cse_fsl", 3, 2))
    eng = at.AsyncTrainer(b, fsl, latency=at.ConstantLatency(0.0, 0.0, 0.0))
    full, hist = eng.run(eng.init(0), data.FederatedBatcher(_fed(data), B,
                                                            3), 5,
                         log_every=1)
    batcher = data.FederatedBatcher(_fed(data), B, 3)
    part, h1 = eng.run(eng.init(0), batcher, 3, log_every=1)
    part, h2 = eng.run(part, batcher, 2, log_every=1)
    assert [r["round"] for r in h1 + h2] == [r["round"] for r in hist]
    assert [r["aggregated"] for r in h1 + h2] == \
        [r["aggregated"] for r in hist]
    assert part["round"] == full["round"] == 5
    for x, y in zip(tree_leaves({k: v for k, v in part.items()
                                 if k != "round"}),
                    tree_leaves({k: v for k, v in full.items()
                                 if k != "round"})):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The port's engine against the JAX engine
# ---------------------------------------------------------------------------


def _jbits_fn(jtp):
    """The reference engine's bits: ``unit_key(unit, client=c, salt)``,
    then the leaf folded in, as its per-client ``code_uplink`` /
    ``code_downlink`` derive them."""
    def bits_fn(unit, client, leaf, salt, shape):
        key = jax.random.fold_in(jtp.unit_key(unit, client=client,
                                              salt=salt), leaf)
        return np.asarray(jax.random.bits(key, shape, jnp.uint32))
    return bits_fn


def _deadline(pkg, tr, batch, net):
    """A budget between the two slowest clients' analytic round times
    (each package's own; they agree)."""
    m, fsl, tp = tr.method, tr.fsl, tr.transport
    up, reply = m.payload_specs(tr.bundle, fsl, batch)
    ctx = pkg.SchedContext(
        fsl=fsl, network=net, up_bytes=tp.uplink_payload_bytes(up),
        down_bytes=tp.downlink_payload_bytes(reply)
        if reply is not None else 0, blocking=m.downloads_gradients,
        uploads_per_round=fsl.h if m.uploads_every_batch else 1)
    secs = np.sort(pkg.DeadlinePolicy(compute_s=0.5).client_seconds(ctx))
    return pkg.DeadlinePolicy(deadline_s=float(0.5 * (secs[-2] + secs[-1])),
                              compute_s=0.5)


def _engines(method, setting):
    """Both engines under ``setting`` from the same latency model and seed:
    ``(port engine, JAX engine, coded)``."""
    jb, b = _bundles()
    fkw = _fkw(method)
    coded = setting == "int8"
    if coded:
        down = "int8" if method in BLOCKING else "none"
        jtp = jmake_transport("int8", down)
        kw = dict(transport=Transport(uplink=get_codec("int8"),
                                      downlink=get_codec(down),
                                      bits_fn=_jbits_fn(jtp)),
                  network=network.UniformNetwork(up_mbps=2.0, down_mbps=8.0))
        jkw = dict(transport=jtp, network=jnetwork.UniformNetwork(
            up_mbps=2.0, down_mbps=8.0))
    elif setting == "deadline":
        from repro.core.trainer import Trainer as JTrainer
        jnet, net = jnetwork.TieredNetwork(), network.TieredNetwork()
        pol = _deadline(sched, Trainer(b, FSLConfig(**fkw)),
                        data.FederatedBatcher(_fed(data), B, 2).next_round(),
                        net)
        jpol = _deadline(jsched, JTrainer(jb, JFSLConfig(**fkw),
                                          donate=False),
                         jdata.FederatedBatcher(_fed(jdata), B,
                                                2).next_round(), jnet)
        assert vars(pol) == vars(jpol)
        kw, jkw = (dict(scheduler=pol, network=net),
                   dict(scheduler=jpol, network=jnet))
    else:
        fault = dict(lossy=dict(loss_rate=0.4, max_retries=1, seed=3),
                     crashy=dict(crash_rate=0.3, seed=1),
                     outage=dict(outage_rate=0.5, seed=2))[setting]
        kw = dict(faults=make_fault(setting, **fault))
        jkw = dict(faults=jmake_fault(setting, **fault))
    common = dict(seed=5, server_time=0.05)
    eng = at.AsyncTrainer(b, FSLConfig(**fkw), latency=at.LognormalLatency(
        compute=1.0, sigma=1.0, spread=1.0), **common, **kw)
    jeng = jat.AsyncTrainer(jb, JFSLConfig(**fkw),
                            latency=jat.LognormalLatency(
                                compute=1.0, sigma=1.0, spread=1.0),
                            **common, **jkw)
    return eng, jeng, coded


@pytest.mark.parametrize("setting", ["int8", "deadline", "lossy", "crashy",
                                     "outage"])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_engine_matches_reference(method, setting):
    """3 rounds at h = 2, C = 2 (each round aggregates) on the same traces:
    everything the host counts exactly, the training within the baseline
    tests' tolerances."""
    eng, jeng, coded = _engines(method, setting)
    cm, jcm = _cost_models()
    jstate = jeng.init(0)
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                             device="cpu", method=method)
    meter, jmeter = CommMeter(), JCommMeter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jstate, jhist = jeng.run(jstate, jdata.FederatedBatcher(
            _fed(jdata), B, 2), 3, log_every=1, meter=jmeter,
            cost_model=jcm)
        state, hist = eng.run(state, data.FederatedBatcher(_fed(data), B, 2),
                              3, log_every=1, meter=meter, cost_model=cm)
    assert eng.stats.as_dict() == jeng.stats.as_dict()
    assert eng.stats.arrival_order == jeng.stats.arrival_order
    assert eng.stats.agg_participants == jeng.stats.agg_participants
    assert meter.as_dict() == jmeter.as_dict()
    assert eng.participation_summary() == jeng.participation_summary()
    if eng.fault_stats is not None:
        assert dataclasses.asdict(eng.fault_stats) == \
            dataclasses.asdict(jeng.fault_stats)
    assert len(hist) == len(jhist) == 3
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in set(row) & EXACT:
            assert row[k] == jrow[k], (row["round"], k)
        for k in set(row) - EXACT:
            np.testing.assert_allclose(row[k], jrow[k],
                                       rtol=1e-3 if coded else 1e-4,
                                       err_msg=f"round {row['round']} {k}")
    got = state_to_numpy(state, method=method)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    assert int(got["round"]) == int(want["round"])
    if coded:
        return
    for key in set(want) - {"round"}:
        for (path, a), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                jax.tree_util.tree_leaves_with_path(want[key]["params"])):
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5,
                                       err_msg=key + jax.tree_util.keystr(
                                           path))


def test_settings_exercise_the_engine():
    """The settings above reach what they are there for: the lognormal
    traces permute the first round's arrivals, the deadline drops
    arrivals and skips the slowest tier, each fault model retries, crashes
    or goes down."""
    seen = {}
    for setting in ("int8", "deadline", "lossy", "crashy", "outage"):
        eng, _, _ = _engines("fsl_an", setting)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng.run(eng.init(0), data.FederatedBatcher(_fed(data), B, 2), 3)
        seen[setting] = (eng.stats, eng.fault_stats)
    assert seen["int8"][0].arrival_order != list(range(N))
    assert seen["deadline"][0].skipped > 0 and seen["deadline"][0].dropped > 0
    assert seen["lossy"][1].retries > 0 and seen["lossy"][1].wire_drops > 0
    assert seen["crashy"][1].crash_drops > 0
    assert seen["outage"][1].outages > 0
