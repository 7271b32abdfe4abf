"""The port's population engine (``repro_torch.population``), its cohort
samplers and data backends, against the port's own dense trainer and the
JAX package's engine.

1. C == N over a FederatedPool: ``Population.run`` is BITWISE equal to the
   port's ``Trainer.run`` (state, history rows, meter) for the four
   methods under the identity and int8 codecs, and on the h = 3 /
   ``agg_every=2`` cadence (``tests/test_population.py``'s contract).
2. Against the JAX ``Population`` on the narrow CNN from the reference's
   converted initial state (VirtualPool N = 5000, C = 3, stratified on the
   tiered network, refresh True and False, and a run under faults): the
   cohorts, the index plans, the history rows' host fields, the meter,
   ``memory_report``, ``population_summary`` and the fault stats equal
   exactly; losses at rtol 1e-4 and params at atol 1e-5 (the identity
   wire, fp32 sum order only, as ``tests/test_torch_sched.py`` states).
3. Checkpoint: save, restore into a fresh engine (a ``meta`` template, no
   parameters drawn) or a live one, and the resumed rounds bitwise the
   uninterrupted run's, also mid-window under faults.
4. Lazy state: ``engine_total`` independent of N; the refresh cache
   semantics; no row the engine keeps shares storage with the state.
5. The samplers and ``VirtualPool`` against the reference over a grid
   (C >= N, one-seat tiers, fleets of 10^6).
6. ``LMBatcher``'s device pool: ``run_compiled`` pooled bitwise equal to
   staged on reduced Qwen3 (fp32), and ``LMPool`` through the engine.
7. ``fig_population.bench_memory`` against the JAX driver's.
"""
import dataclasses
import functools
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FSLConfig as JFSLConfig
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.models.cnn import CNNConfig as JCNNConfig
from repro import network as jnetwork
from repro import population as jpopulation
from repro import sched as jsched
from repro.faults import make_fault as jmake_fault
from repro_torch import network, population, sched
from repro_torch.common import bytes_of, tree_leaves
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle, transformer_bundle
from repro_torch.core.graphs import state_leaves
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification, synthetic_lm)
from repro_torch.faults import make_fault
from repro_torch.launch.train import LMBatcher, LMPool, build_data
from repro_torch.models.cnn import CNNConfig
from repro_torch.population import FederatedPool, Population, VirtualPool

ALL_METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")
SMOKE = dict(name="smoke_cnn", in_shape=(8, 8, 1), num_classes=10,
             conv_channels=(2, 2), kernel=3, server_widths=(8,),
             aux_channels=2, lrn=False)
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
EXACT = {"round", "aggregated", "comm_bytes", "participants",
         "dropped_updates", "fault_retries", "fault_drops"}
FAULTS = {"lossy": dict(loss_rate=0.4, max_retries=1, seed=3),
          "crashy": dict(crash_rate=0.4, seed=1)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops run on one intra-op thread (pytest-xdist workers share the
    cores); both sides of every comparison run under the same setting."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_bitwise(a, b):
    assert a["round"] == b["round"]
    la, lb = state_leaves(a), state_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# 1. bitwise against the port's dense trainer (full-fleet cohort)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _smoke_bundle():
    return cnn_bundle(CNNConfig(**SMOKE), device="cpu")


def _smoke_data(n):
    x, y = synthetic_classification(24 * n, (8, 8, 1), 10, seed=0,
                                    signal=12.0)
    return partition_iid(x, y, n, seed=0)


def _cm(n):
    return CostModel(n=n, q=8, d_local=24, w_client=100, w_server=100,
                     aux=10)


def _dense_and_population(method, codec="none", n=2, h=2, agg_every=0,
                          rounds=5, chunk=3):
    fsl = FSLConfig(num_clients=n, h=h, method=method, agg_every=agg_every,
                    codec=codec)
    bundle, fed = _smoke_bundle(), _smoke_data(n)
    tr = Trainer(bundle, fsl)
    m1 = CommMeter()
    s1, h1 = tr.run(tr.init(0), FederatedBatcher(fed, 4, h, seed=0), rounds,
                    log_every=1, meter=m1, cost_model=_cm(n))
    pop = Population(bundle, fsl, population=n,
                     data=FederatedPool(fed, 4, h, seed=0)).init(seed=0)
    m2 = CommMeter()
    s2, h2 = pop.run(rounds, chunk=chunk, log_every=1, meter=m2,
                     cost_model=_cm(n))
    return (s1, h1, m1), (s2, h2, m2)


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_population_bitwise_vs_dense(method, codec):
    (s1, h1, m1), (s2, h2, m2) = _dense_and_population(method, codec)
    _assert_bitwise(s1, s2)
    assert h1 == h2 and m1.as_dict() == m2.as_dict()


def test_population_bitwise_nondivisible_cadence():
    # h=3, C=2: thresholds crossed mid-round; windows of varying length
    (s1, h1, m1), (s2, h2, m2) = _dense_and_population(
        "cse_fsl", h=3, agg_every=2, chunk=2)
    _assert_bitwise(s1, s2)
    assert h1 == h2 and m1.as_dict() == m2.as_dict()


# ---------------------------------------------------------------------------
# 2. against the JAX package's engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _narrow_bundles():
    return (jcnn_bundle(JCNNConfig(**NARROW)),
            cnn_bundle(CNNConfig(**NARROW), device="cpu"))


def _narrow_cost_models():
    _, b = _narrow_bundles()
    kw = dict(n=3, q=b.smashed_bytes_per_sample, d_local=24,
              w_client=bytes_of(b.specs["client"]),
              w_server=bytes_of(b.specs["server"]),
              aux=bytes_of(b.specs["aux"]))
    return CostModel(**kw), JCostModel(**kw)


def _virtual(pkg, shape=(12, 12, 3)):
    return pkg.VirtualPool.synthetic(shape, 10, pool_size=96, d_local=24,
                                     batch_size=4, h=2, seed=0)


def _pair(refresh=True, fault=None, population_=5000):
    """Both engines on the same config; the port's starts from the
    reference's converted initial state."""
    jb, b = _narrow_bundles()
    fkw = dict(num_clients=3, h=2, method="cse_fsl", agg_every=4, lr=0.1)
    kw = dict(population=population_, sampler="stratified", refresh=refresh)
    jkw, pkw = {}, {}
    if fault is not None:
        jkw["faults"] = jmake_fault(fault, **FAULTS[fault])
        pkw["faults"] = make_fault(fault, **FAULTS[fault])
    jpop = jpopulation.Population(
        jb, JFSLConfig(**fkw), data=_virtual(jpopulation),
        network=jnetwork.TieredNetwork(), donate=False, **kw, **jkw)
    jpop.init(seed=0)
    pop = Population(b, FSLConfig(**fkw), data=_virtual(population),
                     network=network.TieredNetwork(), **kw, **pkw)
    pop.init(state=state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpop._state), device="cpu",
        method="cse_fsl"))
    return jpop, pop


def _check_against_reference(jpop, pop, rounds, chunk):
    cm, jcm = _narrow_cost_models()
    meter, jmeter = CommMeter(), JCommMeter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jstate, jhist = jpop.run(rounds, chunk=chunk, log_every=1,
                                 meter=jmeter, cost_model=jcm)
        state, hist = pop.run(rounds, chunk=chunk, log_every=1, meter=meter,
                              cost_model=cm)
    # host numbers: exactly
    assert sorted(pop._cohorts) == sorted(jpop._cohorts)
    for w, ids in jpop._cohorts.items():
        np.testing.assert_array_equal(pop._cohorts[w], ids)
    for r in range(rounds):
        ids = jpop.cohort_for(jpop.window_of(r))
        want = jpop.data.round_indices(ids, r)
        got = pop.data.round_indices(ids, r)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert meter.as_dict() == jmeter.as_dict()
    assert pop.memory_report() == jpop.memory_report()
    assert pop.population_summary(hist) == jpop.population_summary(jhist)
    assert pop.trainer.participation_summary() == \
        jpop.trainer.participation_summary()
    assert sorted(pop._cache) == sorted(jpop._cache)
    assert len(hist) == len(jhist) == rounds
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in set(row) & EXACT:
            assert row[k] == jrow[k], (row["round"], k)
        for k in set(row) - EXACT:
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4,
                                       err_msg=f"round {row['round']} {k}")
    got = state_to_numpy(state, method="cse_fsl")
    want = jax.tree_util.tree_map(np.asarray, jstate)
    assert int(got["round"]) == int(want["round"])
    for key in ("clients", "server"):
        for (path, a), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                jax.tree_util.tree_leaves_with_path(want[key]["params"])):
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5,
                                       err_msg=key + jax.tree_util.keystr(
                                           path))
    return hist


@pytest.mark.parametrize("refresh", [True, False])
def test_engine_matches_reference(refresh):
    jpop, pop = _pair(refresh)
    _check_against_reference(jpop, pop, rounds=7, chunk=3)
    assert bool(pop._cache) == (not refresh)
    assert pop.memory_report()["engine"]["cache_entries"] == \
        (0 if refresh else 9)


def test_engine_under_faults_matches_reference():
    """The lossy preset at a 40 % loss rate with one retry: windows lose
    slots, the meter bills every retry and frame, and one window may
    admit nobody (the empty-window repair)."""
    jpop, pop = _pair(fault="lossy")
    hist = _check_against_reference(jpop, pop, rounds=8, chunk=3)
    f = pop.trainer.participation_summary()["faults"]
    assert f["retries"] > 0 and f["wire_drops"] > 0
    assert any(r.get("participants", 3) < 3 for r in hist)
    assert dataclasses.asdict(pop.trainer._fault_stats) == \
        dataclasses.asdict(jpop.trainer._fault_stats)


# ---------------------------------------------------------------------------
# 3. checkpoint round trip
# ---------------------------------------------------------------------------


def _virtual_population(refresh=True, population_=5000, faults=None):
    fsl = FSLConfig(num_clients=3, h=2, method="cse_fsl", agg_every=4)
    return Population(_smoke_bundle(), fsl, population=population_,
                      data=_virtual(population, (8, 8, 1)),
                      sampler="stratified", network=network.TieredNetwork(),
                      refresh=refresh, faults=faults)


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("refresh", [True, False])
def test_checkpoint_roundtrip(refresh, fresh, tmp_path):
    """5 rounds, save, 7 more; a restored engine's 7 rounds bitwise.  With
    ``fresh`` the restoring engine never ran ``init`` (its template is the
    method's state on ``meta`` tensors)."""
    pop1 = _virtual_population(refresh).init(seed=0)
    pop1.run(5, chunk=3)
    path = os.path.join(tmp_path, "pop")
    pop1.save(path)
    assert bool(pop1._cache) == (not refresh)
    sA, hA = pop1.run(7, chunk=4, log_every=1)
    pop2 = _virtual_population(refresh)
    if not fresh:
        pop2.init(seed=1)
    pop2.restore(path)
    sB, hB = pop2.run(7, chunk=4, log_every=1)
    _assert_bitwise(sA, sB)
    assert hA == hB
    assert sorted(pop1._cache) == sorted(pop2._cache)
    for cid, row in pop1._cache.items():
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(row), tree_leaves(pop2._cache[cid])))


@pytest.mark.parametrize("fault", ["lossy", "crashy"])
def test_checkpoint_mid_window_under_faults(fault, tmp_path):
    """Saved after round 3 (mid-window: a window is 2 rounds) under faults:
    the resumed rounds, stats and rows equal the uninterrupted run's."""
    def make():
        return _virtual_population(faults=make_fault(fault, **FAULTS[fault]))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        whole = make().init(seed=0)
        sA, hA = whole.run(8, chunk=3, log_every=1)
        pop1 = make().init(seed=0)
        pop1.run(3, chunk=3)
        path = os.path.join(tmp_path, "pop")
        pop1.save(path)
        assert pop1.window_of(3) == pop1.window_of(2)   # mid-window
        pop2 = make().restore(path)
        sB, hB = pop2.run(5, chunk=3, log_every=1)
    _assert_bitwise(sA, sB)
    rows = [{k: v for k, v in r.items()
             if k not in ("dropped_updates", "fault_retries", "fault_drops")}
            for r in hA[3:]]
    assert rows == [{k: v for k, v in r.items()
                     if k not in ("dropped_updates", "fault_retries",
                                  "fault_drops")} for r in hB]
    assert any(r.get("participants", 3) < 3 for r in hA)


# ---------------------------------------------------------------------------
# 4. lazy state
# ---------------------------------------------------------------------------


def test_memory_independent_of_population():
    reports = []
    for population_ in (1000, 100_000):
        pop = _virtual_population(population_=population_).init(seed=0)
        pop.run(4, chunk=4)
        reports.append(pop.memory_report())
    a, b = reports
    assert a["engine_total"] == b["engine_total"]
    assert b["dense_extrapolated"] == 100 * a["dense_extrapolated"] \
        - 99 * a["engine"]["server_state"]
    assert b["engine_total"] < b["dense_extrapolated"] / 100


def test_refresh_true_cache_stays_empty():
    pop = _virtual_population(True).init(seed=0)
    pop.run(8, chunk=3)
    assert pop._cache == {}


def test_refresh_false_cache_shares_rows():
    pop = _virtual_population(False).init(seed=0)
    state, _ = pop.run(8, chunk=3)
    assert pop._cache
    # one shared row tree per finished window, not one per client
    unique = {id(r) for r in pop._cache.values()}
    windows = {w for w in pop._windows_seen
               if w < pop.window_of(int(state["round"]))}
    assert len(unique) == len(windows) == 4
    assert all(len([c for c, r in pop._cache.items() if id(r) == u]) == 3
               for u in unique)
    rep = pop.memory_report()
    assert rep["engine"]["cache_rows"] \
        == len(unique) * rep["engine"]["default_row"]
    # a cached client's row is the state its last window left
    cid = int(pop._cohorts[0][0])
    assert not torch.equal(tree_leaves(pop._cache[cid])[0],
                           tree_leaves(pop._default)[0])


def _storages(tree) -> set:
    return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


@pytest.mark.parametrize("setting", ["refresh", "cache", "faults"])
def test_rows_are_copies(setting):
    """No row the engine keeps (the default row, the cache rows, the
    fault runs' entry row) shares storage with the running state, and
    the default row stays the initial state's row 0 after training."""
    kw = dict(refresh=setting != "cache")
    if setting == "faults":
        kw["faults"] = make_fault("crashy", **FAULTS["crashy"])
    pop = _virtual_population(**kw).init(seed=0)
    init_row = [t.clone() for t in tree_leaves(pop._default)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state, _ = pop.run(5, chunk=2)
    live = _storages(state_leaves(state))
    rows = [pop._default] + list(pop._cache.values())
    if pop._entry_row is not None:
        rows.append(pop._entry_row)
    for row in rows:
        assert not (_storages(row) & live)
    assert all(torch.equal(a, b)
               for a, b in zip(init_row, tree_leaves(pop._default)))
    if setting == "cache":
        assert pop._cache
    if setting == "faults":
        assert pop._entry_row is not None


# ---------------------------------------------------------------------------
# 5. cohort samplers and the virtual pool against the reference
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert sorted(sched.COHORT_SAMPLERS) == sorted(jsched.COHORT_SAMPLERS)
    assert isinstance(sched.resolve_cohort(None, seed=3),
                      sched.UniformCohort)
    assert sched.resolve_cohort("stratified", seed=3).seed == 3
    with pytest.raises(KeyError, match="unknown cohort sampler"):
        sched.get_cohort_sampler("bogus")
    with pytest.raises(TypeError):
        sched.resolve_cohort(42)


@pytest.mark.parametrize("name", ["uniform", "stratified"])
@pytest.mark.parametrize("population_,cohort", [
    (8, 8), (8, 12), (7, 3), (50, 3), (1000, 16), (1_000_000, 3),
    (1_000_000, 16), (3, 2), (4, 4)])
def test_samplers_match_reference(name, population_, cohort):
    """Ids drawn by each package's sampler on its own network, equal id
    for id over windows and seeds; C >= N gives the whole fleet; at C = 3
    every tier holds one seat; on the ideal network stratified is
    uniform."""
    for net_name in ("tiered", "ideal"):
        jnet = jnetwork.network_from_flags(net_name)
        net = network.network_from_flags(net_name)
        for seed in (0, 7):
            js = jsched.get_cohort_sampler(name, seed=seed)
            s = sched.get_cohort_sampler(name, seed=seed)
            for window in (0, 1, 5):
                want = js.sample(window, population_, cohort, network=jnet)
                got = s.sample(window, population_, cohort, network=net)
                assert got.dtype == want.dtype == np.int64
                np.testing.assert_array_equal(got, want)
                assert len(got) == min(cohort, population_)
                assert np.all(np.diff(got) > 0)


def test_stratified_allocation_matches_reference():
    jnet, net = jnetwork.TieredNetwork(), network.TieredNetwork()
    js, s = jsched.StratifiedCohort(seed=1), sched.StratifiedCohort(seed=1)
    for sizes, c in (((250, 500, 250), 16), ((1, 1, 998), 3),
                     ((0, 5, 1), 4), ((2, 0, 9), 11), ((3, 3, 3), 2)):
        a = np.asarray(sizes, np.int64)
        np.testing.assert_array_equal(s._allocate(a, c), js._allocate(a, c))
    ids = s.sample(0, 1_000_000, 3, network=net)
    spans = net.tier_ranges(1_000_000)
    assert [int(np.sum((ids >= lo) & (ids < hi))) for _, lo, hi in spans] \
        == [1, 1, 1]
    assert spans == jnet.tier_ranges(1_000_000)


def test_virtual_pool_matches_reference():
    jvp = _virtual(jpopulation)
    vp = _virtual(population)
    np.testing.assert_array_equal(vp.pool_x, jvp.pool_x)
    np.testing.assert_array_equal(vp.pool_y, jvp.pool_y)
    for cid in (0, 1, 7, 4999, 999_999, 2**40 + 3):
        assert vp.shard_start(cid) == jvp.shard_start(cid)
    for rnd in (0, 3, 100):
        ids = np.array([0, 5, 123_456, 999_999], np.int64)
        want = jvp.round_indices(ids, rnd)
        got = vp.round_indices(ids, rnd)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    px, py = vp.device_pool("cpu")
    assert vp.device_pool("cpu")[0] is px
    np.testing.assert_array_equal(px.numpy(), jvp.pool_x)
    assert py.dtype == torch.int32
    with pytest.raises(ValueError, match="d_local"):
        VirtualPool(vp.pool_x, vp.pool_y, d_local=0, batch_size=4, h=2)
    with pytest.raises(ValueError, match="population"):
        Population(_smoke_bundle(), FSLConfig(num_clients=3, h=2),
                   population=2, data=vp)
    with pytest.raises(ValueError, match="refresh=True"):
        _virtual_population(refresh=False, faults=make_fault("lossy"))


def test_federated_pool_matches_dense_batcher():
    fed = _smoke_data(3)
    fp = FederatedPool(fed, 4, 2, seed=0)
    ref = FederatedBatcher(fed, 4, 2, seed=0)
    px, py = fp.device_pool("cpu")
    for rnd in range(3):
        x, y = ref.next_round()
        idx = fp.round_indices(np.arange(3), rnd)
        np.testing.assert_array_equal(px.numpy()[idx], x)
        np.testing.assert_array_equal(py.numpy()[idx], y)


# ---------------------------------------------------------------------------
# 6. the LM device pool
# ---------------------------------------------------------------------------


LM_KW = dict(dtype="float32", use_pallas=True, swa_window=64)


@functools.lru_cache(maxsize=None)
def _lm():
    cfg = get_config("qwen3-0.6b").reduced().with_(**LM_KW)
    return cfg, transformer_bundle(cfg, device="cpu")


def test_lm_pooled_run_compiled_bitwise_staged(monkeypatch):
    """Reduced Qwen3 (fp32), 2 clients, 3 rounds at chunk 2:
    ``run_compiled`` takes the pool path by default (no ``_stack_rounds``
    call) and equals the staged run bitwise."""
    import repro_torch.core.trainer as trainer_mod
    cfg, bundle = _lm()
    fsl = FSLConfig(num_clients=2, h=2, lr=0.1, method="cse_fsl")
    fed = build_data(cfg, fsl, 32, 4, non_iid=False, seed=0)
    calls = {"n": 0}
    orig = trainer_mod._stack_rounds

    def counting(*xs):
        calls["n"] += 1
        return orig(*xs)

    monkeypatch.setattr(trainer_mod, "_stack_rounds", counting)
    outs = []
    for device_data in (True, False):
        tr = Trainer(bundle, fsl)
        batcher = LMBatcher(cfg, fed, 1, 2, seed=0)
        state, hist = tr.run_compiled(tr.init(0), batcher, 3, chunk=2,
                                      log_every=1, device_data=device_data)
        outs.append((state, hist, calls["n"]))
    (s1, h1, c1), (s2, h2, c2) = outs
    assert c1 == 0 and c2 > 0
    _assert_bitwise(s1, s2)
    assert h1 == h2
    b = LMBatcher(cfg, fed, 1, 2, seed=0)
    assert b.device_pool("cpu") is b.device_pool("cpu")
    assert set(b.device_pool("cpu")[0]) == {"tokens"}


def test_lm_pool_through_the_engine():
    """``LMPool(VirtualPool)`` of token sequences: two rounds of a fleet of
    10^6 on reduced Qwen3, finite losses, the pool's leaf mapping."""
    cfg, bundle = _lm()
    x, y = synthetic_lm(16, 33, cfg.vocab_size, seed=0)
    vp = VirtualPool(x, y, d_local=4, batch_size=1, h=1, seed=0)
    data = LMPool(cfg, vp)
    assert data.stateless and set(data.device_pool("cpu")[0]) == {"tokens"}
    pop = Population(bundle, FSLConfig(num_clients=2, h=1, lr=0.1),
                     population=10**6, data=data, sampler="stratified",
                     network=network.TieredNetwork()).init(seed=0)
    state, hist = pop.run(2, chunk=2, log_every=1)
    assert len(hist) == 2 and all(np.isfinite(r["client_loss"])
                                  for r in hist)
    rep = pop.memory_report()
    assert rep["engine"]["pool"] == x.nbytes + y.nbytes
    assert rep["dense_extrapolated"] > 1000 * rep["engine_total"]


# ---------------------------------------------------------------------------
# 7. the driver
# ---------------------------------------------------------------------------


def test_fig_population_memory_matches_reference():
    from benchmarks import fig_population as jfig
    from repro_torch.benchmarks import fig_population
    kw = dict(populations=(1000, 100_000), cohort=4)
    jreps, jsummary = jfig.bench_memory(4, 2, **kw)
    reps, summary = fig_population.bench_memory(4, 2, device="cpu", **kw)
    strip = [{k: v for k, v in r.items() if k != "run_seconds"}
             for r in reps]
    assert strip == [{k: v for k, v in r.items() if k != "run_seconds"}
                     for r in jreps]
    assert summary == jsummary
