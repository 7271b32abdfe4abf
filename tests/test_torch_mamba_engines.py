"""The falcon-mamba path through the event engine (``AsyncTrainer``) and
the population engine (``Population``), the port against the JAX package.

Reduced falcon-mamba-7b in fp32 (2 layers cut at 1, d 256, N 16), S = 32,
B = 1, n = 2 clients, h = 2.  The port runs its main path
(``use_pallas=True``: the selective-scan and fused-CE ops with their plain
versions on the CPU), the reference its plain path; both start from the
reference's initial state (``repro_torch.convert``).

- Event engine: a lognormal latency and the lossy wire (loss 0.4, one
  retry), 3 rounds at C = h: ``AsyncStats``, the arrival order, the fault
  statistics, the meter and the rows' exact columns equal; losses at rtol
  1e-4 and params at rtol 1e-4 / atol 1e-5, as
  ``tests/test_torch_async_trainer.py`` holds the identity wire.
- Population engine: ``LMPool(VirtualPool)`` token pools, N = 5000
  stratified on the tiered network, C = 2, windows of two rounds, 4 rounds
  at chunk 3: cohorts, index plans, meter, memory report, population
  summary and rows exact; losses and params as
  ``tests/test_torch_population.py`` holds them; and C == N over a
  ``FederatedPool`` bitwise the port's own ``Trainer.run``.
"""
import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import network as jnetwork
from repro import population as jpopulation
from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.core import async_trainer as jat
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.faults import make_fault as jmake_fault
from repro.launch.train import LMBatcher as JLMBatcher
from repro.launch.train import LMPool as JLMPool
from repro.launch.train import build_data as jbuild_data
from repro_torch import data, network, population
from repro_torch.common import bytes_of, tree_leaves
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import async_trainer as at
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.faults import make_fault
from repro_torch.launch.train import LMBatcher, LMPool, build_data

NAME = "falcon-mamba-7b"
N, H, B, S, SAMPLES = 2, 2, 1, 32, 4
EXACT = {"round", "aggregated", "comm_bytes", "participants",
         "dropped_updates", "fault_retries", "fault_drops"}
LOSSY = dict(loss_rate=0.4, max_retries=1, seed=3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _bundles():
    jcfg = jget_config(NAME).reduced().with_(dtype="float32")
    cfg = get_config(NAME).reduced().with_(dtype="float32", use_pallas=True)
    return (jcfg, jtransformer_bundle(jcfg), cfg,
            transformer_bundle(cfg, device="cpu"))


def _cost_models():
    jcfg, jb, cfg, b = _bundles()
    kw = dict(n=N, q=b.smashed_bytes_per_sample * S, d_local=SAMPLES,
              w_client=bytes_of(b.specs["client"]),
              w_server=bytes_of(b.specs["server"]),
              aux=bytes_of(b.specs["aux"]))
    return CostModel(**kw), JCostModel(**kw)


def _params_close(got_state, want_state, keys=("clients", "server")):
    got = state_to_numpy(got_state)
    want = jax.tree_util.tree_map(np.asarray, want_state)
    assert int(got["round"]) == int(want["round"])
    for key in keys:
        for (path, a), (wpath, w) in zip(
                jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                jax.tree_util.tree_leaves_with_path(want[key]["params"])):
            assert path == wpath
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5,
                                       err_msg=key + jax.tree_util.keystr(
                                           path))


def _rows_close(hist, jhist, rounds):
    assert len(hist) == len(jhist) == rounds
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in set(row) & EXACT:
            assert row[k] == jrow[k], (row["round"], k)
        for k in set(row) - EXACT:
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4,
                                       err_msg=f"round {row['round']} {k}")


def test_event_engine_matches_reference():
    jcfg, jb, cfg, b = _bundles()
    fkw = dict(num_clients=N, h=H, lr=0.1)
    lat = dict(compute=1.0, sigma=1.0, spread=1.0)
    common = dict(seed=5, server_time=0.05)
    eng = at.AsyncTrainer(b, FSLConfig(**fkw),
                          latency=at.LognormalLatency(**lat),
                          faults=make_fault("lossy", **LOSSY), **common)
    jeng = jat.AsyncTrainer(jb, JFSLConfig(**fkw),
                            latency=jat.LognormalLatency(**lat),
                            faults=jmake_fault("lossy", **LOSSY), **common)
    jstate = jeng.init(0)
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                             device="cpu")
    cm, jcm = _cost_models()
    meter, jmeter = CommMeter(), JCommMeter()
    jfed = jbuild_data(jcfg, JFSLConfig(**fkw), S, SAMPLES, False)
    fed = build_data(cfg, FSLConfig(**fkw), S, SAMPLES, False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jstate, jhist = jeng.run(jstate, JLMBatcher(jcfg, jfed, B, H), 3,
                                 log_every=1, meter=jmeter, cost_model=jcm)
        state, hist = eng.run(state, LMBatcher(cfg, fed, B, H), 3,
                              log_every=1, meter=meter, cost_model=cm)
    assert eng.stats.as_dict() == jeng.stats.as_dict()
    assert eng.stats.arrival_order == jeng.stats.arrival_order
    assert eng.stats.agg_participants == jeng.stats.agg_participants
    assert meter.as_dict() == jmeter.as_dict()
    assert dataclasses.asdict(eng.fault_stats) == \
        dataclasses.asdict(jeng.fault_stats)
    assert eng.fault_stats.retries > 0
    _rows_close(hist, jhist, 3)
    _params_close(state, jstate)


def _token_pool(pkg, dpkg, cfg):
    x, y = dpkg.synthetic_lm(48, S + 1, cfg.vocab_size, seed=0)
    return pkg.VirtualPool(x, y, d_local=8, batch_size=B, h=H, seed=0)


def test_population_engine_matches_reference():
    jcfg, jb, cfg, b = _bundles()
    fkw = dict(num_clients=N, h=H, lr=0.1, agg_every=2 * H)
    kw = dict(population=5000, sampler="stratified")
    jpop = jpopulation.Population(
        jb, JFSLConfig(**fkw),
        data=JLMPool(jcfg, _token_pool(jpopulation, jdata, jcfg)),
        network=jnetwork.TieredNetwork(), donate=False, **kw)
    jpop.init(seed=0)
    pop = population.Population(
        b, FSLConfig(**fkw),
        data=LMPool(cfg, _token_pool(population, data, cfg)),
        network=network.TieredNetwork(), **kw)
    pop.init(state=state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpop._state), device="cpu"))
    cm, jcm = _cost_models()
    meter, jmeter = CommMeter(), JCommMeter()
    jstate, jhist = jpop.run(4, chunk=3, log_every=1, meter=jmeter,
                             cost_model=jcm)
    state, hist = pop.run(4, chunk=3, log_every=1, meter=meter,
                          cost_model=cm)
    assert sorted(pop._cohorts) == sorted(jpop._cohorts)
    for w, ids in jpop._cohorts.items():
        np.testing.assert_array_equal(pop._cohorts[w], ids)
        for r in range(4):
            np.testing.assert_array_equal(
                pop.data.round_indices(ids, r),
                jpop.data.round_indices(ids, r))
    assert meter.as_dict() == jmeter.as_dict()
    assert pop.memory_report() == jpop.memory_report()
    assert pop.population_summary(hist) == jpop.population_summary(jhist)
    _rows_close(hist, jhist, 4)
    _params_close(state, jstate)


def test_population_c_equals_n_bitwise_trainer_run():
    """C == N over a FederatedPool: the population engine is the port's
    ``Trainer.run`` on the same data, bitwise."""
    _, _, cfg, b = _bundles()
    fsl = FSLConfig(num_clients=N, h=H, lr=0.1)
    fed = build_data(cfg, fsl, S, SAMPLES, False)
    tr = Trainer(b, fsl)
    want, whist = tr.run(tr.init(0), LMBatcher(cfg, fed, B, H), 3,
                         log_every=1)
    pop = population.Population(
        b, fsl, population=N,
        data=LMPool(cfg, population.FederatedPool(fed, batch_size=B, h=H)))
    pop.init(seed=0)
    got, hist = pop.run(3, chunk=2, log_every=1)
    assert hist == whist
    for x, y in zip(tree_leaves(want), tree_leaves(got)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
