"""The hybrid family through the training engines on the CPU: zamba2-7b
reduced to 7 layers (d 256, 16 SSD heads of 32, N 16, chunk 16, a shared
site every 2 layers: a client group, then 2 server groups and a tail of
1), the port against the JAX package.

- Two rounds of CSE-FSL and of FSL_OC through ``Trainer.run`` in fp32
  from the reference's converted initial state (B 2 x S 64: 4 chunks;
  ``swa_window`` 32 cuts the shared attention): the per-round losses at
  rtol 1e-4, the final params at rtol 1e-4 and an atol of 1e-5 of each
  leaf's largest magnitude (fp32 sums in other orders through seven
  layers, as ``tests/test_torch_hybrid.py``), the meter and the flags
  exact.
- The bf16 model with the int8 uplink and the int8 model-sync wire, the
  fp32 SSD leaves and ``shared_attn`` among the synced leaves: the meter
  equal to the reference's to the byte, and round 1's losses at rtol
  2e-2 (bf16 rounded at other points, the codecs' bits the port's own).
- ``run_compiled`` bitwise ``run`` (int8 on every channel) and, with
  ``remat`` on, ``run`` bitwise the plain run: state, losses and meter;
  FSL_MC and FSL_AN (stacked server replicas) compiled bitwise the loop.
- The event engine at zero latency, ``Population`` at C == N and the
  training CLI (``--arch zamba2-7b``) each run a round.
"""
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.launch.train import LMBatcher as JLMBatcher
from repro.launch.train import build_data as jbuild_data
from repro.models.model import abstract_params as jabstract_params
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.async_trainer import AsyncTrainer
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.graphs import state_leaves
from repro_torch.core.trainer import Trainer
from repro_torch.launch import train
from repro_torch.launch.train import LMBatcher, LMPool, build_data
from repro_torch.population import FederatedPool, Population

NAME = "zamba2-7b"
N, H, B, S, SAMPLES, ROUNDS = 2, 2, 2, 64, 4, 2
RTOL, ATOL = 1e-4, 1e-5
KW = dict(swa_window=32, num_layers=7)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(fkw, rounds, **kw):
    """The reference's and the port's run from the reference's init:
    ``(state, hist, meter)`` of each."""
    kw = {**KW, **kw}
    jcfg = jget_config(NAME).reduced().with_(**kw)
    cfg = get_config(NAME).reduced().with_(use_pallas=True, **kw)
    jb = jtransformer_bundle(jcfg)
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False)
    jstate = jtr.init(0)
    pa = jabstract_params(jcfg)
    jcm = JCostModel(n=N, q=jb.smashed_bytes_per_sample, d_local=SAMPLES,
                     w_client=jbytes_of(pa["client"]),
                     w_server=jbytes_of(pa["server"]),
                     aux=jbytes_of(pa["aux"]))
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu", method=fkw["method"])
    jfed = jbuild_data(jcfg, JFSLConfig(**fkw), S, SAMPLES, False)
    jmeter = JCommMeter()
    jstate, jhist = jtr.run(jstate, JLMBatcher(jcfg, jfed, B, H), rounds,
                            log_every=1, meter=jmeter, cost_model=jcm)

    b = transformer_bundle(cfg, device="cpu")
    tr = Trainer(b, FSLConfig(**fkw))
    cm = CostModel(n=N, q=b.smashed_bytes_per_sample, d_local=SAMPLES,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    assert dict(vars(cm)) == dict(vars(jcm))
    fed = build_data(cfg, FSLConfig(**fkw), S, SAMPLES, False)
    meter = CommMeter()
    state, hist = tr.run(state0, LMBatcher(cfg, fed, B, H), rounds,
                         log_every=1, meter=meter, cost_model=cm)
    return (state, hist, meter), (jstate, jhist, jmeter)


def _rows_agree(hist, jhist, rtol):
    assert len(hist) == len(jhist)
    for row, jrow in zip(hist, jhist):
        for k in ("round", "aggregated", "comm_bytes"):
            assert row.get(k) == jrow.get(k), k
        for k in [k for k in jrow if k.endswith("loss")]:
            np.testing.assert_allclose(row[k], jrow[k], rtol=rtol,
                                       err_msg=f"round {row['round']} {k}")


@pytest.mark.parametrize("method", ["cse_fsl", "fsl_oc"])
def test_trainer_run_matches_reference(method):
    fkw = dict(num_clients=N, h=H, lr=0.1, method=method,
               grad_clip=1.0 if method == "fsl_oc" else 0.0)
    (state, hist, meter), (jstate, jhist, jmeter) = _pair(
        fkw, ROUNDS, dtype="float32")
    assert meter.as_dict() == jmeter.as_dict()
    _rows_agree(hist, jhist, RTOL)
    got = state_to_numpy(state, method=method)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    for key in ("clients", "server"):
        pairs = list(zip(
            jax.tree_util.tree_leaves_with_path(got[key]["params"]),
            jax.tree_util.tree_leaves_with_path(want[key]["params"])))
        assert any("shared_attn" in jax.tree_util.keystr(p)
                   for (p, _), _ in pairs)
        for (path, a), (wpath, w) in pairs:
            assert path == wpath
            np.testing.assert_allclose(
                a, w, rtol=RTOL, atol=ATOL * max(np.abs(w).max(), 1.0),
                err_msg=jax.tree_util.keystr(path))


def test_bf16_int8_model_sync_bytes_match_reference():
    """bf16 reduced zamba2, int8 on the uplink and the model sync (the
    fp32 SSD leaves coded beside the bf16 ones): the meter to the byte."""
    fkw = dict(num_clients=N, h=H, lr=0.1, method="cse_fsl", codec="int8",
               model_codec="int8")
    (state, hist, meter), (_, jhist, jmeter) = _pair(fkw, 1)
    assert meter.as_dict() == jmeter.as_dict()
    assert meter.counts["model_sync"] > 0
    _rows_agree(hist, jhist, 2e-2)
    st = state["clients"]["params"]["client"]["blocks_stage"]
    assert st["blocks"]["a_log"].dtype == torch.float32
    assert st["blocks"]["a_log"].shape[:2] == (N, 2)
    assert st["shared_attn"]["attn"]["wq"].shape == (N, 256, 256)


def _cfg(remat=False):
    return get_config(NAME).reduced().with_(
        dtype="float32", use_pallas=True, remat=remat, **KW)


def _trainer(remat=False, **fkw):
    cfg = _cfg(remat)
    fsl = FSLConfig(num_clients=N, h=H, lr=0.1, **fkw)
    fed = build_data(cfg, fsl, S, SAMPLES, non_iid=False, seed=0)
    tr = Trainer(transformer_bundle(cfg, device="cpu"), fsl)
    return tr, lambda: LMBatcher(cfg, fed, B, H, seed=0)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(state_leaves(a),
                                                  state_leaves(b)))


def test_run_compiled_and_remat_are_bitwise_the_loop():
    tr, batcher = _trainer(codec="int8", model_codec="int8")
    m1, m2 = CommMeter(), CommMeter()
    s1, h1 = tr.run(tr.init(0), batcher(), ROUNDS, log_every=1, meter=m1)
    s2, h2 = tr.run_compiled(tr.init(0), batcher(), ROUNDS, chunk=ROUNDS,
                             log_every=1, meter=m2)
    assert _same(s1, s2) and h1 == h2 and m1.as_dict() == m2.as_dict()
    tr_r, batcher_r = _trainer(remat=True, codec="int8", model_codec="int8")
    m3 = CommMeter()
    s3, h3 = tr_r.run(tr_r.init(0), batcher_r(), ROUNDS, log_every=1,
                      meter=m3)
    assert _same(s1, s3) and h1 == h3 and m1.as_dict() == m3.as_dict()


@pytest.mark.parametrize("method", ["fsl_mc", "fsl_an"])
def test_replicated_server_methods_compile_bitwise(method):
    """The two methods with stacked server replicas: a round through
    ``run_compiled`` bitwise ``Trainer.run`` (int8 on every channel),
    losses finite, the replicas' ``shared_attn`` stacked by replica."""
    tr, batcher = _trainer(method=method, codec="int8", model_codec="int8")
    m1, m2 = CommMeter(), CommMeter()
    s1, h1 = tr.run(tr.init(0), batcher(), 1, log_every=1, meter=m1)
    s2, h2 = tr.run_compiled(tr.init(0), batcher(), 1, chunk=1,
                             log_every=1, meter=m2)
    assert _same(s1, s2) and h1 == h2 and m1.as_dict() == m2.as_dict()
    assert np.isfinite([h1[0][k] for k in h1[0] if k.endswith("loss")]).all()
    wq = s1["servers"]["params"]["blocks_stage"]["shared_attn"]["attn"]["wq"]
    assert wq.shape == (N, 256, 256)


def test_event_engine_and_population_match_the_loop():
    """Zero latency: the event engine's round against ``Trainer.run``'s
    from ``init(0)`` (within 1e-5: it runs each client alone, the loop
    vmaps them); ``Population`` at C == N over the same data bitwise
    ``Trainer.run`` (its rounds are ``run_compiled``'s replays)."""
    tr, batcher = _trainer()
    want, hist = tr.run(tr.init(0), batcher(), 1, log_every=1)
    eng = AsyncTrainer(tr.bundle, tr.fsl)
    got, ehist = eng.run(eng.init(0), batcher(), 1, log_every=1)
    for a, b in zip(state_leaves(got), state_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert np.isfinite([r[k] for r in ehist for k in r
                        if k.endswith("loss")]).all()
    cfg = _cfg()
    fed = build_data(cfg, tr.fsl, S, SAMPLES, non_iid=False, seed=0)
    pop = Population(tr.bundle, tr.fsl, population=N,
                     data=LMPool(cfg, FederatedPool(fed, batch_size=B, h=H)))
    pop.init(seed=0)
    pgot, phist = pop.run(1, chunk=1, log_every=1)
    assert phist == hist and _same(pgot, want)


def test_cli_trains_reduced_zamba2(tmp_path):
    out = tmp_path / "o.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, hist = train.main(["--arch", NAME, "--size", "reduced",
                                  "--device", "cpu", "--rounds", "1",
                                  "--clients", "2", "--h", "2", "--batch",
                                  "1", "--seq", "64", "--samples", "4",
                                  "--codec", "int8", "--model-codec",
                                  "int8", "--log-every", "1", "--out",
                                  str(out)])
    rec = json.loads(out.read_text())
    assert rec["args"]["arch"] == NAME
    assert np.isfinite([hist[0][k] for k in hist[0]
                        if k.endswith("loss")]).all()
    assert rec["comm"]["model_sync"] > 0
    st = state["clients"]["params"]["client"]["blocks_stage"]
    assert "shared_attn" in st and st["blocks"]["in_proj"].shape[1] == 2
