"""Fault injection on the sync path: the port's ``repro_torch.faults``
and the Trainer's fault integration against the JAX package.

- ``FaultModel.trace`` for every preset, the JAX suite's ``MIX`` and
  others, bitwise (every array, dtypes included), with its prefix
  consistency (a shorter horizon's trace is a prefix of a longer one's);
  ``draw`` from an explicit generator; ``survives``.
- The billing: ``round_wire_bytes`` and ``accumulate_round`` round by
  round (with and without a mask, blocking or not) into equal
  ``FaultStats.as_dict()``; ``expected_attempts``, ``expected_backoff``,
  ``backoff_schedule`` and ``backoff_seconds``; the registry and the flags.
- ``Trainer.run`` under ``MIX`` (and ``MIX`` with a deadline) on all four
  methods from the reference's initial state, the narrow CNN: rows
  (``participants``, ``dropped_updates``, ``fault_retries``,
  ``fault_drops``, ``comm_bytes``), meter (``fault_frames`` included) and
  ``participation_summary`` equal; losses at rtol 1e-4 and params at atol
  1e-5 (the identity wire, as ``tests/test_torch_baselines.py`` states);
  then CSE-FSL on reduced Qwen3 (fp32, the JAX side's Pallas kernels in
  interpret mode) for 2 rounds at the same tolerances.
- The port's ``run_compiled`` bitwise equal to its ``run`` under ``MIX``
  (int8 on every channel, the model sync included), pooled and staged,
  with a trailing partial chunk.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import faults as jfaults
from repro import network as jnetwork
from repro import sched as jsched
from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.launch.train import LMBatcher as JLMBatcher
from repro.launch.train import build_data as jbuild_data
from repro.models.cnn import CNNConfig as JCNNConfig
from repro_torch import data
from repro_torch import faults
from repro_torch import network
from repro_torch import sched
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle, transformer_bundle
from repro_torch.core.graphs import state_leaves
from repro_torch.core.methods import get_method
from repro_torch.core.trainer import Trainer
from repro_torch.launch.train import LMBatcher, build_data
from repro_torch.models.cnn import CNNConfig
from repro_torch.transport import make_transport

ALL_METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")
N, H, C, B = 3, 3, 2, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
LM_N, LM_H, LM_S, LM_SAMPLES = 2, 2, 256, 4
LM_KW = dict(dtype="float32", use_pallas=True, swa_window=64)
# tests/test_faults.py's mixture, in both packages
MIX_KW = dict(loss_rate=0.25, crash_rate=0.25, outage_rate=0.2, seed=11,
              name="mix")
MODELS = {
    "none": dict(),
    "lossy": dict(),
    "crashy": dict(),
    "outage": dict(),
    "mix": MIX_KW,
    "harsh": dict(loss_rate=0.6, crash_rate=0.4, max_retries=1, seed=3,
                  backoff_base=0.3, backoff_cap=0.5, name="harsh"),
    "patient": dict(loss_rate=0.4, max_retries=6, seed=7, name="patient"),
}


def _models(name):
    """The model ``name`` in both packages: a preset by name, else a
    FaultModel with ``MODELS[name]``."""
    if not MODELS[name]:
        return faults.make_fault(name), jfaults.make_fault(name)
    return (faults.FaultModel(**MODELS[name]),
            jfaults.FaultModel(**MODELS[name]))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops run on one intra-op thread (pytest-xdist workers share the
    cores); both sides of every comparison run under the same setting."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _traces_equal(a, b):
    for f in ("up_attempts", "up_ok", "down_attempts", "down_ok", "crash",
              "outage"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------------------------
# Traces, survival, billing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 1), (6, 3, 3), (9, 4, 1),
                                   (0, 2, 2)])
@pytest.mark.parametrize("name", list(MODELS))
def test_trace_matches_reference(name, shape):
    """The canonical trace, per round seeded ``(seed, FAULT_STREAM, r)``,
    bitwise; each prefix equals the shorter horizon's trace; ``draw`` from
    one explicit generator; ``survives`` blocking and not."""
    fm, jfm = _models(name)
    t, jt = fm.trace(*shape), jfm.trace(*shape)
    _traces_equal(t, jt)
    for r in range(shape[0]):
        short = fm.trace(r, *shape[1:])
        for f in ("up_attempts", "up_ok", "down_attempts", "down_ok",
                  "crash", "outage"):
            np.testing.assert_array_equal(getattr(short, f),
                                          getattr(t, f)[:r])
    _traces_equal(fm.draw(np.random.default_rng(5), *shape),
                  jfm.draw(np.random.default_rng(5), *shape))
    for blocking in (False, True):
        np.testing.assert_array_equal(t.survives(blocking),
                                      jt.survives(blocking))


@pytest.mark.parametrize("blocking", [False, True])
@pytest.mark.parametrize("name", ["lossy", "crashy", "outage", "mix",
                                  "harsh"])
def test_billing_matches_reference(name, blocking):
    """Every round of an 8-round trace billed at payload sizes of a coded
    wire, with all clients and with a mask of two: the byte dicts and the
    stats equal, unit for unit."""
    fm, jfm = _models(name)
    t, jt = fm.trace(8, 4, 3), jfm.trace(8, 4, 3)
    for mask in (None, np.array([True, False, True, False])):
        st, jst = faults.FaultStats(), jfaults.FaultStats()
        for r in range(8):
            args = (r, 55_728, 96, 55_728 if blocking else 0, blocking,
                    faults.FRAME_BYTES)
            assert faults.round_wire_bytes(t, *args, mask=mask) == \
                jfaults.round_wire_bytes(jt, *args, mask=mask)
            assert faults.accumulate_round(st, fm, t, *args, mask=mask) == \
                jfaults.accumulate_round(jst, jfm, jt, *args, mask=mask)
            st.participants.append(r % 3)
            jst.participants.append(r % 3)
        assert st.as_dict() == jst.as_dict()
        assert st.to_record("f.") == jst.to_record("f.")
    assert faults.FaultStats().as_dict() == jfaults.FaultStats().as_dict()


@pytest.mark.parametrize("name", list(MODELS))
def test_expectations_match_reference(name):
    fm, jfm = _models(name)
    assert fm.expected_attempts() == jfm.expected_attempts()
    assert fm.expected_backoff() == jfm.expected_backoff()
    for a in range(0, 9):
        assert fm.backoff_schedule(a) == jfm.backoff_schedule(a)
        assert fm.backoff_seconds(a) == jfm.backoff_seconds(a)
    assert (fm.name, fm.is_null, fm.verify_frames) == \
        (jfm.name, jfm.is_null, jfm.verify_frames)


def test_registry_and_flags_match_reference():
    assert sorted(faults.FAULT_MODELS) == sorted(jfaults.FAULT_MODELS)
    assert faults.FRAME_BYTES == jfaults.FRAME_BYTES == 8
    assert faults.FAULT_STREAM == jfaults.FAULT_STREAM
    assert faults.RETRY_FOLD == jfaults.RETRY_FOLD
    assert faults.resolve_fault(None) is faults.NO_FAULTS
    mix = faults.FaultModel(**MIX_KW)
    assert faults.resolve_fault(mix) is mix
    for name in faults.FAULT_MODELS:
        for kw in ({}, {"loss_rate": 0.3, "crash_rate": 0.1,
                        "max_retries": 2, "seed": 9}):
            a = faults.fault_from_flags(name, **kw)
            b = jfaults.fault_from_flags(name, **kw)
            assert type(a).__name__ == type(b).__name__
            assert vars(a) == vars(b)
    with pytest.raises(KeyError, match="unknown fault model"):
        faults.make_fault("bogus")
    with pytest.raises(ValueError, match="duplicate fault model"):
        @faults.register_fault
        class Again(faults.FaultModel):
            name: str = "lossy"


# ---------------------------------------------------------------------------
# Trainer.run against the JAX package
# ---------------------------------------------------------------------------


def _fkw(method):
    return dict(num_clients=N, h=H, agg_every=C, lr=0.1, method=method,
                grad_clip=1.0 if method == "fsl_oc" else 0.0)


def _cnn_data(pkg):
    x, y = pkg.synthetic_classification(120, NARROW["in_shape"], 10, seed=0,
                                        signal=12.0)
    return pkg.partition_iid(x, y, N, seed=0)


@functools.lru_cache(maxsize=None)
def _bundles():
    return (jcnn_bundle(JCNNConfig(**NARROW)),
            cnn_bundle(CNNConfig(**NARROW), device="cpu"))


def _cost_models(jb, b, n, d_local, pa):
    jcm = JCostModel(n=n, q=jb.smashed_bytes_per_sample, d_local=d_local,
                     w_client=jbytes_of(pa["client"]),
                     w_server=jbytes_of(pa["server"]),
                     aux=jbytes_of(pa["aux"]))
    cm = CostModel(n=n, q=b.smashed_bytes_per_sample, d_local=d_local,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    assert dict(vars(cm)) == dict(vars(jcm))
    return cm, jcm


def _run_pair(jb, b, fkw, kw, jkw, rounds, batchers, d_local):
    """The same rounds through both trainers (``kw``/``jkw``: scheduler,
    network, faults) from the reference's initial state."""
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False, **jkw)
    tr = Trainer(b, FSLConfig(**fkw), **kw)
    pa = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    cm, jcm = _cost_models(jb, b, fkw["num_clients"], d_local, pa)
    jstate = jtr.init(0)
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                             device="cpu", method=fkw["method"])
    out = []
    for t, st, bt, mt, c_ in ((tr, state, batchers[0], CommMeter(), cm),
                              (jtr, jstate, batchers[1], JCommMeter(), jcm)):
        st, hist = t.run(st, bt, rounds, log_every=1, meter=mt, cost_model=c_)
        out.append((hist, mt, st, t))
    return out


def _check_pair(got, want, method, rtol=1e-4, atol=1e-5):
    (hist, meter, state, tr), (jhist, jmeter, jstate, jtr) = got, want
    assert len(hist) == len(jhist) > 0
    exact = {"round", "aggregated", "comm_bytes", "participants",
             "dropped_updates", "fault_retries", "fault_drops"}
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in set(row) & exact:
            assert row[k] == jrow[k], (row["round"], k)
        for k in set(row) - exact:
            np.testing.assert_allclose(row[k], jrow[k], rtol=rtol,
                                       err_msg=f"round {row['round']} {k}")
    assert meter.as_dict() == jmeter.as_dict()
    assert tr.participation_summary() == jtr.participation_summary()
    got_np = state_to_numpy(state, method=method)
    want_np = jax.tree_util.tree_map(np.asarray, jstate)
    assert int(got_np["round"]) == int(want_np["round"])
    for key in set(want_np) - {"round"}:
        for (path, a), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got_np[key]["params"]),
                jax.tree_util.tree_leaves_with_path(want_np[key]["params"])):
            np.testing.assert_allclose(a, w, rtol=rtol, atol=atol,
                                       err_msg=key + jax.tree_util.keystr(
                                           path))


def _deadline_between_slowest(method):
    """A deadline between the port's two slowest analytic client round
    times on the tiered network (the JAX package's equal them bitwise,
    ``tests/test_torch_sched.py``): it drops the 3g client."""
    tr = Trainer(_bundles()[1], FSLConfig(**_fkw(method)))
    up, reply = tr.method.payload_specs(
        tr.bundle, tr.fsl, data.FederatedBatcher(_cnn_data(data), B,
                                                 H).next_round())
    ctx = sched.SchedContext(
        fsl=tr.fsl, network=network.TieredNetwork(),
        up_bytes=tr.transport.uplink_payload_bytes(up),
        down_bytes=tr.transport.downlink_payload_bytes(reply)
        if reply is not None else 0,
        blocking=tr.method.downloads_gradients,
        uploads_per_round=tr._uploads_per_round())
    secs = np.sort(sched.DeadlinePolicy(compute_s=0.5).client_seconds(ctx))
    return float(0.5 * (secs[-2] + secs[-1]))


@pytest.mark.parametrize("with_deadline", [False, True])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_trainer_run_matches_reference(method, with_deadline):
    """4 rounds under MIX (and MIX behind a deadline that drops the 3g
    client: ``deadline_drops`` then counts the policy's share): the rows,
    the meter with its ``fault_frames`` and the stats equal; the run holds
    at least one retry and one crash or wire drop."""
    jb, b = _bundles()
    kw = dict(faults=faults.FaultModel(**MIX_KW))
    jkw = dict(faults=jfaults.FaultModel(**MIX_KW))
    if with_deadline:
        t = _deadline_between_slowest(method)
        kw.update(scheduler=sched.DeadlinePolicy(deadline_s=t, compute_s=0.5),
                  network=network.TieredNetwork())
        jkw.update(scheduler=jsched.DeadlinePolicy(deadline_s=t,
                                                   compute_s=0.5),
                   network=jnetwork.TieredNetwork())
    got, want = _run_pair(
        jb, b, _fkw(method), kw, jkw, 4,
        (data.FederatedBatcher(_cnn_data(data), B, H),
         jdata.FederatedBatcher(_cnn_data(jdata), B, H)), 40)
    _check_pair(got, want, method)
    f = got[3].participation_summary()["faults"]
    assert f["retries"] > 0 and f["crash_drops"] + f["wire_drops"] > 0
    assert got[1].counts["fault_frames"] > 0
    assert (f["deadline_drops"] > 0) == with_deadline


def test_trainer_run_matches_reference_lm():
    """Reduced Qwen3 (fp32), CSE-FSL under MIX for 2 rounds."""
    fkw = dict(num_clients=LM_N, h=LM_H, lr=0.1, method="cse_fsl")
    jcfg = jget_config("qwen3-0.6b").reduced().with_(**LM_KW)
    cfg = get_config("qwen3-0.6b").reduced().with_(**LM_KW)
    jfed = jbuild_data(jcfg, JFSLConfig(**fkw), LM_S, LM_SAMPLES, False)
    fed = build_data(cfg, FSLConfig(**fkw), LM_S, LM_SAMPLES, False)
    got, want = _run_pair(
        jtransformer_bundle(jcfg), transformer_bundle(cfg, device="cpu"),
        fkw, dict(faults=faults.FaultModel(**MIX_KW)),
        dict(faults=jfaults.FaultModel(**MIX_KW)), 2,
        (LMBatcher(cfg, fed, 1, LM_H), JLMBatcher(jcfg, jfed, 1, LM_H)),
        LM_SAMPLES)
    _check_pair(got, want, "cse_fsl")


# ---------------------------------------------------------------------------
# The port's run_compiled against its run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_data", [True, False])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_run_compiled_bitwise_matches_run(method, device_data):
    """5 rounds at chunk 2 under MIX, int8 on every channel with int8
    model sync: state, rows, meter and stats equal to the loop's."""
    b = _bundles()[1]
    pa = jax.eval_shape(_bundles()[0].init,
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    cm = _cost_models(*_bundles(), N, 40, pa)[0]
    down = "int8" if get_method(method).downloads_gradients else "none"
    out = []
    for compiled in (False, True):
        tr = Trainer(b, FSLConfig(**_fkw(method)),
                     faults=faults.FaultModel(**MIX_KW),
                     transport=make_transport("int8", down,
                                              model_sync="int8"))
        meter = CommMeter()
        batcher = data.FederatedBatcher(_cnn_data(data), B, H)
        kw = dict(log_every=1, meter=meter, cost_model=cm)
        if compiled:
            state, hist = tr.run_compiled(tr.init(0), batcher, 5, chunk=2,
                                          device_data=device_data, **kw)
        else:
            state, hist = tr.run(tr.init(0), batcher, 5, **kw)
        out.append((state, hist, meter, tr))
    (s0, h0, m0, t0), (s1, h1, m1, t1) = out
    assert s0["round"] == s1["round"]
    for x, y in zip(state_leaves(s0), state_leaves(s1)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert h0 == h1 and len(h0) == 5
    assert m0.counts == m1.counts and m0.counts["fault_frames"] > 0
    assert t0.participation_summary() == t1.participation_summary()
    assert min(r["participants"] for r in h0) < N
