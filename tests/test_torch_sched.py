"""Client scheduling on the sync path: the port's ``repro_torch.sched``,
masked FedAvg and the Trainer's scheduler integration against the JAX
package.

- Every policy's ``plan``, ``strides``, ``client_seconds`` and ``summary``
  bitwise, drawn by each package's own Trainer (``_plan_schedule``) on the
  same network, with the ``SchedContext`` equal field by field (its bytes
  come from each package's own payload specs through its own transport).
- ``fedavg_masked`` bitwise at ``refresh`` True and False.  XLA's CPU dot
  (``jnp.tensordot(w, x, axes=1)``) is one fused multiply-add a client in
  client order; the port's ``masked_mean0`` reproduces it exactly, where
  ``torch.tensordot`` and a sum of products differ in the last bit (at
  n = 8 and n = 4): both are shown here.
- The masked ``make_wire_aggregate`` applied op by op, the port fed the
  reference's own bits at salts 2 and 3 (``Transport.bits_fn``), bitwise
  on the narrow CNN (four methods, identity/int8/fp8, both ``refresh``) and
  on reduced Qwen3 (fp32).
- ``Trainer.run`` under ``deadline``, ``bandwidth_h`` and ``stratified`` on
  all four methods from the reference's initial state: rows
  (``participants``, ``dropped_updates``, ``comm_bytes``), meter and
  ``participation_summary`` equal; losses at rtol 1e-4 and params at atol
  1e-5 (the identity wire: fp32 sum order only, as
  ``tests/test_torch_baselines.py`` states).
- The port's ``run_compiled`` bitwise equal to its ``run`` under each
  policy (int8 on every channel, the model sync included), staged and
  pooled, with a trailing partial chunk; a run resumed mid-window bitwise
  the uninterrupted run (the port keeps the window across calls; the
  reference restarts it, pinned); the empty-cohort warning and no-op in
  both engines.

The CNN is ``tests/test_torch_baselines.py``'s narrow one at n = 3.
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
from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.core.methods.base import fedavg_masked as jfedavg_masked
from repro.core.trainer import Trainer as JTrainer
from repro.models.cnn import CNNConfig as JCNNConfig
from repro import network as jnetwork
from repro import sched as jsched
from repro.transport import make_transport as jmake_transport
from repro_torch import data
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
from repro_torch.core.methods.base import fedavg_masked, masked_mean0
from repro_torch.core.trainer import Trainer
from repro_torch.models.cnn import CNNConfig
from repro_torch.transport import Transport, get_codec, make_transport

ALL_METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")
N, H, C, B = 3, 3, 2, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
LM_KW = dict(dtype="float32", use_pallas=True, swa_window=64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops run on one intra-op thread (pytest-xdist workers share the
    cores); both sides of every comparison run under the same setting."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# The policies, built the same way in either package (``pkg`` is
# ``sched``/``network`` of one of them).  n = 3 on the tiered network is
# one 3g, one 4g and one wifi client; the stratified policy samples 2 of
# the 3 from the uniform network's one stratum; bandwidth_h's cap of 2
# gives strides (2, 2, 1).
def _deadline(s, net, ctx):
    secs = np.sort(s.DeadlinePolicy(compute_s=0.5).client_seconds(ctx))
    return s.DeadlinePolicy(deadline_s=float(0.5 * (secs[-2] + secs[-1])),
                            compute_s=0.5)


POLICIES = {
    "deadline": (lambda s, net, ctx: _deadline(s, net, ctx),
                 lambda n: n.TieredNetwork()),
    "bandwidth_h": (lambda s, net, ctx: s.BandwidthHPolicy(max_stride=2),
                    lambda n: n.TieredNetwork()),
    "stratified": (lambda s, net, ctx: s.StratifiedPolicy(frac=0.5, seed=3),
                   lambda n: n.UniformNetwork()),
}


def _fkw(method, h=H, c=C):
    return dict(num_clients=N, h=h, agg_every=c, lr=0.1, method=method,
                grad_clip=1.0 if method == "fsl_oc" else 0.0)


def _cnn_data(pkg):
    x, y = pkg.synthetic_classification(120, NARROW["in_shape"], 10, seed=0,
                                        signal=12.0)
    return pkg.partition_iid(x, y, N, seed=0)


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
    return cm, jcm


def _policies(name, jtr, tr, jbatch, batch):
    """The policy ``name`` and its network in both packages (the deadline
    between the two slowest clients' analytic round times, each package
    computing its own, which agree)."""
    make, make_net = POLICIES[name]
    jnet, net = make_net(jnetwork), make_net(network)
    jp = make(jsched, jnet, _jctx(jtr, jbatch, jnet))
    p = make(sched, net, _ctx(tr, batch, net))
    assert vars(p) == vars(jp)
    return (jp, jnet), (p, net)


def _jctx(jtr, batch, net):
    m, fsl, tp = jtr.method, jtr.fsl, jtr.transport
    up, reply = m.payload_specs(jtr.bundle, fsl, batch)
    return jsched.SchedContext(
        fsl=fsl, network=net, up_bytes=tp.uplink_payload_bytes(up),
        down_bytes=tp.downlink_payload_bytes(reply)
        if reply is not None else 0, blocking=m.downloads_gradients,
        uploads_per_round=fsl.h if m.uploads_every_batch else 1)


def _ctx(tr, batch, net):
    m, fsl, tp = tr.method, tr.fsl, tr.transport
    up, reply = m.payload_specs(tr.bundle, fsl, batch)
    return sched.SchedContext(
        fsl=fsl, network=net, up_bytes=tp.uplink_payload_bytes(up),
        down_bytes=tp.downlink_payload_bytes(reply)
        if reply is not None else 0, blocking=m.downloads_gradients,
        uploads_per_round=tr._uploads_per_round())


def _ctx_fields(ctx):
    return {f.name: getattr(ctx, f.name) for f in dataclasses.fields(ctx)
            if f.name not in ("fsl", "network")}


# ---------------------------------------------------------------------------
# Policies: registry, plans, strides, deadlines, summaries
# ---------------------------------------------------------------------------


def test_registry_and_flags_match_reference():
    assert sched.available_policies() == jsched.available_policies()
    assert sched.resolve_policy(None) is sched.WAIT_ALL
    assert sched.WAIT_ALL.is_wait_all
    for name in sched.available_policies():
        a, b = sched.get_policy(name), jsched.get_policy(name)
        assert (a.name, a.is_wait_all, a.refresh_dropped,
                a.local_when_skipped) == (b.name, b.is_wait_all,
                                          b.refresh_dropped,
                                          b.local_when_skipped)
        for kw in ({}, {"deadline_s": 7.5, "seed": 4}):
            fa = sched.scheduler_from_flags(name, **kw)
            fb = jsched.scheduler_from_flags(name, **kw)
            assert type(fa).__name__ == type(fb).__name__
            assert vars(fa) == vars(fb)
    with pytest.raises(KeyError, match="unknown scheduler policy"):
        sched.get_policy("bogus")
    with pytest.raises(ValueError, match="duplicate policy name"):
        @sched.register_policy
        class Again(sched.SchedulerPolicy):
            name = "deadline"


@pytest.mark.parametrize("net_name", ["ideal", "uniform", "lognormal",
                                      "tiered", "trace"])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_plans_match_reference(method, net_name):
    """Each policy's plan over 7 rounds, drawn by each Trainer against its
    own payload bytes; deadlines at every client's analytic round time
    (so each client sits on both sides of one of them)."""
    jb, b = _bundles()
    fkw = {**_fkw(method), "codec": "int8"}
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False)
    tr = Trainer(b, FSLConfig(**fkw))
    jbatch = jdata.FederatedBatcher(_cnn_data(jdata), B, H).next_round()
    batch = data.FederatedBatcher(_cnn_data(data), B, H).next_round()
    jnet = jnetwork.network_from_flags(net_name, bandwidth_mbps=2.0)
    net = network.network_from_flags(net_name, bandwidth_mbps=2.0)
    jctx, ctx = _jctx(jtr, jbatch, jnet), _ctx(tr, batch, net)
    assert _ctx_fields(ctx) == _ctx_fields(jctx)
    assert ctx.up_bytes > 0 and (ctx.down_bytes > 0) == ctx.blocking
    secs = sched.DeadlinePolicy().client_seconds(ctx)
    np.testing.assert_array_equal(
        secs, jsched.DeadlinePolicy().client_seconds(jctx))
    pairs = [(jsched.get_policy(p), sched.get_policy(p))
             for p in ("wait_all", "bandwidth_h", "stratified")]
    pairs += [(jsched.BandwidthHPolicy(max_stride=s),
               sched.BandwidthHPolicy(max_stride=s)) for s in (1, 3)]
    pairs += [(jsched.StratifiedPolicy(frac=f, seed=sd),
               sched.StratifiedPolicy(frac=f, seed=sd))
              for f, sd in ((0.3, 1), (1.0, 2))]
    pairs += [(jsched.DeadlinePolicy(deadline_s=float(t)),
               sched.DeadlinePolicy(deadline_s=float(t)))
              for t in (*secs, secs.min() - 1e-9)]
    for jp, p in pairs:
        jm, m = jp.plan(jctx, 7), p.plan(ctx, 7)
        assert m.dtype == jm.dtype and m.shape == jm.shape == (7, N)
        np.testing.assert_array_equal(m, jm, err_msg=p.name)
        assert p.summary(ctx, m) == jp.summary(jctx, jm)
        assert p.summary(ctx, m[:0]) == jp.summary(jctx, jm[:0])
        if p.name == "bandwidth_h":
            np.testing.assert_array_equal(p.strides(ctx), jp.strides(jctx))
        assert p.round_budget(ctx, 3) == jp.round_budget(jctx, 3)


def test_trainer_plan_schedule_matches_reference():
    """The Trainer's own ``_plan_schedule``: the ``SchedContext`` field by
    field and the plan, for a blocking and a non-blocking method, on the
    pooled path's ``meta`` spec too."""
    jb, b = _bundles()
    for method in ("cse_fsl", "fsl_oc"):
        fkw = {**_fkw(method), "codec": "int8"}
        jnet, net = jnetwork.TieredNetwork(), network.TieredNetwork()
        jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False, network=jnet,
                       scheduler=jsched.StratifiedPolicy(frac=0.7, seed=5))
        tr = Trainer(b, FSLConfig(**fkw), network=net,
                     scheduler=sched.StratifiedPolicy(frac=0.7, seed=5))
        jbatch = jdata.FederatedBatcher(_cnn_data(jdata), B, H).next_round()
        batcher = data.FederatedBatcher(_cnn_data(data), B, H)
        want = jtr._plan_schedule(jbatch, 6)
        for batch in (batcher.next_round(), tr.pool_round_spec(
                batcher.device_pool(tr.device),
                batcher.next_round_indices().shape)):
            np.testing.assert_array_equal(tr._plan_schedule(batch, 6), want)
            assert _ctx_fields(tr._sched_ctx) == _ctx_fields(jtr._sched_ctx)


# ---------------------------------------------------------------------------
# Masked FedAvg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_fedavg_masked_matches_reference_bitwise(n, refresh):
    """Random nonempty masks over leaves of three shapes with magnitudes
    over six decades: every bit, signs of zero included; with
    ``refresh=False`` the dropped rows are the inputs' own."""
    rng = np.random.default_rng(n)
    for trial in range(6):
        mask = (rng.random(n) < 0.6).astype(np.float32)
        if trial == 0:
            mask[:] = 1.0
            mask[1] = 0.0
        if not mask.any():
            mask[trial % n] = 1.0
        tree = {s: (rng.standard_normal((n,) + s)
                    * 10.0 ** rng.uniform(-3, 3, (n,) + s)).astype(np.float32)
                for s in ((37,), (5, 130), (3, 3, 8, 8))}
        want = jax.tree_util.tree_map(np.asarray, jfedavg_masked(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(mask),
            refresh=refresh))
        got = fedavg_masked({k: torch.from_numpy(v) for k, v in tree.items()},
                            torch.from_numpy(mask), refresh=refresh)
        for k, w in want.items():
            g = got[k].numpy()
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
            if not refresh:
                np.testing.assert_array_equal(g[mask == 0], tree[k][mask == 0])


def test_masked_mean_forms():
    """Why ``masked_mean0``: at n = 4 with one client out (weights 1/3)
    the sum of products rounds differently from XLA's dot, and at n = 8
    ``torch.tensordot`` does; the FMA chain matches both."""
    rng = np.random.default_rng(0)
    seen = {"sum": False, "tensordot": False}
    for n in (4, 8):
        mask = np.ones(n, np.float32)
        mask[0] = 0.0
        w = (mask / max(mask.sum(), 1.0)).astype(np.float32)
        x = rng.standard_normal((n, 4096)).astype(np.float32)
        want = np.asarray(jnp.tensordot(jnp.asarray(w), jnp.asarray(x),
                                        axes=1))
        wt, xt = torch.from_numpy(w), torch.from_numpy(x)
        np.testing.assert_array_equal(masked_mean0(xt, wt)[0].numpy(), want)
        seen["sum"] |= not np.array_equal(
            (wt[:, None] * xt).sum(0).numpy(), want)
        seen["tensordot"] |= not np.array_equal(
            torch.tensordot(wt, xt, dims=1).numpy(), want)
    assert seen == {"sum": True, "tensordot": True}


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _port_paths(v, prefix + (k,))]
    return [prefix]


def _leaf_map(method, port_params, ref_params):
    """Port leaf index -> the reference's leaf index of the same param."""
    keys = dict((pk, rk) for rk, pk in get_method(method).client_keys or ())

    def ref_path(path):
        if keys:
            path = (keys[path[0]],) + path[1:]
        name = path[-1]
        if name.endswith(".weight") or name.endswith(".bias"):
            layer, kind = name.rsplit(".", 1)
            path = path[:-1] + (layer, "w" if kind == "weight" else "b")
        return path

    ref = [tuple(k.key for k in p) for p, _ in
           jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    return [ref.index(ref_path(p)) for p in _port_paths(port_params)]


def _jmodel_bits(jtp, leaf_of):
    """The reference's model-sync bits: salt 2 folds the client into the
    unit key, salt 3 (the one coded average) does not."""
    def bits_fn(unit, client, leaf, salt, shape):
        key = jtp.unit_key(unit, salt=salt)
        if salt == 2:
            key = jax.random.fold_in(key, client)
        key = jax.random.fold_in(key, leaf_of[leaf])
        return np.asarray(jax.random.bits(key, shape, jnp.uint32))
    return bits_fn


def _masked_aggregate_pair(jb, b, method, codec, refresh, mask, n):
    """Both masked wire aggregates on one perturbed state (round 7), the
    reference's applied op by op; returns (input, port out, reference
    out) as numpy trees in the reference's layout."""
    fkw = {**_fkw(method), "num_clients": n}
    jtp = jmake_transport(model_sync=codec)
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False, transport=jtp)
    rng = np.random.default_rng(1)
    jstate = jax.tree_util.tree_map(np.asarray, jtr.init(0))
    for key in get_method(method).agg_keys:
        jstate[key] = jax.tree_util.tree_map(
            lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
                a.dtype) if a.ndim and a.shape[0] == n else a, jstate[key])
    jstate["round"] = np.int32(7)
    state = state_from_numpy(jstate, device="cpu", method=method)
    leaf_of = _leaf_map(method, state["clients"]["params"],
                        jstate["clients"]["params"])
    tp = Transport(model_up=get_codec(codec), model_down=get_codec(codec),
                   bits_fn=_jmodel_bits(jtp, leaf_of))
    jagg = jtr.method.make_wire_aggregate(JFSLConfig(**fkw), transport=jtp,
                                          participation=True,
                                          refresh=refresh)
    want = jax.tree_util.tree_map(np.asarray, jagg(
        jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(mask)))
    agg = get_method(method).make_wire_aggregate(
        b, FSLConfig(**fkw), transport=tp, participation=True,
        refresh=refresh)
    got = state_to_numpy(agg(state, torch.from_numpy(mask)), method=method)
    return jstate, got, want


@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("method,codec", [
    *((m, c) for m in ALL_METHODS for c in ("none", "int8")),
    ("cse_fsl", "fp8")])
def test_masked_wire_aggregate_matches_reference(method, codec, refresh):
    """n = 4 with client 1 out: every leaf of the state bitwise (params,
    opt state, FSL_MC/FSL_AN's replicas); without ``refresh`` client 1
    keeps its own params, with it every client holds the coded average."""
    jb, b = _bundles()
    mask = np.array([1, 0, 1, 1], np.float32)
    before, got, want = _masked_aggregate_pair(jb, b, method, codec, refresh,
                                               mask, 4)
    for (path, a), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(a, w, err_msg=jax.tree_util.keystr(
            path))
    for x, y in zip(jax.tree_util.tree_leaves(got["clients"]["params"]),
                    jax.tree_util.tree_leaves(before["clients"]["params"])):
        np.testing.assert_array_equal(x[0], x[2])
        if refresh:
            np.testing.assert_array_equal(x[1], x[0])
        else:
            np.testing.assert_array_equal(x[1], y[1])


def test_masked_wire_aggregate_matches_reference_lm():
    """Reduced Qwen3 (fp32), int8 model sync, n = 3 with client 0 out."""
    jb = jtransformer_bundle(jget_config("qwen3-0.6b").reduced()
                             .with_(**LM_KW))
    b = transformer_bundle(get_config("qwen3-0.6b").reduced().with_(**LM_KW),
                           device="cpu")
    _, got, want = _masked_aggregate_pair(
        jb, b, "cse_fsl", "int8", True, np.array([0, 1, 1], np.float32), 3)
    for (path, a), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(a, w, err_msg=jax.tree_util.keystr(
            path))


# ---------------------------------------------------------------------------
# Trainer.run against the JAX package
# ---------------------------------------------------------------------------


def _run_pair(method, policy, rounds=3, h=H, c=C, resume=None):
    """The same rounds through both trainers under ``policy`` from the
    reference's initial state (``resume``: run that many rounds, then the
    rest in a second call).  Returns ((hist, meter, state, trainer),
    (jhist, jmeter, jstate, jtrainer))."""
    jb, b = _bundles()
    cm, jcm = _cost_models()
    fkw = _fkw(method, h, c)
    jprobe = JTrainer(jb, JFSLConfig(**fkw), donate=False)
    probe = Trainer(b, FSLConfig(**fkw))
    jbatcher = jdata.FederatedBatcher(_cnn_data(jdata), B, h)
    batcher = data.FederatedBatcher(_cnn_data(data), B, h)
    (jp, jnet), (p, net) = _policies(
        policy, jprobe, probe,
        jdata.FederatedBatcher(_cnn_data(jdata), B, h).next_round(),
        data.FederatedBatcher(_cnn_data(data), B, h).next_round())
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False, scheduler=jp,
                   network=jnet)
    tr = Trainer(b, FSLConfig(**fkw), scheduler=p, network=net)
    jstate = jtr.init(0)
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                             device="cpu", method=method)
    out = []
    for t, st, bt, mt, c_ in ((tr, state, batcher, CommMeter(), cm),
                              (jtr, jstate, jbatcher, JCommMeter(), jcm)):
        hist = []
        for n_ in ((rounds,) if resume is None
                   else (resume, rounds - resume)):
            st, h_ = t.run(st, bt, n_, log_every=1, meter=mt, cost_model=c_)
            hist += h_
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


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("method", ALL_METHODS)
def test_trainer_run_matches_reference(method, policy):
    """3 rounds, every one aggregating (h = 3, C = 2): the realized
    cohorts drop someone (deadline: the 3g client every round;
    bandwidth_h: the stride-2 clients every other round, kept local;
    stratified: one of 3 each round)."""
    got, want = _run_pair(method, policy)
    _check_pair(got, want, method)
    parts = [r["participants"] for r in got[0] if r["aggregated"]]
    assert parts and min(parts) < N


@pytest.mark.parametrize("policy", ["bandwidth_h", "stratified"])
def test_trainer_run_windows_match_reference(policy):
    """h = 2, C = 4: windows of two rounds, the AND of the plan over both;
    then windows of three rounds (C = 6) with a resume in the middle of
    the first (2 + 3 rounds).  The port keeps the window across calls, so
    its split run is bitwise its uninterrupted run, which matches the
    reference's uninterrupted run; the reference restarts the window's
    AND at its second call, and admits the plan's round-3 row alone."""
    got, want = _run_pair("cse_fsl", policy, rounds=4, h=2, c=4)
    _check_pair(got, want, "cse_fsl")
    assert [r["aggregated"] for r in got[0]] == [False, True] * 2
    whole, jwhole = _run_pair("cse_fsl", policy, rounds=5, h=2, c=6)
    _check_pair(whole, jwhole, "cse_fsl")
    split, jsplit = _run_pair("cse_fsl", policy, rounds=5, h=2, c=6,
                              resume=2)
    for x, y in zip(state_leaves(whole[2]), state_leaves(split[2])):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert split[2]["round"] == whole[2]["round"]
    drop = ("dropped_updates",)     # counted from each call's start
    assert [{k: v for k, v in r.items() if k not in drop} for r in split[0]] \
        == [{k: v for k, v in r.items() if k not in drop} for r in whole[0]]
    assert split[1].as_dict() == whole[1].as_dict()
    masks = whole[3]._sched_masks
    cohorts = [(r["round"], r["participants"]) for r in whole[0]
               if r["aggregated"]]
    assert cohorts == [(3, int(masks[:3].all(0).sum()))]
    assert [(r["round"], r["participants"]) for r in jsplit[0]
            if r["aggregated"]] == [(3, int(masks[2].sum()))]


# ---------------------------------------------------------------------------
# The port's run_compiled against its run
# ---------------------------------------------------------------------------


class Nobody(sched.SchedulerPolicy):
    """Admits no client in rounds 1 and 2 (0-based), everyone else."""
    name = "test_nobody_mid"

    def plan(self, ctx, num_rounds):
        masks = np.ones((num_rounds, ctx.fsl.num_clients), bool)
        masks[1:3] = False
        return masks


def _compiled_pair(method, policy, net, rounds, chunk, h=H, c=C,
                   device_data=True):
    b = _bundles()[1]
    cm = _cost_models()[0]
    down = "int8" if get_method(method).downloads_gradients else "none"
    out = []
    for compiled in (False, True):
        tr = Trainer(b, FSLConfig(**_fkw(method, h, c)), scheduler=policy,
                     network=net,
                     transport=make_transport("int8", down,
                                              model_sync="int8"))
        meter = CommMeter()
        batcher = data.FederatedBatcher(_cnn_data(data), B, h)
        kw = dict(log_every=1, meter=meter, cost_model=cm)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if compiled:
                state, hist = tr.run_compiled(tr.init(0), batcher, rounds,
                                              chunk=chunk,
                                              device_data=device_data, **kw)
            else:
                state, hist = tr.run(tr.init(0), batcher, rounds, **kw)
        out.append((state, hist, meter, tr))
    (s0, h0, m0, t0), (s1, h1, m1, t1) = out
    assert s0["round"] == s1["round"]
    for x, y in zip(state_leaves(s0), state_leaves(s1)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert h0 == h1 and len(h0) == rounds
    assert m0.counts == m1.counts
    assert t0.participation_summary() == t1.participation_summary()
    return out


def _compiled_policy(name):
    net = network.TieredNetwork()
    if name == "deadline":
        return sched.DeadlinePolicy(deadline_s=2.0, compute_s=0.5), net
    if name == "bandwidth_h":
        return sched.BandwidthHPolicy(max_stride=2), net
    if name == "nobody":
        return Nobody(), net
    return sched.StratifiedPolicy(frac=0.5, seed=3), network.UniformNetwork()


@pytest.mark.parametrize("policy", ["deadline", "bandwidth_h", "stratified",
                                    "nobody"])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_run_compiled_bitwise_matches_run(method, policy):
    """5 rounds at chunk 2 (a trailing partial chunk) on the pooled data
    path, int8 on every channel with int8 model sync: state, rows, meter
    and summary equal to the loop's, bit for bit."""
    p, net = _compiled_policy(policy)
    out = _compiled_pair(method, p, net, 5, 2)
    rows = out[0][1]
    assert all("participants" in r for r in rows if r["aggregated"])


@pytest.mark.parametrize("method", ALL_METHODS)
def test_run_compiled_staged_bitwise_matches_run(method):
    """The staged data path under the stratified plan, as above."""
    p, net = _compiled_policy("stratified")
    _compiled_pair(method, p, net, 5, 2, device_data=False)


@pytest.mark.parametrize("method", ["cse_fsl", "fsl_mc"])
def test_run_compiled_windows_across_chunks(method):
    """h = 2, C = 6: three-round windows that straddle chunks of 2, so the
    participation carry crosses a chunk boundary."""
    p, net = _compiled_policy("stratified")
    _compiled_pair(method, p, net, 7, 2, h=2, c=6)


@pytest.mark.parametrize("engine", ["run", "run_compiled"])
def test_empty_cohort_warns_and_noops(engine):
    """Rounds 2 and 3 admit nobody: a warning each, ``participants`` 0,
    no model-sync bytes, and the clients' params after round 2 are the
    round step's own (no FedAvg: they differ across clients)."""
    b = _bundles()[1]
    cm = _cost_models()[0]
    tr = Trainer(b, FSLConfig(**_fkw("cse_fsl"), model_codec="int8"),
                 scheduler=Nobody())
    batcher = data.FederatedBatcher(_cnn_data(data), B, H)
    meter = CommMeter()
    run = tr.run if engine == "run" else (
        lambda *a, **kw: tr.run_compiled(*a, chunk=2, **kw))
    with pytest.warns(UserWarning, match="admitted no clients") as rec:
        state, hist = run(tr.init(0), batcher, 2, log_every=1, meter=meter,
                          cost_model=cm)
    assert len([w for w in rec if "admitted no clients" in
                str(w.message)]) == 1
    assert [r["participants"] for r in hist] == [N, 0]
    assert hist[-1]["dropped_updates"] == N
    ms = tr._model_sync_wire_pair()
    assert meter.counts["model_sync"] == N * sum(ms)
    leaves = state_leaves({"c": state["clients"]["params"]})
    assert any(not torch.equal(x[0], x[1]) for x in leaves)
