"""The three baselines (FSL_MC, FSL_OC, FSL_AN) through ``Trainer.run``: the
port against the JAX package.

Both trainers start from the reference's initial state of each method
(carried across by ``repro_torch.convert``) and draw the same batches.  The
CNN setup is ``test_torch_cse_fsl.py``'s narrow CNN with n=3, h=3 and C=2
(the non-divisible cadence); the reduced Qwen3 setup is
``test_torch_cse_fsl_lm.py``'s (fp32, the JAX side's Pallas kernels in
interpret mode, the port's kernel ops with their plain versions).

Wires: the identity; ``int8`` on the uplink and, for the blocking methods,
on the gradient downlink too, the port fed the reference's own
``jax.random`` bits on both channels (salt 0 up, 1 down, through
``Transport.bits_fn``); ``topk`` on the uplink.

Tolerances: with the identity wire the two runs differ only in fp32 sum
order, so per-round losses agree at rtol 1e-4 and final params at atol
1e-5.  A coded wire can move one element across a stochastic-rounding
boundary (int8) or swap two nearly equal magnitudes at the k-th place
(topk) after a sum-order difference, so losses agree at rtol 1e-3 there.
The reduced Qwen3 runs agree at rtol 1e-4 as in
``test_torch_cse_fsl_lm.py``, with the identity wire and with int8 on both
wires; final params are compared with the identity wire only (atol 1e-5),
as for the coded CNN runs.  On the int8 downlink the two replies, equal to
about 1.5e-6 of their largest element, code to the same int8 values except
for about 3 of a client unit's 65,536 elements, which lie on the other
side of a rounding boundary; each such step moves the client's next update
and the final params by up to about 4e-5.  Metered bytes, the
``aggregated`` flags and ``state["round"]`` are identical in every case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro import data as jdata
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
from repro.transport import make_transport as jmake_transport
from repro_torch import data
from repro_torch.common import bytes_of, tree_map
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle, transformer_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.launch.train import LMBatcher, build_data
from repro_torch.models.cnn import CNNConfig
from repro_torch.optim import global_norm
from repro_torch.transport import Transport, get_codec

N, H, C, B = 3, 3, 2, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
LM_N, LM_H, LM_S, LM_SAMPLES = 2, 2, 256, 4
LM_KW = dict(dtype="float32", use_pallas=True, swa_window=64)


def _jbits_fn(jtp):
    """The reference's bits on the channel of ``salt``: unit_key ->
    fold_in(client) -> fold_in(leaf) -> jax.random.bits, as its round step
    derives them on the uplink (salt 0) and the downlink (salt 1)."""
    def bits_fn(unit, client, leaf, salt, shape):
        key = jax.random.fold_in(jtp.unit_key(unit, salt=salt), client)
        key = jax.random.fold_in(key, leaf)
        return np.asarray(jax.random.bits(key, shape, jnp.uint32))
    return bits_fn


def _cost_models(jb, jparams, b, n, d_local):
    jcm = JCostModel(n=n, q=jb.smashed_bytes_per_sample, d_local=d_local,
                     w_client=jbytes_of(jparams["client"]),
                     w_server=jbytes_of(jparams["server"]),
                     aux=jbytes_of(jparams["aux"]))
    cm = CostModel(n=n, q=b.smashed_bytes_per_sample, d_local=d_local,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    assert dict(vars(cm)) == dict(vars(jcm))
    return cm, jcm


def _run_pair(jb, b, fkw, up, down, rounds, jbatcher, batcher, d_local):
    """The same ``rounds`` through both trainers from the reference's
    initial state; returns ``(hist, meter, state), (jhist, jmeter,
    jstate)``."""
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False,
                   transport=jmake_transport(up, down))
    jstate = jtr.init(0)
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu", method=fkw["method"])
    pa = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    cm, jcm = _cost_models(jb, pa, b, fkw["num_clients"], d_local)
    jmeter = JCommMeter()
    jstate, jhist = jtr.run(jstate, jbatcher, rounds, log_every=1,
                            meter=jmeter, cost_model=jcm)
    tr = Trainer(b, FSLConfig(**fkw),
                 transport=Transport(uplink=get_codec(up),
                                     downlink=get_codec(down),
                                     bits_fn=_jbits_fn(jtr.transport)))
    meter = CommMeter()
    state, hist = tr.run(state0, batcher, rounds, log_every=1, meter=meter,
                         cost_model=cm)
    return (hist, meter, state), (jhist, jmeter, jstate)


def _check_pair(got, want, method, rounds, h, rtol, atol=None):
    (hist, meter, state), (jhist, jmeter, jstate) = got, want
    assert len(hist) == len(jhist) == rounds
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        assert row["round"] == jrow["round"]
        assert row["aggregated"] == jrow["aggregated"]
        assert row["comm_bytes"] == jrow["comm_bytes"]
        for k in set(row) - {"round", "aggregated", "comm_bytes"}:
            np.testing.assert_allclose(row[k], jrow[k], rtol=rtol,
                                       err_msg=f"round {row['round']} {k}")
    assert meter.as_dict() == jmeter.as_dict()
    assert state["round"] == int(jstate["round"]) == rounds * h
    if atol is None:
        return
    got_np = state_to_numpy(state, method=method)
    want_np = jax.tree_util.tree_map(np.asarray, jstate)
    assert set(got_np) == set(want_np)
    for key in set(want_np) - {"round"}:
        pairs = zip(
            jax.tree_util.tree_leaves_with_path(got_np[key]["params"]),
            jax.tree_util.tree_leaves_with_path(want_np[key]["params"]))
        for (path, a), (wpath, w) in pairs:
            assert path == wpath
            np.testing.assert_allclose(a, w, rtol=rtol, atol=atol,
                                       err_msg=f"{key}"
                                       f"{jax.tree_util.keystr(path)}")


def _cnn_data(pkg):
    x, y = pkg.synthetic_classification(120, NARROW["in_shape"], 10, seed=0,
                                        signal=12.0)
    return pkg.partition_iid(x, y, N, seed=0)


@pytest.mark.parametrize("method,up,down,grad_clip", [
    ("fsl_mc", "none", "none", 0.0), ("fsl_mc", "int8", "int8", 0.0),
    ("fsl_mc", "topk", "none", 0.0),
    ("fsl_oc", "none", "none", 0.0), ("fsl_oc", "int8", "int8", 0.0),
    ("fsl_oc", "topk", "none", 0.0), ("fsl_oc", "none", "none", 0.05),
    ("fsl_an", "none", "none", 0.0), ("fsl_an", "int8", "none", 0.0),
    ("fsl_an", "topk", "none", 0.0)])
def test_trainer_run_matches_reference(method, up, down, grad_clip):
    rounds = 3
    fkw = dict(num_clients=N, h=H, agg_every=C, lr=0.1, method=method,
               grad_clip=grad_clip)
    got, want = _run_pair(
        jcnn_bundle(JCNNConfig(**NARROW)),
        cnn_bundle(CNNConfig(**NARROW), device="cpu"), fkw, up, down, rounds,
        jdata.FederatedBatcher(_cnn_data(jdata), B, H),
        data.FederatedBatcher(_cnn_data(data), B, H), d_local=40)
    identity = up == down == "none"
    _check_pair(got, want, method, rounds, H,
                rtol=1e-4 if identity else 1e-3,
                atol=1e-5 if identity else None)
    flags = [r["aggregated"] for r in got[0]]
    assert flags == [True, True, True]      # C=2 < h=3: every round crosses
    if grad_clip:
        # the limit bites: the first server update's grads exceed it
        b = cnn_bundle(CNNConfig(**NARROW), device="cpu")
        st = state_from_numpy(jax.tree_util.tree_map(
            np.asarray, JTrainer(jcnn_bundle(JCNNConfig(**NARROW)),
                                 JFSLConfig(**fkw), donate=False).init(0)),
            device="cpu", method=method)
        x, y = (torch.as_tensor(a[0, 0]) for a in data.FederatedBatcher(
            _cnn_data(data), B, H).next_round())
        sm = b.client_smashed({k: v[0] for k, v in
                               st["clients"]["params"].items()}, x)
        gs = grad(b.server_loss)(st["server"]["params"], sm, y)
        assert float(global_norm(gs)) > 2 * grad_clip


@pytest.mark.parametrize("method,wire", [
    ("fsl_mc", "none"), ("fsl_mc", "int8"), ("fsl_oc", "none"),
    ("fsl_oc", "int8")])
def test_reduced_qwen3_matches_reference(method, wire):
    fkw = dict(num_clients=LM_N, h=LM_H, lr=0.1, method=method)
    jcfg = jget_config("qwen3-0.6b").reduced().with_(**LM_KW)
    cfg = get_config("qwen3-0.6b").reduced().with_(**LM_KW)
    jfed = jbuild_data(jcfg, JFSLConfig(**fkw), LM_S, LM_SAMPLES, False)
    fed = build_data(cfg, FSLConfig(**fkw), LM_S, LM_SAMPLES, False)
    got, want = _run_pair(
        jtransformer_bundle(jcfg), transformer_bundle(cfg, device="cpu"), fkw,
        wire, wire, 2, JLMBatcher(jcfg, jfed, 1, LM_H),
        LMBatcher(cfg, fed, 1, LM_H), d_local=LM_SAMPLES)
    _check_pair(got, want, method, 2, LM_H, rtol=1e-4,
                atol=1e-5 if wire == "none" else None)
    if wire == "int8":
        # [256, 256] fp32 smashed and reply per client unit, int8 in 64
        # tiles of 8x128 on both wires
        per = 2 * LM_N * LM_H * (LM_S * 256 + 64 * 4)
        assert got[1].counts["uplink_smashed"] == per
        assert got[1].counts["downlink_grads"] == per


@pytest.mark.parametrize("method", ["cse_fsl", "fsl_mc", "fsl_oc", "fsl_an"])
def test_state_layout_and_aggregate(method):
    """The layout each method names (``client_keys``, ``server_key``)
    carries the reference's initial state into the port's own
    ``init_state`` layout and back unchanged; the shared ``aggregate``
    averages exactly the stacked keys, as the reference's does."""
    fkw = dict(num_clients=N, h=H, agg_every=C, lr=0.1, method=method)
    jtr = JTrainer(jcnn_bundle(JCNNConfig(**NARROW)), JFSLConfig(**fkw),
                   donate=False)
    jstate = jtr.init(0)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    state = state_from_numpy(want, device="cpu", method=method)
    tr = Trainer(cnn_bundle(CNNConfig(**NARROW), device="cpu"),
                 FSLConfig(**fkw))
    mine = tr.init(0)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return [shapes(v) for v in tree]
        return tuple(tree.shape) if torch.is_tensor(tree) else tree

    assert shapes(state) == shapes(mine)
    back = state_to_numpy(state, method=method)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, w)
    # perturb each client (and replica) differently, then FedAvg
    g = torch.Generator().manual_seed(0)
    state = {k: v if k == "round" else tree_map(
        lambda t: t + torch.randn(t.shape, generator=g), v)
        for k, v in state.items()}
    jagg = jax.tree_util.tree_map(np.asarray, jtr.aggregate(
        jax.tree_util.tree_map(jnp.asarray,
                               state_to_numpy(state, method=method))))
    got = state_to_numpy(tr.aggregate(state), method=method)
    for a, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jagg)):
        np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-6)
