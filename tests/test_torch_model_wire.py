"""The model-sync wire (FedAvg behind the ``model_up`` / ``model_down``
codecs): the port against the JAX package.

- ``make_wire_aggregate`` on the same state, carried across by
  ``repro_torch.convert``, with each client's params perturbed so the
  average moves them: the port codes each leaf in the JAX package's
  checkpoint layout (``bundle.wire_axes``), and its ``bits_fn`` feeds the
  reference's own ``jax.random`` bits at salts 2 (per client, up) and 3
  (the one coded average, down), leaf by leaf.  The reference's aggregate
  runs as its factory returns it, op by op: under ``jit`` XLA fuses the
  dequantize into the FedAvg sum, and about 9% of the int8 averages come
  out one fp32 ulp apart.  Every case is bitwise, with the identity codec
  and with ``int8`` / ``fp8``: the two sides code the same values in the
  same 8x128 tiles with the same bits, and their FedAvg means (the sum
  times the fp32 reciprocal of n) agree bit for bit.
- ``CommProfile.model_sync_wire`` and the metered model-sync bytes equal
  the reference's for ``none`` / ``int8`` / ``fp8`` and every method.
- The port's ``run_compiled`` against the JAX ``run_compiled`` on the
  identity wire, from the reference's initial state: per-round losses at
  rtol 1e-4 and final params at atol 1e-5, the fp32 tolerances of the
  other parity tests (the two differ in fp32 sum order only); the
  ``aggregated`` flags and metered bytes are identical.
"""
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
from repro.core.trainer import Trainer as JTrainer
from repro.models.cnn import CNNConfig as JCNNConfig
from repro.transport import make_transport as jmake_transport
from repro_torch import data
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle, transformer_bundle
from repro_torch.core.methods import get_method
from repro_torch.core.trainer import Trainer
from repro_torch.models.cnn import CNNConfig
from repro_torch.transport import Transport, get_codec

ALL_METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")
N, H, C, B = 3, 3, 2, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
LM_KW = dict(dtype="float32", use_pallas=True, swa_window=64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops run on one intra-op thread: under pytest-xdist several
    workers share the cores, and torch's thread pools would fight over
    them.  Both sides of every comparison run under the same setting."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fkw(method):
    return dict(num_clients=N, h=H, agg_every=C, lr=0.1, method=method,
                grad_clip=1.0 if method == "fsl_oc" else 0.0)


def _bundles(lm: bool):
    if lm:
        return (jtransformer_bundle(jget_config("qwen3-0.6b").reduced()
                                    .with_(**LM_KW)),
                transformer_bundle(get_config("qwen3-0.6b").reduced()
                                   .with_(**LM_KW), device="cpu"))
    return (jcnn_bundle(JCNNConfig(**NARROW)),
            cnn_bundle(CNNConfig(**NARROW), device="cpu"))


def _port_paths(tree, prefix=()):
    """Key paths of the leaves of a port tree, in ``tree_leaves`` order."""
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
    unit key, salt 3 (the one coded average) does not; then fold_in of the
    reference's leaf index and ``jax.random.bits``."""
    def bits_fn(unit, client, leaf, salt, shape):
        key = jtp.unit_key(unit, salt=salt)
        if salt == 2:
            key = jax.random.fold_in(key, client)
        key = jax.random.fold_in(key, leaf_of[leaf])
        return np.asarray(jax.random.bits(key, shape, jnp.uint32))
    return bits_fn


@pytest.mark.parametrize("codec", ["none", "int8", "fp8"])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_wire_aggregate_matches_reference(method, codec):
    jb, b = _bundles(lm=False)
    _aggregate_pair(jb, b, method, codec)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_wire_aggregate_matches_reference_lm(codec):
    """Reduced Qwen3 (fp32): the transformer's tree crosses leaf for leaf
    in one layout, stacked layer axes folded into the wire rows."""
    jb, b = _bundles(lm=True)
    _aggregate_pair(jb, b, "cse_fsl", codec)


def _aggregate_pair(jb, b, method, codec):
    fkw = _fkw(method)
    jtp = jmake_transport(model_sync=codec)
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False, transport=jtp)
    rng = np.random.default_rng(1)
    jstate = jax.tree_util.tree_map(np.asarray, jtr.init(0))
    for key in ("clients", get_method(method).server_key):
        jstate[key]["params"] = jax.tree_util.tree_map(
            lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            if a.ndim and a.shape[0] == N else a, jstate[key]["params"])
    jstate["round"] = np.int32(7)
    state = state_from_numpy(jstate, device="cpu", method=method)
    leaf_of = _leaf_map(method, state["clients"]["params"],
                        jstate["clients"]["params"])
    tp = Transport(model_up=get_codec(codec), model_down=get_codec(codec),
                   bits_fn=_jmodel_bits(jtp, leaf_of))
    jagg = jtr.method.make_wire_aggregate(JFSLConfig(**fkw), transport=jtp)
    want = jax.tree_util.tree_map(np.asarray, jagg(
        jax.tree_util.tree_map(jnp.asarray, jstate)))
    agg = get_method(method).make_wire_aggregate(b, FSLConfig(**fkw),
                                                 transport=tp)
    got = state_to_numpy(agg(state), method=method)
    # the identity wire is the plain FedAvg, no codec op
    assert ("make_aggregate" in agg.__qualname__) == (codec == "none")
    for (path, a), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(a, w, err_msg=jax.tree_util.keystr(
            path))
    before = jax.tree_util.tree_leaves(jstate["clients"]["params"])
    after = jax.tree_util.tree_leaves(got["clients"]["params"])
    moved = any(not np.array_equal(x, y) for x, y in zip(before, after))
    assert moved and all(np.array_equal(x[0], x[-1]) for x in after)


def _cost_models(jb, b):
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


@pytest.mark.parametrize("codec", ["none", "int8", "fp8"])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_comm_profile_model_sync_matches_reference(method, codec):
    jb, b = _bundles(lm=False)
    cm, jcm = _cost_models(jb, b)
    fkw = {**_fkw(method), "model_codec": codec}
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False)
    tr = Trainer(b, FSLConfig(**fkw))
    assert tr.transport.model_identity == (codec == "none")
    jp, p = jtr.comm_profile(jcm, B), tr.comm_profile(cm, B)
    assert dict(vars(p)) == dict(vars(jp))
    assert p.wire_model_sync == jp.wire_model_sync
    if codec != "none":
        assert p.model_sync_wire < p.model_sync


@pytest.mark.parametrize("method", ALL_METHODS)
def test_metered_model_sync_matches_reference(method):
    """Two rounds with the int8 model-sync wire: the port's meter bills
    the reference's model-sync bytes, aggregation for aggregation."""
    jb, b = _bundles(lm=False)
    cm, jcm = _cost_models(jb, b)
    fkw = {**_fkw(method), "model_codec": "int8"}
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False)
    jmeter, meter = JCommMeter(), CommMeter()
    x, y = data.synthetic_classification(120, NARROW["in_shape"], 10,
                                         signal=12.0)
    jx, jy = jdata.synthetic_classification(120, NARROW["in_shape"], 10,
                                            signal=12.0)
    _, jhist = jtr.run(jtr.init(0), jdata.FederatedBatcher(
        jdata.partition_iid(jx, jy, N), B, H), 2, log_every=1, meter=jmeter,
        cost_model=jcm)
    tr = Trainer(b, FSLConfig(**fkw))
    _, hist = tr.run_compiled(tr.init(0), data.FederatedBatcher(
        data.partition_iid(x, y, N), B, H), 2, chunk=2, log_every=1,
        meter=meter, cost_model=cm)
    assert meter.counts == jmeter.counts
    assert meter.counts["model_sync"] > 0
    assert [r["comm_bytes"] for r in hist] == [r["comm_bytes"] for r in jhist]


@pytest.mark.parametrize("method", ALL_METHODS)
def test_run_compiled_matches_reference_run_compiled(method):
    jb, b = _bundles(lm=False)
    cm, jcm = _cost_models(jb, b)
    fkw = _fkw(method)
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False)
    jstate = jtr.init(0)
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                             device="cpu", method=method)
    x, y = data.synthetic_classification(120, NARROW["in_shape"], 10,
                                         signal=12.0)
    jx, jy = jdata.synthetic_classification(120, NARROW["in_shape"], 10,
                                            signal=12.0)
    jmeter, meter = JCommMeter(), CommMeter()
    jstate, jhist = jtr.run_compiled(jstate, jdata.FederatedBatcher(
        jdata.partition_iid(jx, jy, N), B, H), 4, chunk=3, log_every=1,
        meter=jmeter, cost_model=jcm)
    tr = Trainer(b, FSLConfig(**fkw))
    state, hist = tr.run_compiled(state, data.FederatedBatcher(
        data.partition_iid(x, y, N), B, H), 4, chunk=3, log_every=1,
        meter=meter, cost_model=cm)
    assert len(hist) == len(jhist) == 4
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in ("round", "aggregated", "comm_bytes"):
            assert row[k] == jrow[k]
        for k in set(row) - {"round", "aggregated", "comm_bytes"}:
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4,
                                       err_msg=f"round {row['round']} {k}")
    assert meter.as_dict() == jmeter.as_dict()
    got = state_to_numpy(state, method=method)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    assert int(got["round"]) == int(want["round"]) == 4 * H // (
        H if method == "cse_fsl" else 1)
    for key in set(want) - {"round"}:
        for (path, a), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                jax.tree_util.tree_leaves_with_path(want[key]["params"])):
            np.testing.assert_allclose(a, w, rtol=0, atol=1e-5,
                                       err_msg=key + jax.tree_util.keystr(
                                           path))
