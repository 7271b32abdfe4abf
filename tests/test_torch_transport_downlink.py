"""The rest of the wire and the accounting, the port against the JAX package:
the ``topk`` codec, the downlink channel, every ``CommProfile`` field for
the four methods and every codec, the analytic Table II helpers, and
gradient clipping.

Exact where the reference is exact: decoded top-k payloads and the coded
downlink (the same input and, for int8, the reference's own salt-1
``jax.random`` bits) are compared bitwise, byte counts and profiles
field for field; the clipped gradients at rtol 1e-6 (fp32 norms summed in
another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.core import accounting as jacc
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.models.cnn import CNNConfig as JCNNConfig
from repro.optim import clip_by_global_norm as jclip
from repro.transport import get_codec as jget_codec
from repro.transport import make_transport as jmake_transport
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import accounting as acc
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.models.cnn import CNNConfig
from repro_torch.optim import clip_by_global_norm
from repro_torch.transport import (Transport, TopKCodec, get_codec,
                                   make_transport)

N, H, B = 3, 2, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")


def _payload(shape, seed, relu=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.maximum(x, 0.0) if relu else x


@pytest.mark.parametrize("shape,relu,ratio", [
    ((3, 24, 6, 6, 64), True, 0.1), ((3, 24, 6, 6, 64), False, 0.1),
    ((2, 7, 300), True, 0.05), ((2, 13), False, 0.5), ((2, 5, 3), True, 1.0)])
def test_topk_matches_reference(shape, relu, ratio):
    """Per client, the decoded payload equals the JAX codec's bit for bit,
    also where most of a row is ReLU zeros (ties at the k-th place), and
    the wire bytes agree with the reference and with what is emitted."""
    x = _payload(shape, 0, relu)
    if relu:
        x[..., : shape[-1] // 2] = 0.0       # more zeros than k in a row
    codec, jcodec = TopKCodec(ratio=ratio), \
        dataclasses.replace(jget_codec("topk"), ratio=ratio)
    got = codec.roundtrip(torch.from_numpy(x)).numpy()
    wire = codec.encode(torch.from_numpy(x))
    for c in range(shape[0]):
        want = np.asarray(jcodec.roundtrip(jnp.asarray(x[c])))
        np.testing.assert_array_equal(got[c], want)
        spec = torch.empty(shape[1:], device="meta")
        assert codec.wire_bytes(spec) == jcodec.wire_bytes(
            jax.ShapeDtypeStruct(shape[1:], jnp.float32))
    assert sum(t.numel() * t.element_size() for t in wire.values()) \
        == shape[0] * codec.wire_bytes(torch.empty(shape[1:], device="meta"))
    assert get_codec("topk").ratio == jget_codec("topk").ratio == 0.1


def _tied_payload(kind, shape, seed):
    """Payloads whose magnitudes tie: bf16 Gaussians (the LM paths' smashed
    data; 2 of a 1,024-wide row share each bf16 magnitude on average) or
    fp32 integers drawn from [-8, 8] (17 values)."""
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32))


@pytest.mark.parametrize("ratio", [0.1, 0.5])
@pytest.mark.parametrize("kind,shape", [
    ("bf16", (2, 64, 1024)), ("bf16", (3, 4, 6, 6, 64)),
    ("ints", (2, 64, 1024)), ("ints", (3, 7, 300))])
def test_topk_ties_match_reference(kind, shape, ratio):
    """Where magnitudes tie, the wire (indices in their order, values) and
    the decoded payload equal the JAX codec's bit for bit, per client:
    ``jax.lax.top_k`` puts the lower index first among equals."""
    x = _tied_payload(kind, shape, 3)
    codec, jcodec = TopKCodec(ratio=ratio), \
        dataclasses.replace(jget_codec("topk"), ratio=ratio)
    wire = codec.encode(x)
    got = codec.decode(wire, x).float().numpy()
    xj = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if kind == "bf16" else jnp.float32)
    for c in range(shape[0]):
        jwire = jcodec.encode(xj[c])
        np.testing.assert_array_equal(wire["indices"][c].numpy(),
                                      np.asarray(jwire["indices"]))
        np.testing.assert_array_equal(wire["values"][c].numpy(),
                                      np.asarray(jwire["values"]))
        want = np.asarray(jcodec.decode(jwire, xj[c]).astype(jnp.float32))
        np.testing.assert_array_equal(got[c], want)


@pytest.mark.parametrize("codec", ["int8", "fp8", "topk"])
def test_code_downlink_matches_reference(codec):
    """``code_downlink`` of a client-stacked reply equals the reference's
    per-client salt-1 coding: ``fold_in(unit_key(u, salt=1), client)``,
    then ``fold_in(leaf)`` and ``jax.random.bits``; the uplink and the
    downlink of one unit draw different bits."""
    unit, x = 5, _payload((3, 24, 200), 1)
    jtp = jmake_transport("none", codec, seed=3)

    def bits_fn(u, client, leaf, salt, shape):
        key = jax.random.fold_in(jtp.unit_key(u, salt=salt), client)
        return np.asarray(jax.random.bits(jax.random.fold_in(key, leaf),
                                          shape, jnp.uint32))

    tp = Transport(uplink=get_codec(codec), downlink=get_codec(codec),
                   seed=3, bits_fn=bits_fn)
    got = tp.code_downlink(torch.from_numpy(x), unit).numpy()
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jtp.unit_key(unit, salt=1), jnp.arange(3))
    want = np.asarray(jax.vmap(jtp.code_downlink)(jnp.asarray(x), keys))
    np.testing.assert_array_equal(got, want)
    up = tp.code_uplink(torch.from_numpy(x), unit).numpy()
    assert np.array_equal(up, got) == (codec == "topk")
    assert not tp.is_identity and not make_transport("none", codec).is_identity
    assert make_transport().is_identity
    spec = torch.empty((24, 200), device="meta")
    jspec = jax.ShapeDtypeStruct((24, 200), jnp.float32)
    assert tp.downlink_wire_bytes(spec) == jtp.downlink_wire_bytes(jspec)
    assert tp.downlink_payload_bytes((spec,)) \
        == jtp.downlink_payload_bytes((jspec,))


def _cost_models(n):
    jb = jcnn_bundle(JCNNConfig(**NARROW))
    b = cnn_bundle(CNNConfig(**NARROW), device="cpu")
    pa = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    jcm = jacc.CostModel(n=n, q=jb.smashed_bytes_per_sample, d_local=40,
                         w_client=jbytes_of(pa["client"]),
                         w_server=jbytes_of(pa["server"]),
                         aux=jbytes_of(pa["aux"]))
    cm = acc.CostModel(**dataclasses.asdict(jcm))
    assert acc.CostModel(n=n, q=b.smashed_bytes_per_sample, d_local=40,
                         w_client=bytes_of(b.specs["client"]),
                         w_server=bytes_of(b.specs["server"]),
                         aux=bytes_of(b.specs["aux"])) == cm
    return (jb, jcm), (b, cm)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("up", ["none", "int8", "fp8", "topk"])
@pytest.mark.parametrize("down", ["none", "int8"])
def test_comm_profile_matches_reference(method, up, down):
    """Every CommProfile field, the wire fields included, equals the
    reference's, with payload specs from the hooks run on shape-only
    inputs (``meta`` tensors in the port)."""
    (jb, jcm), (b, cm) = _cost_models(N)
    fkw = dict(num_clients=N, h=H, method=method)
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((N, H, B) + NARROW["in_shape"])
             .astype(np.float32),
             rng.integers(0, 10, (N, H, B)).astype(np.int32))
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False,
                   transport=jmake_transport(up, down))
    tr = Trainer(b, FSLConfig(**fkw), transport=make_transport(up, down))
    want = dataclasses.asdict(jtr.comm_profile(jcm, B, batch=batch))
    got = dataclasses.asdict(tr.comm_profile(cm, B, batch=batch))
    assert got == want
    if method in ("fsl_mc", "fsl_oc") and down != "none":
        assert got["downlink_grads_wire"] > 0
    _, reply = tr.method.payload_specs(b, tr.fsl, batch)
    assert (reply is None) == (method in ("cse_fsl", "fsl_an"))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("h", [1, 5, 10, 25, 50])
def test_table2_helpers_match_reference(method, h):
    (_, jcm), (_, cm) = _cost_models(5)
    jcm, cm = (dataclasses.replace(c, d_local=10_000) for c in (jcm, cm))
    assert acc.comm_one_epoch(cm, method, h=h) \
        == jacc.comm_one_epoch(jcm, method, h=h)
    assert acc.server_storage(cm, method) == jacc.server_storage(jcm, method)
    assert acc.total_storage(cm, method) == jacc.total_storage(jcm, method)
    meter, jmeter = acc.CommMeter(), jacc.CommMeter()
    acc.meter_round(meter, cm, method, h, B)
    jacc.meter_round(jmeter, jcm, method, h, B)
    acc.meter_aggregation(meter, cm, method)
    jacc.meter_aggregation(jmeter, jcm, method)
    assert meter.as_dict() == jmeter.as_dict()
    with pytest.raises(ValueError):
        acc.server_storage(cm, "no_such_method")


@pytest.mark.parametrize("max_norm,dtype", [
    (0.5, np.float32), (1e3, np.float32), (0.5, "bfloat16")])
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    """The fp32 norm over the whole tree and the ``min(1, max / (norm +
    1e-12))`` scale, as the reference computes them (also on bf16 grads,
    whose clipped values come out fp32 in both)."""
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((4, 5)).astype(dt),
            "b": {"c": rng.standard_normal((7,)).astype(dt)}}
    got, norm = clip_by_global_norm(
        {"a": tensor_from_numpy(tree["a"], "cpu"),
         "b": {"c": tensor_from_numpy(tree["b"]["c"], "cpu")}}, max_norm)
    want, jnorm = jclip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for g, w in ((got["a"], want["a"]), (got["b"]["c"], want["b"]["c"])):
        assert g.dtype == torch.float32 and np.asarray(w).dtype == np.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    scaled = float(np.sqrt(sum(float((g.double() ** 2).sum())
                               for g in (got["a"], got["b"]["c"]))))
    assert scaled <= max_norm * (1 + 1e-6)
