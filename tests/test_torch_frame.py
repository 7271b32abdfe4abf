"""The checksum frame (``repro_torch.faults.frame``) and the corruption
seed stream (``repro_torch.faults.model.retry_key``) against the JAX
package's ``repro.faults.frame``.

- ``frame_checksum`` equals the reference's on fp32, bf16, int8, int32,
  bool and empty leaves, whatever the order of the leaves (the port's
  trees go in insertion order, the reference's in sorted-key order).
- Every corruption of a coded payload (200 units x 4 clients) is caught,
  the original payload is untouched, and a bool leaf only ever toggles.
  The port draws the leaf and the bit from its own seed stream, not from
  ``jax.random``: what is held is that the frame catches every flip.
- The retry stream shares no seed with the codec seeds of the same units.
- ``FramedCodec`` is the inner codec's math, 8 bytes heavier.
- A ``check_frame`` that passes everything makes a lossy engine run raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.faults import frame as jframe
from repro_torch.configs.base import FSLConfig
from repro_torch.core import async_trainer as at
from repro_torch.core.bundle import cnn_bundle
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.faults import (FRAME_BYTES, RETRY_FOLD, FramedCodec,
                                LossyWire, check_frame, corrupt_frame,
                                corrupt_payload, frame_checksum, make_frame,
                                retry_key)
from repro_torch.models.cnn import CNNConfig
from repro_torch.transport import (CHANNEL_SALTS, Transport, get_codec,
                                   make_transport)

NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw_leaves(seed):
    """numpy leaves of every wire dtype: (name, array, torch dtype); bf16
    as its uint16 bits."""
    rng = np.random.default_rng(seed)
    return [
        ("q", rng.integers(-128, 128, (3, 8, 128)).astype(np.int8), None),
        ("scale", rng.standard_normal((3, 1, 1)).astype(np.float32), None),
        ("h", rng.integers(0, 1 << 16, (5, 7)).astype(np.uint16),
         torch.bfloat16),
        ("idx", rng.integers(-2**31, 2**31, (2, 13)).astype(np.int32), None),
        ("mask", rng.random((3, 5)) < 0.5, None),
        ("odd", rng.integers(-128, 128, (7,)).astype(np.int8), None),
        ("empty", np.zeros((0, 4), np.float32), None),
    ]


def _trees(seed, order=None):
    """The same values as a port tree (insertion order ``order``) and a
    reference tree."""
    leaves = _raw_leaves(seed)
    order = order or range(len(leaves))
    port, ref = {}, {}
    for i in order:
        name, arr, tdt = leaves[i]
        if tdt is torch.bfloat16:
            port[name] = torch.from_numpy(arr.view(np.int16)).view(tdt)
            ref[name] = jnp.asarray(arr).view(jnp.bfloat16)
        else:
            port[name] = torch.from_numpy(arr.copy())
            ref[name] = jnp.asarray(arr)
    return port, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_checksum_matches_reference(seed):
    """Each leaf alone, then every leaf in two insertion orders."""
    port, ref = _trees(seed)
    for name in port:
        assert frame_checksum({name: port[name]}) == \
            jframe.frame_checksum({name: ref[name]}), name
    want = jframe.frame_checksum(ref)
    assert frame_checksum(port) == want
    rev, _ = _trees(seed, order=list(range(len(port)))[::-1])
    assert list(rev) != list(port) and frame_checksum(rev) == want
    assert frame_checksum((port["q"], [port["h"], port["mask"]])) == \
        jframe.frame_checksum((ref["q"], [ref["h"], ref["mask"]]))
    assert frame_checksum({"e": port["empty"]}) == (0, 0)
    assert check_frame(port, make_frame(port))


def _bytes(t):
    return t.to(torch.uint8) if t.dtype == torch.bool \
        else t.reshape(-1).view(torch.uint8)


def test_every_corruption_caught():
    """200 units x 4 clients of a coded payload with every wire dtype: the
    frame catches each flip, the payload passed in is untouched, bool
    leaves toggle one value and each leaf is hit."""
    port, _ = _trees(7)
    before = {k: v.clone() for k, v in port.items()}
    tp = Transport(seed=3)
    fr = make_frame(port)
    hit = set()
    for unit in range(200):
        for c in range(4):
            bad, fr2 = corrupt_frame(port, fr, retry_key(tp, unit, c))
            assert fr2 == fr and not check_frame(bad, fr2), (unit, c)
            changed = [k for k in port
                       if not np.array_equal(_bytes(bad[k]), _bytes(port[k]))]
            assert len(changed) == 1 and changed[0] != "empty"
            hit.add(changed[0])
            if changed[0] == "mask":
                assert int((bad["mask"] != port["mask"]).sum()) == 1
    assert hit == set(port) - {"empty"}
    for k, v in port.items():
        assert torch.equal(v, before[k])
    assert corrupt_payload({"e": port["empty"]}, 1)["e"] is port["empty"]


def test_retry_stream_disjoint_from_codec_seeds():
    """The corruption seeds of units 0..199 and clients 0..3 against every
    codec seed of the same units and clients (four channels, eight leaves)
    and of the transport's next seed: no seed in common, none repeated."""
    for seed in (0, 5):
        tp = Transport(seed=seed)
        retry = [retry_key(tp, u, c) for u in range(200) for c in range(4)]
        assert len(set(retry)) == len(retry)
        codec = set()
        for salt in CHANNEL_SALTS.values():
            codec |= set(tp.seed_table(range(200), salt, 4, 8).reshape(-1)
                         .tolist())
        assert not codec & set(retry)
        assert retry_key(tp, 0) == retry_key(tp, 0, 0)
        assert retry_key(tp, 3, 1) == tp.unit_seed(RETRY_FOLD + 3, 1, 4, 0)
        assert retry_key(Transport(seed=seed + 1), 3, 1) != retry_key(tp, 3,
                                                                      1)


@pytest.mark.parametrize("inner", ["none", "int8", "fp8", "topk"])
def test_framed_codec_transparent_and_heavier(inner):
    codec = get_codec(inner)
    framed = FramedCodec(inner=codec)
    assert framed.name == f"framed({inner})"
    assert framed.is_identity == codec.is_identity
    assert framed.stochastic == codec.stochastic
    spec = torch.empty((3, 40, 130), device="meta")
    assert framed.wire_bytes(spec[0]) == codec.wire_bytes(spec[0]) + \
        FRAME_BYTES == jframe.FramedCodec(inner=_jcodec(inner)).wire_bytes(
            jnp.zeros((40, 130), jnp.float32))
    x = torch.randn((3, 40, 130), generator=torch.Generator().manual_seed(0))
    seeds = torch.tensor([11, 12, 13], dtype=torch.int64)
    kw = dict(seeds=seeds) if codec.stochastic else {}
    a, b = framed.roundtrip(x, **kw), codec.roundtrip(x, **kw)
    assert torch.equal(a, b)
    wire = framed.encode(x, **kw)
    assert torch.equal(framed.decode(wire, x), b)


def _jcodec(name):
    from repro.transport import get_codec as jget_codec
    return jget_codec(name)


def test_sabotaged_check_makes_lossy_run_raise(monkeypatch):
    """A lossy run (half the transmissions lost) verifies its frames; with a
    ``check_frame`` that passes everything, the corruption goes undetected
    and the engine raises before the corrupted copy could train."""
    b = cnn_bundle(CNNConfig(**NARROW), device="cpu")
    x, y = synthetic_classification(60, NARROW["in_shape"], 10, seed=0,
                                    signal=12.0)
    fed = partition_iid(x, y, 2, seed=0)
    fsl = FSLConfig(num_clients=2, h=2, lr=0.1)
    faults = LossyWire(loss_rate=0.5, seed=1)
    eng = at.AsyncTrainer(b, fsl, faults=faults,
                          transport=make_transport("int8"))
    assert faults.verify_frames
    eng.run(eng.init(0), FederatedBatcher(fed, 4, 2), 1)
    assert eng.fault_stats.retries > 0
    monkeypatch.setattr(at, "check_frame", lambda tree, frame: True)
    with pytest.raises(RuntimeError, match="failed to detect"):
        eng.run(eng.init(0), FederatedBatcher(fed, 4, 2), 1)
