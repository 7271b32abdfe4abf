"""The port's per-tile quantizer against the JAX package's.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel
``repro.kernels.quantize.quantize_2d`` in interpret mode.  The port's
plain version (``repro_torch.kernels.ref``, which is what its wrapper runs
on CPU tensors) must give the same q bytes and scales BITWISE when fed the
same uint32 bits.  The CUDA kernels are held to the same plain version on
the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as jqk
from repro.transport import get_codec as jget_codec
from repro_torch.kernels import quantize as qk
from repro_torch.kernels import ref
from repro_torch.transport import get_codec

SHAPES = [(864, 64), (13, 200), (7, 5)]


def _inputs(shape, seed, wide=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 2
    if wide:
        # magnitudes over 8 decades, one 1.0 per tile: y = x / scale reaches
        # the e4m3 subnormal range (|y| < 2^-6) and below its smallest step
        x *= 10.0 ** rng.uniform(-8, 0, size=shape).astype(np.float32)
        x[::8, ::128] = 1.0
    bits = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return x, bits


def _bytes_np(q):
    return np.asarray(q).view(np.uint8)


def _port(x, bits, fmt, stochastic):
    q, s = ref.quantize_2d(torch.from_numpy(x),
                           torch.from_numpy(bits.view(np.int32)), fmt=fmt,
                           stochastic=stochastic)
    return q.view(torch.uint8).numpy(), s.numpy()


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape,wide", [(s, False) for s in SHAPES]
                         + [((16, 256), True)])
def test_plain_quantize_matches_jax_kernel_bitwise(fmt, stochastic, shape,
                                                   wide):
    x, bits = _inputs(shape, seed=shape[0] * 1000 + shape[1], wide=wide)
    jq, js = jqk.quantize_2d(jnp.asarray(x), jnp.asarray(bits), fmt=fmt,
                             stochastic=stochastic, interpret=True)
    pq, ps = _port(x, bits, fmt, stochastic)
    np.testing.assert_array_equal(pq, _bytes_np(jq))
    np.testing.assert_array_equal(ps.view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    if wide and fmt == "fp8":
        y = np.abs(x) / np.repeat(np.repeat(ps, 8, 0), 128, 1)[:shape[0],
                                                              :shape[1]]
        assert ((y > 0) & (y < 2.0 ** -6)).sum() > 100   # subnormals covered


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_dequantize_matches_jax(fmt):
    x, bits = _inputs((13, 200), seed=3)
    jq, js = jqk.quantize_2d(jnp.asarray(x), jnp.asarray(bits), fmt=fmt,
                             interpret=True)
    pq, ps = ref.quantize_2d(torch.from_numpy(x),
                             torch.from_numpy(bits.view(np.int32)), fmt=fmt)
    jy = np.asarray(jqk.dequantize_2d(jq, js))
    py = qk.dequantize_2d(pq, ps).numpy()
    np.testing.assert_array_equal(py.view(np.uint32), jy.view(np.uint32))


@pytest.mark.parametrize("name", ["none", "int8", "fp8"])
@pytest.mark.parametrize("shape", [(24, 6, 6, 64), (13, 200), (7, 5),
                                   (6, 10, 40)])
def test_wire_bytes_match_reference_and_emitted(name, shape):
    spec = torch.empty(shape, device="meta")
    want = jget_codec(name).wire_bytes(jax.ShapeDtypeStruct(shape,
                                                            jnp.float32))
    codec = get_codec(name)
    assert codec.wire_bytes(spec) == want
    # ...and equal the bytes encode actually emits (one client, stacked)
    x = torch.randn((1,) + shape)
    wire = codec.encode(x, seeds=torch.tensor([5]))
    assert sum(t.numel() * t.element_size() for t in wire.values()) == want


@pytest.mark.parametrize("name", ["none", "int8", "fp8"])
def test_transport_upload_bytes_match_reference(name):
    """One client's (smashed, labels) upload: coded float bytes alone, and
    with the raw int32 labels added."""
    from repro.transport import make_transport as jmake_transport
    from repro_torch.transport import make_transport
    spec = (torch.empty((24, 6, 6, 64), device="meta"),
            torch.empty((24,), dtype=torch.int32, device="meta"))
    jspec = (jax.ShapeDtypeStruct((24, 6, 6, 64), jnp.float32),
             jax.ShapeDtypeStruct((24,), jnp.int32))
    tp, jtp = make_transport(name), jmake_transport(name)
    assert tp.uplink_wire_bytes(spec) == jtp.uplink_wire_bytes(jspec)
    assert tp.uplink_payload_bytes(spec) == jtp.uplink_payload_bytes(jspec)
    assert tp.uplink_payload_bytes(spec) \
        == tp.uplink_wire_bytes(spec) + 24 * 4


def test_philox_matches_random123_known_answers():
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    kats = [((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((0xffffffff,) * 4, (0xffffffff,) * 2,
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in kats:
        got = ref.philox4x32_10(tuple(map(t, ctr)), tuple(map(t, key)))
        assert tuple(int(w) for w in got) == want


def test_philox_bits_layout_determinism_and_disjoint_tiles():
    seed = -0x1234_5678_9ABC_DEF0           # any 64-bit pattern
    b = ref.philox_bits(seed, 16, 256).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        b, ref.philox_bits(seed, 16, 256).numpy().view(np.uint32))
    assert not np.array_equal(
        b, ref.philox_bits(seed + 1, 16, 256).numpy().view(np.uint32))
    # the documented layout: counter (j, i, p // 4, 0), word p % 4,
    # key (low, high) word of the seed
    s = seed & 0xFFFFFFFFFFFFFFFF
    key = (torch.tensor(s & 0xFFFFFFFF), torch.tensor(s >> 32))
    for r, c in [(0, 0), (3, 77), (9, 130), (15, 255)]:
        i, j, p = r // 8, c // 128, (r % 8) * 128 + c % 128
        ctr = tuple(torch.tensor(v) for v in (j, i, p // 4, 0))
        assert int(ref.philox4x32_10(ctr, key)[p % 4]) == b[r, c]
    # four tiles, four disjoint streams: no value repeats across the payload
    assert len(np.unique(b)) == b.size
    # batched seeds give each client its own stream
    seeds = torch.tensor([seed, 7, 8])
    bb = ref.philox_bits(seeds, 16, 256)
    assert bb.shape == (3, 16, 256)
    np.testing.assert_array_equal(bb[0].numpy().view(np.uint32), b)
    assert not torch.equal(bb[1], bb[2])


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_stochastic_roundtrip_is_unbiased(fmt):
    """E[decode(encode(x))] ~= x: averaged over 256 seeds the error falls
    ~sqrt(256)-fold below one draw's (biased rounding would not fall)."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(16, 200)).astype(np.float32))
    xs = x.expand(256, 16, 200).contiguous()
    q, s = qk.quantize_2d(xs, seeds=torch.arange(256, dtype=torch.int64),
                          fmt=fmt)
    y = qk.dequantize_2d(q, s)
    one = (y[0] - x).abs().mean()
    avg = (y.mean(0) - x).abs().mean()
    assert one > 0 and avg < one / 8
    det_q, det_s = qk.quantize_2d(x, fmt=fmt, stochastic=False)
    det = (qk.dequantize_2d(det_q, det_s) - x).abs().mean()
    assert avg < det / 4


def test_quantize_wrapper_argument_checks():
    x = torch.randn(2, 8, 128)
    with pytest.raises(ValueError, match="exactly one"):
        qk.quantize_2d(x)
    with pytest.raises(ValueError, match="exactly one"):
        qk.quantize_2d(x, torch.zeros(2, 8, 128, dtype=torch.int32),
                       seeds=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="format"):
        qk.quantize_2d(x, fmt="int4", stochastic=False)
    with pytest.raises(ValueError, match="cpu or cuda"):
        qk.quantize_2d(x.to("meta"), fmt="int8", stochastic=False)
    # the CPU path of seeds= is the plain quantizer fed philox_bits
    seeds = torch.tensor([11, -3])
    q, s = qk.quantize_2d(x, seeds=seeds)
    rq, rs = ref.quantize_2d(x, ref.philox_bits(seeds, 8, 128))
    assert torch.equal(q, rq) and torch.equal(s, rs)
