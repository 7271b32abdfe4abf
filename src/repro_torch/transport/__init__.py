"""Wire-level transport: what crosses the client<->server link
(``repro.transport``).

Every upload (smashed activations + labels) and every reply of a blocking
method (the cut-layer gradient) passes through a :class:`Transport` whose
:class:`Codec` objects compress the float leaves, one for each direction;
``Codec.wire_bytes`` is what ``CommMeter`` bills, so compressed runs report
the bytes a real wire would carry.

Codecs here (``FSLConfig.codec`` names the uplink's): ``none`` (identity),
the per-tile stochastic quantizers ``int8`` / ``fp8``
(``repro_torch.kernels.quantize``) and ``topk`` (magnitude top-k per row,
value + index pairs on the wire).  Payloads are coded client-stacked:
``encode``/``decode``/``roundtrip`` take ``[n, ...]`` with one client per
row of dim 0, so one kernel launch codes all clients' payloads of a unit;
``wire_bytes`` counts ONE client's payload, given as a tensor or a
``meta`` tensor spec.

Random bits: each client's float leaf gets a 64-bit seed from
:meth:`Transport.unit_seed` (salted per channel: uplink 0, downlink 1), and
the quantizer draws Philox bits from it -- inside the kernel on a card,
with ``kernels.ref.philox_bits`` on the CPU, the same bits either way.
(The JAX package draws ``jax.random`` bits instead; the two streams differ
by design.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import quantize as qk

# The salt of each wire channel in the seed derivation (as in the JAX
# package; the model-sync channels are not coded yet).
CHANNEL_SALTS = {"uplink": 0, "downlink": 1, "model_up": 2, "model_down": 3}

_M64 = (1 << 64) - 1


def _rows_cols(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """2D wire view of a payload: all leading axes fold into rows."""
    if len(shape) == 0:
        return 1, 1
    c = shape[-1]
    r = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return r, c


class Codec:
    """One direction of the wire.

    ``encode(payload, seeds=, bits=) -> wire`` maps a client-stacked float
    payload to the dict of tensors that would be serialized;
    ``decode(wire, spec)`` rebuilds a payload of ``spec``'s shape and
    dtype; ``wire_bytes(spec)`` is the exact byte count of one client's
    encoded payload.  Stochastic codecs need ``seeds`` (int64 ``[n]``) or
    ``bits`` (uint32 bits in int32, one ``[R, C]`` per client).
    """

    name: str = ""
    is_identity: bool = False
    stochastic: bool = False

    def encode(self, payload, *, seeds=None, bits=None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def decode(self, wire: Dict[str, torch.Tensor], spec):
        raise NotImplementedError

    def wire_bytes(self, spec) -> int:
        raise NotImplementedError

    def roundtrip(self, payload, *, seeds=None, bits=None):
        """decode(encode(x)) — the lossy map the receiving end trains on."""
        return self.decode(self.encode(payload, seeds=seeds, bits=bits),
                           payload)

    def __repr__(self):
        return f"<Codec {self.name}>"


class IdentityCodec(Codec):
    """The fp32 wire: encode/decode are the identity, bytes are raw."""

    name = "none"
    is_identity = True

    def encode(self, payload, *, seeds=None, bits=None):
        return {"x": payload}

    def decode(self, wire, spec):
        return wire["x"]

    def roundtrip(self, payload, *, seeds=None, bits=None):
        return payload

    def wire_bytes(self, spec) -> int:
        return spec.numel() * spec.element_size()


@dataclasses.dataclass(frozen=True)
class _QuantCodec(Codec):
    """Shared machinery of the int8/fp8 per-tile quantizers (8x128 tiles,
    one fp32 scale per tile)."""

    stochastic: bool = True

    fmt = ""                     # set by subclasses
    _itemsize = 1

    def encode(self, payload, *, seeds=None, bits=None):
        n = payload.shape[0]
        r, c = _rows_cols(tuple(payload.shape[1:]))
        if self.stochastic and seeds is None and bits is None:
            raise ValueError(f"codec {self.name!r} is stochastic; pass "
                             "seeds= or bits= to encode()")
        x = payload.reshape(n, r, c).float().contiguous()
        q, scales = qk.quantize_2d(x, bits, seeds=seeds, fmt=self.fmt,
                                   stochastic=self.stochastic)
        return {"q": q, "scale": scales}

    def decode(self, wire, spec):
        x = qk.dequantize_2d(wire["q"], wire["scale"], dtype=spec.dtype)
        return x.reshape(spec.shape)

    def wire_bytes(self, spec) -> int:
        r, c = _rows_cols(tuple(spec.shape))
        tiles = -(-r // qk.BT) * -(-c // qk.BC)
        return r * c * self._itemsize + tiles * 4


class Int8Codec(_QuantCodec):
    name = "int8"
    fmt = "int8"


class Fp8Codec(_QuantCodec):
    name = "fp8"
    fmt = "fp8"


@dataclasses.dataclass(frozen=True)
class TopKCodec(Codec):
    """Magnitude top-k per row of the 2D wire view: ``k = max(1, min(c,
    round(ratio c)))`` fp32 values with their int32 indices cross the wire,
    and the receiver scatters them into a dense zero payload.  Where the
    k-th largest |x| ties, the kept indices may differ from the JAX
    package's; the decoded payload differs only if the tied values do."""

    ratio: float = 0.1           # kept fraction of the last axis
    name = "topk"

    def _k(self, c: int) -> int:
        return max(1, min(c, int(round(self.ratio * c))))

    def encode(self, payload, *, seeds=None, bits=None):
        n = payload.shape[0]
        r, c = _rows_cols(tuple(payload.shape[1:]))
        x = payload.reshape(n, r, c).float()
        idx = torch.topk(x.abs(), self._k(c), dim=-1).indices
        return {"values": torch.gather(x, -1, idx),
                "indices": idx.to(torch.int32)}

    def decode(self, wire, spec):
        n = spec.shape[0]
        r, c = _rows_cols(tuple(spec.shape[1:]))
        dense = torch.zeros((n, r, c), dtype=torch.float32,
                            device=wire["values"].device)
        dense.scatter_(-1, wire["indices"].long(), wire["values"])
        return dense.reshape(spec.shape).to(spec.dtype)

    def wire_bytes(self, spec) -> int:
        r, c = _rows_cols(tuple(spec.shape))
        return r * self._k(c) * (4 + 4)      # fp32 value + int32 index


_CODECS: Dict[str, Codec] = {}


def register_codec(cls):
    """Class decorator: makes ``cls.name`` resolvable by :func:`get_codec`.
    Duplicate names are an error, never a silent overwrite."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    if cls.name in _CODECS:
        raise ValueError(f"duplicate codec name {cls.name!r}")
    _CODECS[cls.name] = cls()
    return cls


for _cls in (IdentityCodec, Int8Codec, Fp8Codec, TopKCodec):
    register_codec(_cls)


def get_codec(name: Union[str, Codec]) -> Codec:
    if isinstance(name, Codec):
        return name
    try:
        return _CODECS[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; registered: "
                       f"{available_codecs()}") from None


def available_codecs() -> tuple:
    return tuple(sorted(_CODECS))


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


@dataclasses.dataclass(frozen=True)
class Transport:
    """The wires between clients and server: an uplink codec for the
    smashed-data payloads and a downlink codec for the gradient replies of
    blocking methods.  Integer leaves (labels) pass through uncoded; every
    float leaf is coded with its own seed per (seed, unit, channel, client,
    leaf).

    ``bits_fn(unit, client, leaf, salt, shape) -> uint32 [R, C]`` replaces
    the Philox bits with caller bits; it exists so tests can feed the JAX
    package's ``jax.random`` bits, and the main path never sets it.
    """

    uplink: Codec = _CODECS["none"]
    downlink: Codec = _CODECS["none"]
    seed: int = 0
    bits_fn: Optional[Callable] = None

    @property
    def is_identity(self) -> bool:
        return self.uplink.is_identity and self.downlink.is_identity

    def unit_seed(self, unit: int, client: int, salt: int, leaf: int) -> int:
        """64-bit seed (as a signed int64 value) of one client's float leaf
        in upload unit ``unit`` (the ``state["round"]`` counter) on the
        channel of ``salt``: a splitmix64 chain over (transport seed, unit,
        salt, client, leaf)."""
        z = _splitmix64(self.seed & _M64)
        for v in (unit, salt, client, leaf):
            z = _splitmix64(z ^ (int(v) & _M64))
        return z - (1 << 64) if z >= 1 << 63 else z

    def _code(self, codec: Codec, payload, unit: int, salt: int):
        if codec.is_identity:
            return payload
        single = isinstance(payload, torch.Tensor)
        leaves = [payload] if single else list(payload)
        out = []
        for i, leaf in enumerate(leaves):
            if leaf.is_floating_point():
                n = leaf.shape[0]
                seeds = bits = None
                if codec.stochastic and self.bits_fn is not None:
                    rc = _rows_cols(tuple(leaf.shape[1:]))
                    bits = torch.stack([torch.from_numpy(np.array(
                        self.bits_fn(unit, cl, i, salt, rc),
                        dtype=np.uint32).view(np.int32))
                        for cl in range(n)]).to(leaf.device)
                elif codec.stochastic:
                    seeds = torch.tensor(
                        [self.unit_seed(unit, cl, salt, i) for cl in range(n)],
                        dtype=torch.int64).to(leaf.device)
                leaf = codec.roundtrip(leaf, seeds=seeds, bits=bits)
            out.append(leaf)
        return out[0] if single else type(payload)(out)

    def code_uplink(self, payload, unit: int):
        """Code a client-stacked upload (a tensor or a tuple of tensors,
        each ``[n, ...]``) of upload unit ``unit``."""
        return self._code(self.uplink, payload, unit, CHANNEL_SALTS["uplink"])

    def code_downlink(self, payload, unit: int):
        """Code a client-stacked reply of upload unit ``unit`` (the same
        ``unit`` as that unit's upload; salt 1)."""
        return self._code(self.downlink, payload, unit,
                          CHANNEL_SALTS["downlink"])

    def _payload_bytes(self, codec: Codec, spec_tree, ints: bool) -> int:
        leaves = [spec_tree] if isinstance(spec_tree, torch.Tensor) \
            else list(spec_tree)
        total = 0
        for leaf in leaves:
            if leaf.is_floating_point():
                total += codec.wire_bytes(leaf)
            elif ints:
                total += leaf.numel() * leaf.element_size()
        return int(total)

    def uplink_wire_bytes(self, spec_tree) -> int:
        """Exact wire bytes of the FLOAT leaves of one client's upload spec
        (labels are billed separately by CommProfile)."""
        return self._payload_bytes(self.uplink, spec_tree, ints=False)

    def uplink_payload_bytes(self, spec_tree) -> int:
        """All wire bytes of one client's upload: coded float leaves plus
        raw integer side channels (labels)."""
        return self._payload_bytes(self.uplink, spec_tree, ints=True)

    def downlink_wire_bytes(self, spec_tree) -> int:
        """Exact wire bytes of the float leaves of one client's reply."""
        return self._payload_bytes(self.downlink, spec_tree, ints=False)

    def downlink_payload_bytes(self, spec_tree) -> int:
        """All wire bytes of one client's reply, integer leaves included."""
        return self._payload_bytes(self.downlink, spec_tree, ints=True)


def make_transport(uplink: Union[str, Codec] = "none",
                   downlink: Union[str, Codec] = "none",
                   seed: int = 0) -> Transport:
    return Transport(uplink=get_codec(uplink), downlink=get_codec(downlink),
                     seed=seed)


def resolve_transport(transport, fsl=None) -> Transport:
    """Normalize a Trainer/method ``transport=`` argument: ``None`` reads
    ``fsl.codec``, a string names the uplink codec, a Transport passes
    through.  The downlink is coded only through an explicit Transport."""
    if isinstance(transport, Transport):
        return transport
    if transport is None:
        transport = getattr(fsl, "codec", "none") if fsl is not None \
            else "none"
    return make_transport(transport or "none")
