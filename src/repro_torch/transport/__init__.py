"""Wire-level transport: what crosses the client<->server link
(``repro.transport``).

Every upload (smashed activations + labels), every reply of a blocking
method (the cut-layer gradient) and, at aggregation, every client's model
and the averaged model sent back pass through a :class:`Transport` whose
:class:`Codec` objects compress the float leaves, one for each channel;
``Codec.wire_bytes`` is what ``CommMeter`` bills, so compressed runs report
the bytes a real wire would carry.

Codecs here (``FSLConfig.codec`` names the uplink's, ``model_codec`` the
model-sync wire's): ``none`` (identity), the per-tile stochastic
quantizers ``int8`` / ``fp8`` (``repro_torch.kernels.quantize``) and
``topk`` (magnitude top-k per row, value + index pairs on the wire).
Payloads are coded client-stacked: ``encode``/``decode``/``roundtrip``
take ``[n, ...]`` with one client per row of dim 0, so one kernel launch
codes all clients' payloads of a unit; ``wire_bytes`` counts ONE client's
payload, given as a tensor or a ``meta`` tensor spec.

Random bits: each client's float leaf gets a 64-bit seed,
:meth:`Transport.unit_seed` of (transport seed, unit, channel salt,
client, leaf) -- salts uplink 0, downlink 1, model up 2, model down 3 --
and the quantizer draws Philox bits from it: inside the kernel on a card,
with ``kernels.ref.philox_bits`` on the CPU, the same bits either way.
The round step never derives a seed itself: the trainer stages the seeds
of a run of units on the device (:meth:`Transport.stage_seeds`, one int64
``[leaves, n]`` table per unit and channel) and the codecs index them, so a
captured round reads this round's seeds, not the capture's.  (The JAX
package draws ``jax.random`` bits instead; the two streams differ by
design.)
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.kernels import quantize as qk

# The salt of each wire channel in the seed derivation (as in the JAX
# package).
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
    and the receiver scatters them into a dense zero payload.  Among equal
    magnitudes the lower index comes first, as ``jax.lax.top_k`` orders
    them: the indices are the first k of a stable descending sort of |x|,
    so the wire (its index order included) and the decoded payload equal
    the JAX package's also where |x| ties, as it does in bf16 payloads."""

    ratio: float = 0.1           # kept fraction of the last axis
    name = "topk"

    def _k(self, c: int) -> int:
        return max(1, min(c, int(round(self.ratio * c))))

    def encode(self, payload, *, seeds=None, bits=None):
        n = payload.shape[0]
        r, c = _rows_cols(tuple(payload.shape[1:]))
        x = payload.reshape(n, r, c).float()
        idx = torch.sort(x.abs(), dim=-1, descending=True,
                         stable=True).indices[..., :self._k(c)]
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


def _splitmix64_np(z: np.ndarray) -> np.ndarray:
    """:func:`_splitmix64` elementwise on uint64 arrays (numpy's uint64
    arithmetic wraps mod 2^64)."""
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _walk(tree, fn):
    """``tree_map(fn)`` with ``fn(index, leaf)``, leaves numbered in
    ``tree_leaves`` order."""
    count = itertools.count()
    return tree_map(lambda leaf: fn(next(count), leaf), tree)


@dataclasses.dataclass(frozen=True)
class Transport:
    """The wires between clients and server: an uplink codec for the
    smashed-data payloads, a downlink codec for the gradient replies of
    blocking methods, and a codec pair for the FedAvg model-sync wire (each
    client's model up at aggregation, the averaged model down).  Integer
    leaves (labels) pass through uncoded; every float leaf is coded with its
    own seed per (seed, unit, channel, client, leaf).

    ``bits_fn(unit, client, leaf, salt, shape) -> uint32 [R, C]`` replaces
    the Philox bits with caller bits; it exists so tests can feed the JAX
    package's ``jax.random`` bits, reads the unit counter on the host, and
    the main path never sets it.
    """

    uplink: Codec = _CODECS["none"]
    downlink: Codec = _CODECS["none"]
    model_up: Codec = _CODECS["none"]
    model_down: Codec = _CODECS["none"]
    seed: int = 0
    bits_fn: Optional[Callable] = None

    @property
    def is_identity(self) -> bool:
        return self.uplink.is_identity and self.downlink.is_identity

    @property
    def model_identity(self) -> bool:
        """True when the model-sync wire is the raw one: aggregation then
        runs no codec op at all."""
        return self.model_up.is_identity and self.model_down.is_identity

    def seeded(self, channel: str) -> bool:
        """The codec of ``channel`` draws random bits (needs seeds)."""
        codec = getattr(self, channel)
        return codec.stochastic and not codec.is_identity

    def unit_seed(self, unit: int, client: int, salt: int, leaf: int) -> int:
        """64-bit seed (as a signed int64 value) of one client's float leaf
        in upload unit ``unit`` (the ``state["round"]`` counter) on the
        channel of ``salt``: a splitmix64 chain over (transport seed, unit,
        salt, client, leaf)."""
        z = _splitmix64(self.seed & _M64)
        for v in (unit, salt, client, leaf):
            z = _splitmix64(z ^ (int(v) & _M64))
        return z - (1 << 64) if z >= 1 << 63 else z

    def seed_table(self, units, salt: int, clients: int,
                   leaves: int) -> np.ndarray:
        """int64 ``[len(units), leaves, clients]``: :meth:`unit_seed` of
        every (unit, leaf, client) on the channel of ``salt``, vectorized."""
        z = _splitmix64_np(np.full((1, 1, 1), self.seed & _M64, np.uint64))
        for v in (np.asarray(units, np.uint64).reshape(-1, 1, 1),
                  np.uint64(salt),
                  np.arange(clients, dtype=np.uint64).reshape(1, 1, -1),
                  np.arange(leaves, dtype=np.uint64).reshape(1, -1, 1)):
            z = _splitmix64_np(z ^ v)
        return z.view(np.int64)

    def stage_seeds(self, unit0: int, units: int, n: int,
                    leaves: Dict[str, int]) -> Dict[str, np.ndarray]:
        """The seeds of one round that covers upload units ``unit0 ..
        unit0 + units - 1`` and ends with the counter at ``unit0 + units``
        (where its aggregation, if any, codes the model), per channel of
        ``leaves`` (channel -> number of payload leaves): ``uplink`` and
        ``downlink`` ``[units, leaves, n]``; ``model_up`` ``[leaves, n]``
        and ``model_down`` ``[leaves, 1]`` (the average is coded once, as
        client 0)."""
        out = {}
        for ch in ("uplink", "downlink"):
            if ch in leaves:
                out[ch] = self.seed_table(range(unit0, unit0 + units),
                                          CHANNEL_SALTS[ch], n, leaves[ch])
        for ch, clients in (("model_up", n), ("model_down", 1)):
            if ch in leaves:
                out[ch] = self.seed_table([unit0 + units], CHANNEL_SALTS[ch],
                                          clients, leaves[ch])[0]
        return out

    def _code(self, codec: Codec, payload, salt: int, unit=None,
              seeds=None, client=None):
        """Code every float leaf of the client-stacked tree ``payload``.
        Stochastic codecs take leaf ``i``'s seeds from ``seeds[i]`` (int64
        ``[n]`` on the payload's device: the unit's table on this channel)
        or, given only the Python int ``unit``, derive them on the host
        and copy them over (a convenience for direct calls; the round step
        always passes ``seeds``).

        With ``client`` (the event engine, one upload at a time) the
        payload is ONE client's tree, without the client dim, and is coded
        as client ``client`` of the unit: leaf ``i`` with
        ``unit_seed(unit, client, salt, i)`` (column ``client`` of the
        ``seeds`` table) or ``bits_fn(unit, client, i, salt, ...)``, one
        launch a leaf on the client's own shape -- the noise the stacked
        call draws for that client."""
        if codec.is_identity:
            return payload
        one = client is not None
        if one:
            payload = tree_map(lambda x: x.unsqueeze(0), payload)

        def code(i, leaf):
            if not leaf.is_floating_point():
                return leaf
            n = leaf.shape[0]
            clients = [client] if one else range(n)
            s = bits = None
            if codec.stochastic and self.bits_fn is not None:
                if unit is None:
                    raise ValueError("bits_fn needs the unit counter")
                rc = _rows_cols(tuple(leaf.shape[1:]))
                bits = torch.stack([torch.from_numpy(np.array(
                    self.bits_fn(unit, cl, i, salt, rc),
                    dtype=np.uint32).view(np.int32))
                    for cl in clients]).to(leaf.device)
            elif codec.stochastic and seeds is not None:
                s = seeds[i][client:client + 1] if one else seeds[i]
            elif codec.stochastic:
                if unit is None:
                    raise ValueError(f"codec {codec.name!r} is stochastic: "
                                     "pass seeds= (or unit=)")
                s = torch.tensor([self.unit_seed(unit, cl, salt, i)
                                  for cl in clients], dtype=torch.int64,
                                 device=leaf.device)
            return codec.roundtrip(leaf, seeds=s, bits=bits)

        out = _walk(payload, code)
        return tree_map(lambda x: x[0], out) if one else out

    def code_uplink(self, payload, unit=None, *, seeds=None, client=None):
        """Code a client-stacked upload (a tensor or a tuple of tensors,
        each ``[n, ...]``) of upload unit ``unit`` (salt 0); with
        ``client``, one client's upload (see :meth:`_code`)."""
        return self._code(self.uplink, payload, CHANNEL_SALTS["uplink"],
                          unit, seeds, client)

    def code_downlink(self, payload, unit=None, *, seeds=None, client=None):
        """Code a client-stacked reply of upload unit ``unit`` (the same
        ``unit`` as that unit's upload; salt 1); with ``client``, one
        client's reply."""
        return self._code(self.downlink, payload, CHANNEL_SALTS["downlink"],
                          unit, seeds, client)

    def code_model_up(self, model, unit=None, *, seeds=None):
        """Code every client's model (a tree of ``[n, ...]`` leaves) as
        uploaded for aggregation (salt 2; ``unit`` is the counter at the
        aggregation)."""
        return self._code(self.model_up, model, CHANNEL_SALTS["model_up"],
                          unit, seeds)

    def code_model_down(self, model, unit=None, *, seeds=None):
        """Code the averaged model (a tree of ``[1, ...]`` leaves) as
        broadcast back to the clients (salt 3)."""
        return self._code(self.model_down, model, CHANNEL_SALTS["model_down"],
                          unit, seeds)

    def _payload_bytes(self, codec: Codec, spec_tree, ints: bool) -> int:
        total = 0
        for leaf in tree_leaves(spec_tree):
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

    def model_up_wire_bytes(self, spec_tree) -> int:
        """Wire bytes of one client's model as uploaded for aggregation."""
        return self._payload_bytes(self.model_up, spec_tree, ints=False)

    def model_down_wire_bytes(self, spec_tree) -> int:
        """Wire bytes of the averaged model as one client receives it."""
        return self._payload_bytes(self.model_down, spec_tree, ints=False)


def make_transport(uplink: Union[str, Codec] = "none",
                   downlink: Union[str, Codec] = "none",
                   model_sync: Union[str, Codec, None] = None,
                   model_up: Union[str, Codec, None] = None,
                   model_down: Union[str, Codec, None] = None,
                   seed: int = 0) -> Transport:
    """``model_sync`` sets both directions of the model-sync wire at once;
    ``model_up`` / ``model_down`` override per direction."""
    base = model_sync if model_sync is not None else "none"
    return Transport(uplink=get_codec(uplink), downlink=get_codec(downlink),
                     model_up=get_codec(model_up if model_up is not None
                                        else base),
                     model_down=get_codec(model_down if model_down is not None
                                          else base),
                     seed=seed)


def resolve_transport(transport, fsl=None) -> Transport:
    """Normalize a Trainer/method ``transport=`` argument: ``None`` reads
    ``fsl.codec`` (uplink) and ``fsl.model_codec`` (model-sync wire), a
    string names the uplink codec (``fsl.model_codec`` still applies), a
    Transport passes through.  The downlink is coded only through an
    explicit Transport."""
    if isinstance(transport, Transport):
        return transport
    ms = getattr(fsl, "model_codec", "none") if fsl is not None else "none"
    if transport is None:
        transport = getattr(fsl, "codec", "none") if fsl is not None \
            else "none"
    return make_transport(transport or "none", model_sync=ms or "none")
