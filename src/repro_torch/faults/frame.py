"""Checksum framing for transport payloads: detect corruption, retransmit
(``repro.faults.frame``).

Every wire payload is a tree of coded tensors produced by a
:class:`repro_torch.transport.Codec`.  The frame adds an 8-byte trailer --
a checksum over the raw bits of every leaf -- that lets the receiver
*detect* a corrupted or truncated payload and request retransmission
instead of training on garbage.  The checksum is the bit-sum mod 2**32 and
the bit-xor of every leaf's uint32 words; both are the same for every
order of the leaves, so it equals the JAX package's on the same values
(whose leaves come in sorted-key order, the port's in insertion order).

The simulated corruption is deterministic: :func:`corrupt_frame` flips one
bit chosen from a seed of the :func:`repro_torch.faults.model.retry_key`
stream, which is disjoint from every codec seed, so injecting faults never
perturbs a quantizing codec's stochastic rounding.  (The JAX package draws
the leaf and the bit with ``jax.random``; the port draws them from its own
stream: what must hold in both is that the frame catches every flip.)

:class:`FramedCodec` wraps any codec with the frame, so a meter sees the
framed wire sizes; the trainers bill ``FRAME_BYTES`` per transmission
*attempt* -- a retransmitted payload pays the frame again.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np
import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.transport import Codec

# Trailer size billed per transmission attempt: two uint32 words
# (bit-sum and bit-xor of the payload words).
FRAME_BYTES = 8


def _raw(leaf) -> np.ndarray:
    """The stored bytes of one leaf (a tensor on any device, or an array),
    as uint8; bool leaves as one 0/1 byte an element."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        return t.reshape(-1).view(torch.uint8).numpy()
    arr = np.ascontiguousarray(leaf)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    return np.frombuffer(arr.tobytes(), np.uint8)


def _payload_words(tree) -> list:
    """Every leaf of the coded payload as uint32 words, zero-padded."""
    words = []
    for leaf in tree_leaves(tree):
        raw = _raw(leaf)
        pad = (-raw.size) % 4
        if pad:
            raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
        words.append(raw.view(np.uint32))
    return words


def frame_checksum(tree) -> Tuple[int, int]:
    """(bit-sum mod 2**32, bit-xor) over every word of every leaf."""
    total, xor = 0, 0
    for words in _payload_words(tree):
        total = (total + int(words.sum(dtype=np.uint64))) & 0xFFFFFFFF
        xor ^= int(np.bitwise_xor.reduce(words, initial=np.uint32(0)))
    return total, xor


def make_frame(tree) -> Tuple[int, int]:
    """The trailer the sender attaches: the payload checksum."""
    return frame_checksum(tree)


def check_frame(tree, frame: Tuple[int, int]) -> bool:
    """Receiver-side verification: True iff the payload is intact."""
    return frame_checksum(tree) == (int(frame[0]), int(frame[1]))


def corrupt_payload(tree, key: int):
    """Deterministically corrupt one leaf of a coded payload (simulated
    wire damage): flips one stored bit of one non-empty leaf, both drawn
    from ``key`` (a :func:`~repro_torch.faults.model.retry_key` seed).
    Bit-level on the raw bytes, so it works for every wire dtype (int8
    quants, bf16, bool masks, fp32), and a single flip always shows in the
    checksum's xor word.  On a bool leaf only the low bit of a byte flips
    (any other bit would read back as the same True).  Returns a new tree
    on the leaves' devices; the original is untouched."""
    leaves = tree_leaves(tree)
    nonempty = [i for i, leaf in enumerate(leaves) if _raw(leaf).size]
    if not nonempty:
        return tree
    rng = np.random.default_rng(int(key) & ((1 << 64) - 1))
    tgt = nonempty[int(rng.integers(len(nonempty)))]
    leaf = leaves[tgt]
    raw = _raw(leaf).copy()
    pos = int(rng.integers(raw.size * 8))
    is_bool = (leaf.dtype == torch.bool if torch.is_tensor(leaf)
               else np.asarray(leaf).dtype == np.bool_)
    if is_bool:
        pos -= pos % 8
    raw[pos // 8] ^= np.uint8(1 << (pos % 8))
    if torch.is_tensor(leaf):
        dtype = torch.uint8 if is_bool else leaf.dtype
        bad = torch.from_numpy(raw).view(dtype).reshape(leaf.shape)
        bad = (bad.bool() if is_bool else bad).to(leaf.device)
    else:
        arr = np.asarray(leaf)
        bad = np.frombuffer(raw.tobytes(), np.uint8 if is_bool
                            else arr.dtype).reshape(arr.shape)
        bad = bad.astype(np.bool_) if is_bool else bad
    count = itertools.count()
    return tree_map(lambda x: bad if next(count) == tgt else x, tree)


def corrupt_frame(tree, frame: Tuple[int, int], key: int):
    """The full simulated-loss event: damage the payload under ``key`` and
    hand back ``(corrupted_tree, frame)`` for the receiver to check.
    ``check_frame`` must return False on the result whenever the payload
    has at least one element (held in the tests and, with
    ``FaultModel.verify_frames``, live in the event engine)."""
    return corrupt_payload(tree, key), frame


@dataclasses.dataclass(frozen=True)
class FramedCodec(Codec):
    """A codec wrapped in the checksum frame: the inner codec's math,
    ``FRAME_BYTES`` heavier on the wire."""

    inner: Codec = None  # type: ignore[assignment]

    @property
    def name(self):
        return f"framed({self.inner.name})"

    @property
    def is_identity(self):
        # framing adds bytes, never changes values: the "skip coding"
        # fast path follows the inner codec
        return self.inner.is_identity

    @property
    def stochastic(self):
        return self.inner.stochastic

    def encode(self, payload, *, seeds=None, bits=None):
        return self.inner.encode(payload, seeds=seeds, bits=bits)

    def decode(self, wire, spec):
        return self.inner.decode(wire, spec)

    def roundtrip(self, payload, *, seeds=None, bits=None):
        return self.inner.roundtrip(payload, seeds=seeds, bits=bits)

    def wire_bytes(self, spec) -> int:
        return int(self.inner.wire_bytes(spec)) + FRAME_BYTES
