"""Communication & storage accounting (paper Table II), as in
``repro.core.accounting``: the cost model the CommProfile is computed
from, and the incremental meter the trainer drives.

Notation (paper Table I): n clients, q bytes of smashed data per sample,
|D| samples per client per epoch, |w| client-side model bytes, |a|
auxiliary net bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class CostModel:
    n: int                  # clients
    q: int                  # smashed bytes per sample
    d_local: int            # |D_i|: samples per client per epoch
    w_client: int           # client-side model bytes (alpha * |w|)
    w_server: int           # server-side model bytes
    aux: int                # auxiliary net bytes
    label_bytes: int = 4


def flat_record(d: Dict, prefix: str = "") -> Dict:
    """Flatten a (possibly nested) summary dict into dotted keys, sorted at
    every nesting level."""
    out: Dict = {}
    for k in sorted(d, key=str):
        v = d[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_record(v, f"{key}."))
        else:
            out[key] = v
    return out


class Recordable:
    """Mixin giving any stats object with ``as_dict`` a flat-record export."""

    def as_dict(self) -> Dict:  # pragma: no cover - subclasses override
        raise NotImplementedError

    def to_record(self, prefix: str = "") -> Dict:
        return flat_record(self.as_dict(), prefix)


class CommMeter(Recordable):
    """Incremental byte counters driven by the trainer loop."""

    def __init__(self):
        self.counts: Dict[str, int] = {
            "uplink_smashed": 0, "uplink_labels": 0, "downlink_grads": 0,
            "model_sync": 0}

    def log(self, kind: str, nbytes: int):
        self.counts[kind] = self.counts.get(kind, 0) + int(nbytes)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def as_dict(self) -> Dict[str, int]:
        return {**self.counts, "total": self.total}
