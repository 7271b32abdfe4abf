"""Communication & storage accounting (paper Table II), as in
``repro.core.accounting``: the cost model, the analytic per-epoch and
storage figures derived from each method's CommProfile, and the
incremental meter the trainer drives.

Notation (paper Table I): n clients, q bytes of smashed data per sample,
|D| samples per client per epoch, |w| client-side model bytes, |a|
auxiliary net bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class CostModel:
    n: int                  # clients
    q: int                  # smashed bytes per sample
    d_local: int            # |D_i|: samples per client per epoch
    w_client: int           # client-side model bytes (alpha * |w|)
    w_server: int           # server-side model bytes
    aux: int                # auxiliary net bytes
    label_bytes: int = 4


def _profile(cm: CostModel, method: str, h: int = 1, batch_size: int = 1,
             n: Optional[int] = None):
    """The method's declarative CommProfile at this cost model, the one
    source every analytic helper below derives from."""
    from repro_torch.configs.base import FSLConfig
    from repro_torch.core.methods import get_method
    n = cm.n if n is None else n
    cm = dataclasses.replace(cm, n=n)
    fsl = FSLConfig(num_clients=n, h=h, method=method)
    try:
        m = get_method(method)
    except KeyError:
        raise ValueError(method) from None
    return m.comm_profile(cm, fsl, batch_size)


def comm_one_epoch(cm: CostModel, method: str, h: int = 1) -> Dict[str, int]:
    """Bytes communicated in one global epoch (Table II columns 1-3): one
    epoch is ``d_local / h`` rounds of the per-round CommProfile at B = 1
    (floor division, Table II's ``q|D|/h`` row for CSE-FSL)."""
    p = _profile(cm, method, h=h, batch_size=1)
    out = {k: (v * cm.d_local) // h
           for k, v in (("uplink_smashed", p.uplink_smashed),
                        ("uplink_labels", p.uplink_labels),
                        ("downlink_grads", p.downlink_grads))}
    out["model_sync"] = p.model_sync
    out["total"] = sum(out.values())
    return out


def server_storage(cm: CostModel, method: str) -> int:
    """Server-side persistent model storage (Table II last column)."""
    return _profile(cm, method).server_storage


def total_storage(cm: CostModel, method: str) -> int:
    """Aggregation-time storage (paper §VI-E): server models + n client
    models (+ aux nets where applicable)."""
    return _profile(cm, method).total_storage


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


def meter_round(meter: CommMeter, cm: CostModel, method: str, h: int,
                batch_size: int, smashed_bytes_per_sample: Optional[int] = None):
    """Account ONE client's round (h batches) of traffic: the per-client
    slice (n = 1) of the method's CommProfile."""
    q = smashed_bytes_per_sample or cm.q
    p = _profile(dataclasses.replace(cm, q=q), method, h=h,
                 batch_size=batch_size, n=1)
    meter.log("uplink_smashed", p.uplink_smashed)
    meter.log("uplink_labels", p.uplink_labels)
    if p.downlink_grads:
        meter.log("downlink_grads", p.downlink_grads)


def meter_aggregation(meter: CommMeter, cm: CostModel, method: str):
    """Account one aggregation event (all n clients' model sync)."""
    meter.log("model_sync", _profile(cm, method).model_sync)
