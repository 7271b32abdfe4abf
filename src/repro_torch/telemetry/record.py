"""The telemetry round-record schema, version 1 (``repro.telemetry.record``:
the same records as the JAX package's).

Every engine — the Python loop, the compiled chunk runner, the async
event engine, and the population cohort engine — folds its per-round
bookkeeping into ONE record shape, and its end-of-run summaries
(`CommMeter`, `AsyncStats`, `FaultStats`, participation, population)
into one flattened summary record.  The JSONL exporter writes one record
per line; `validate_record` is the schema gate CI runs on the exported
stream.

Record shapes::

  {"v": 1, "type": "round", "engine": "loop|compiled|async|population",
   "round": <1-based absolute round>, "aggregated": bool,
   "metrics": {name: float, ...},              # the history-row metrics
   "comm_bytes": int,                          # cumulative, if metered
   "sim_time": float,                          # async engine only
   "extra": {...}}                             # engine-specific additions

  {"v": 1, "type": "summary", "engine": ...,
   "summary": {"comm.total": ..., "stats.async_time": ..., ...}}

The summary keys are the deterministic flat records of
:func:`repro_torch.core.accounting.flat_record` — section-prefixed, sorted.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

SCHEMA_VERSION = 1
ENGINES = ("loop", "compiled", "async", "population")
RECORD_TYPES = ("round", "summary")


def make_round_record(engine: str, rnd: int, metrics: Mapping[str, Any],
                      aggregated: bool,
                      comm_bytes: Optional[int] = None,
                      sim_time: Optional[float] = None,
                      extra: Optional[Mapping[str, Any]] = None,
                      ) -> Dict[str, Any]:
    """One engine round as a schema-v1 record (1-based absolute round)."""
    rec: Dict[str, Any] = {
        "v": SCHEMA_VERSION, "type": "round", "engine": str(engine),
        "round": int(rnd), "aggregated": bool(aggregated),
        "metrics": {str(k): float(v) for k, v in dict(metrics).items()},
    }
    if comm_bytes is not None:
        rec["comm_bytes"] = int(comm_bytes)
    if sim_time is not None:
        rec["sim_time"] = float(sim_time)
    if extra:
        rec["extra"] = dict(extra)
    return rec


def make_summary_record(engine: str,
                        summary: Mapping[str, Any]) -> Dict[str, Any]:
    """End-of-run fold of the engine's meters/stats into one flat record."""
    return {"v": SCHEMA_VERSION, "type": "summary", "engine": str(engine),
            "summary": dict(summary)}


def validate_record(rec: Any) -> Dict[str, Any]:
    """Raise ``ValueError`` unless ``rec`` is a well-formed v1 record.

    This is the CI schema gate for exported JSONL streams — strict about
    the envelope (version, type, engine, required fields and their
    types), permissive about engine-specific ``extra`` payloads.
    """
    if not isinstance(rec, dict):
        raise ValueError(f"record must be a dict, got {type(rec).__name__}")
    if rec.get("v") != SCHEMA_VERSION:
        raise ValueError(f"unknown schema version {rec.get('v')!r}")
    kind = rec.get("type")
    if kind not in RECORD_TYPES:
        raise ValueError(f"unknown record type {kind!r}")
    if rec.get("engine") not in ENGINES:
        raise ValueError(f"unknown engine {rec.get('engine')!r}")
    if kind == "round":
        if not isinstance(rec.get("round"), int) or rec["round"] < 1:
            raise ValueError(f"bad round index {rec.get('round')!r}")
        if not isinstance(rec.get("aggregated"), bool):
            raise ValueError("round record missing bool 'aggregated'")
        m = rec.get("metrics")
        if not isinstance(m, dict):
            raise ValueError("round record missing 'metrics' dict")
        for k, v in m.items():
            if not isinstance(k, str) or not isinstance(v, (int, float)):
                raise ValueError(f"bad metric entry {k!r}: {v!r}")
        if "comm_bytes" in rec and not isinstance(rec["comm_bytes"], int):
            raise ValueError("comm_bytes must be an int")
        if "sim_time" in rec and not isinstance(rec["sim_time"],
                                                (int, float)):
            raise ValueError("sim_time must be a number")
    else:
        if not isinstance(rec.get("summary"), dict):
            raise ValueError("summary record missing 'summary' dict")
    return rec
