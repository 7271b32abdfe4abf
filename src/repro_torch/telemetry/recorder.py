"""The host-side telemetry recorder (``repro.telemetry.recorder``):
counters, gauges, spans, records.

One `Telemetry` instance observes a whole run: engines append round
records (the v1 schema in :mod:`repro_torch.telemetry.record`), bump
labelled counters/gauges, and emit *spans*: either **sim** spans placed
on the event engine's simulated clock (per-client compute, per-attempt
wire transfers, retry backoffs, server service, outages, model-sync
barriers), or **host** spans measured with ``time.perf_counter`` (the
compiled path's chunk build and execute phases).  Exporters render the
accumulated state as JSONL, Prometheus text exposition, or Chrome
trace-event JSON (:mod:`repro_torch.telemetry.export`).

The contract (``tests/test_torch_telemetry.py``, ``chip_smoke.py`` phase
25): telemetry only observes.  A disabled recorder is the `NullTelemetry`
singleton whose every method is a pass; engines guard their emission
sites with ``if telemetry.enabled:`` so the off path costs one attribute
read.  An enabled recorder runs only on the host, on values the engines
have already fetched (a chunk's metrics come back in one fetch after its
replays): it never synchronizes the card inside a captured round, never
touches a tensor of the state, and never changes a captured program.
Params, history and meter are bitwise the same with telemetry on and off
in all four engines.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.accounting import flat_record
from repro_torch.telemetry.record import (make_round_record, make_summary_record,
                                    validate_record)

LabelKey = Tuple[str, Tuple[Tuple[str, Any], ...]]


def _key(name: str, labels: Mapping[str, Any]) -> LabelKey:
    return (name, tuple(sorted(labels.items())))


class Span:
    """One named interval on a named track.

    ``cat`` is ``"sim"`` (start/dur in *simulated* seconds on the async
    engine's clock) or ``"host"`` (``perf_counter`` seconds).  ``track``
    names the timeline row — ``client/3``, ``server``, ``host`` — which
    the Chrome exporter maps to a thread."""

    __slots__ = ("name", "start", "dur", "track", "cat", "labels")

    def __init__(self, name: str, start: float, dur: float, track: str,
                 cat: str, labels: Dict[str, Any]):
        self.name = name
        self.start = float(start)
        self.dur = float(dur)
        self.track = track
        self.cat = cat
        self.labels = labels

    def __repr__(self):
        return (f"<Span {self.name} @{self.start:.6f}+{self.dur:.6f}"
                f" {self.track} {self.labels}>")


class _HostTimer:
    """Context manager backing :meth:`Telemetry.timed`."""

    __slots__ = ("_tele", "_name", "_track", "_labels", "_t0")

    def __init__(self, tele: "Telemetry", name: str, track: str,
                 labels: Dict[str, Any]):
        self._tele = tele
        self._name = name
        self._track = track
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def label(self, **labels):
        """Add labels known only inside the span (``capture=``)."""
        self._labels.update(labels)

    def __exit__(self, *exc):
        self._tele.host_span(self._name, self._t0,
                             time.perf_counter() - self._t0,
                             track=self._track, **self._labels)
        return False


class Telemetry:
    """The enabled recorder.  All state lives in plain host containers;
    every method is cheap dict/list work on already-fetched values."""

    enabled: bool = True

    def __init__(self):
        self.counters: Dict[LabelKey, float] = {}
        self.gauges: Dict[LabelKey, float] = {}
        self.spans: List[Span] = []
        self.records: List[Dict[str, Any]] = []

    # -- scalars -------------------------------------------------------------
    def counter(self, name: str, value: float = 1, **labels):
        """Add ``value`` to the labelled monotonic counter ``name``."""
        k = _key(name, labels)
        self.counters[k] = self.counters.get(k, 0) + value

    def gauge(self, name: str, value: float, **labels):
        """Set the labelled gauge ``name`` to its latest ``value``."""
        self.gauges[_key(name, labels)] = value

    # -- spans ---------------------------------------------------------------
    def sim_span(self, name: str, start: float, dur: float, track: str,
                 **labels):
        """An interval on the async engine's *simulated* clock."""
        self.spans.append(Span(name, start, dur, track, "sim", labels))

    def host_span(self, name: str, start: float, dur: float,
                  track: str = "host", **labels):
        """An interval measured in real ``perf_counter`` seconds."""
        self.spans.append(Span(name, start, dur, track, "host", labels))

    def timed(self, name: str, track: str = "host", **labels):
        """``with tele.timed("chunk/build") as span:`` — a real host-side
        span; ``span.label(...)`` adds labels before it closes."""
        return _HostTimer(self, name, track, labels)

    # -- records -------------------------------------------------------------
    def round_record(self, engine: str, rnd: int, metrics: Mapping[str, Any],
                     aggregated: bool, comm_bytes: Optional[int] = None,
                     sim_time: Optional[float] = None,
                     extra: Optional[Mapping[str, Any]] = None):
        """Fold one engine round into the stream (validated at emit)."""
        rec = make_round_record(engine, rnd, metrics, aggregated,
                                comm_bytes=comm_bytes, sim_time=sim_time,
                                extra=extra)
        self.records.append(validate_record(rec))
        self.counter("rounds_total", 1, engine=engine)
        if aggregated:
            self.counter("aggregations_total", 1, engine=engine)

    def run_summary(self, engine: str, **sections):
        """Fold end-of-run summaries into ONE flat summary record.

        Each keyword names a section (``comm=meter``,
        ``stats=trainer.stats``, ``faults=...``, ``participation=...``,
        ``population=...``); values may be plain dicts or any object
        with ``as_dict()`` (``None`` sections are skipped).  Keys are
        flattened ``section.sub.key`` in deterministic sorted order
        (:func:`repro_torch.core.accounting.flat_record`); numeric leaves also
        land as gauges for the Prometheus exporter."""
        summary: Dict[str, Any] = {}
        for section, value in sorted(sections.items()):
            if value is None:
                continue
            if hasattr(value, "as_dict"):
                value = value.as_dict()
            summary.update(flat_record(value, f"{section}."))
        rec = make_summary_record(engine, summary)
        self.records.append(validate_record(rec))
        for k, v in summary.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.gauge(k, float(v), engine=engine)

    # -- exports (thin wrappers over repro_torch.telemetry.export) -----------
    def export_jsonl(self, path: str):
        from repro_torch.telemetry.export import export_jsonl
        export_jsonl(self, path)

    def prometheus_text(self) -> str:
        from repro_torch.telemetry.export import prometheus_text
        return prometheus_text(self)

    def export_prometheus(self, path: str):
        from repro_torch.telemetry.export import export_prometheus
        export_prometheus(self, path)

    def chrome_trace(self) -> Dict[str, Any]:
        from repro_torch.telemetry.export import chrome_trace
        return chrome_trace(self)

    def export_trace(self, path: str):
        from repro_torch.telemetry.export import export_trace
        export_trace(self, path)


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def label(self, **labels):
        pass

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class NullTelemetry(Telemetry):
    """The disabled recorder: every method is a no-op, ``enabled`` is
    False so engines skip even argument construction on hot paths.  A
    single module-level instance (`NULL_TELEMETRY`) is shared by every
    trainer that didn't ask for telemetry."""

    enabled = False

    def counter(self, name, value=1, **labels):
        pass

    def gauge(self, name, value, **labels):
        pass

    def sim_span(self, name, start, dur, track, **labels):
        pass

    def host_span(self, name, start, dur, track="host", **labels):
        pass

    def timed(self, name, track="host", **labels):
        return _NULL_TIMER

    def round_record(self, *a, **k):
        pass

    def run_summary(self, engine, **sections):
        pass


NULL_TELEMETRY = NullTelemetry()


def resolve_telemetry(t: Optional[Telemetry]) -> Telemetry:
    """``None`` -> the shared `NullTelemetry`; recorders pass through."""
    if t is None:
        return NULL_TELEMETRY
    if isinstance(t, Telemetry):
        return t
    raise TypeError(f"telemetry must be a Telemetry or None, got {t!r}")
