"""Exporters (``repro.telemetry.export``): JSONL, Prometheus text
exposition, Chrome trace-event JSON.

All three render the recorder's accumulated host-side state after the
run: exporting never touches the engines.

  - :func:`export_jsonl` — one schema-v1 record per line (round records
    in emission order, then summaries), re-validated on the way out so a
    malformed stream can never be written.
  - :func:`prometheus_text` — ``# TYPE`` annotated counter/gauge
    exposition, names sanitized to the Prometheus charset, label sets
    and sample lines deterministically sorted (scrape-at-end-of-run:
    point a file exporter or pushgateway at the text).
  - :func:`chrome_trace` — the ``{"traceEvents": [...]}`` JSON Perfetto
    and ``chrome://tracing`` open directly.  Simulated spans (async
    engine) land in a ``pid=1`` "simulated timeline" process with one
    thread per track (``client/0``, ``server``, ...); real host spans
    (compiled chunk build/execute) land in ``pid=2`` "host", timestamps
    re-based to the first host span.  Durations are microseconds, as
    the trace-event format requires.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def export_jsonl(tele, path: str):
    """Write one validated v1 record per line."""
    from repro_torch.telemetry.record import validate_record
    with open(path, "w") as f:
        for rec in tele.records:
            f.write(json.dumps(validate_record(rec), sort_keys=True) + "\n")


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def _prom_labels(labels) -> str:
    if not labels:
        return ""
    body = ",".join(f'{_prom_name(k)}="{v}"' for k, v in labels)
    return "{" + body + "}"


def prometheus_text(tele, namespace: str = "repro") -> str:
    """Deterministic text exposition of all counters and gauges."""
    lines: List[str] = []
    for kind, table in (("counter", tele.counters), ("gauge", tele.gauges)):
        by_name: Dict[str, List[str]] = {}
        for (name, labels), value in table.items():
            pname = f"{namespace}_{_prom_name(name)}"
            v = f"{value:.10g}" if isinstance(value, float) else str(value)
            by_name.setdefault(pname, []).append(
                f"{pname}{_prom_labels(labels)} {v}")
        for pname in sorted(by_name):
            lines.append(f"# TYPE {pname} {kind}")
            lines.extend(sorted(by_name[pname]))
    return "\n".join(lines) + ("\n" if lines else "")


def export_prometheus(tele, path: str):
    with open(path, "w") as f:
        f.write(prometheus_text(tele))


# ---------------------------------------------------------------------------
# Chrome trace-event JSON (Perfetto)
# ---------------------------------------------------------------------------

_SIM_PID = 1
_HOST_PID = 2


def chrome_trace(tele) -> Dict[str, Any]:
    """Render spans as complete ("X") trace events plus thread/process
    name metadata.  Open the exported file directly in Perfetto
    (https://ui.perfetto.dev) or chrome://tracing."""
    sim = [s for s in tele.spans if s.cat == "sim"]
    host = [s for s in tele.spans if s.cat == "host"]
    events: List[Dict[str, Any]] = []

    def add_process(pid: int, name: str, spans) -> Dict[str, int]:
        tracks = sorted({s.track for s in spans},
                        key=lambda t: (t.split("/")[0], t))
        tids = {t: i + 1 for i, t in enumerate(tracks)}
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": name}})
        for t, tid in tids.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": t}})
        return tids

    if sim:
        tids = add_process(_SIM_PID, "simulated timeline", sim)
        for s in sim:
            events.append({
                "ph": "X", "pid": _SIM_PID, "tid": tids[s.track],
                "name": s.name, "cat": "sim",
                "ts": s.start * 1e6, "dur": s.dur * 1e6,
                "args": {k: v for k, v in s.labels.items()}})
    if host:
        t0 = min(s.start for s in host)
        tids = add_process(_HOST_PID, "host", host)
        for s in host:
            events.append({
                "ph": "X", "pid": _HOST_PID, "tid": tids[s.track],
                "name": s.name, "cat": "host",
                "ts": (s.start - t0) * 1e6, "dur": s.dur * 1e6,
                "args": {k: v for k, v in s.labels.items()}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_trace(tele, path: str):
    with open(path, "w") as f:
        json.dump(chrome_trace(tele), f)
