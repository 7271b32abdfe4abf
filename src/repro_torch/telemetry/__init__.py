"""Unified observability (``repro.telemetry``): one recorder, one record
schema, three exporters.

All four engines (`Trainer.run`, `Trainer.run_compiled`, `AsyncTrainer`
and `Population`) emit into one host-side `Telemetry` recorder: per-round
records (schema v1, folding the history-row metrics, metered bytes and
engine extras), labelled counters/gauges, and timeline spans (the event
engine's *simulated* per-client compute / wire / retry / outage
intervals, plus real host-side chunk build/execute phases on the
compiled path and in the population engine).  Export as JSONL,
Prometheus text, or Chrome trace-event JSON openable in Perfetto.

Telemetry only observes: `NullTelemetry` is a no-op, an enabled recorder
reads what the engines already fetched after a step or a chunk (nothing
inside a captured round), and every engine's params, history and meter
are bitwise the same with telemetry on and off.

Quick start::

    from repro_torch.telemetry import Telemetry
    tele = Telemetry()
    trainer = Trainer(bundle, fsl, telemetry=tele)
    state, history = trainer.run_compiled(state, batcher, rounds)
    tele.export_jsonl("run.jsonl")       # one record per round + summary
    tele.export_trace("run.trace.json")  # open in https://ui.perfetto.dev
    print(tele.prometheus_text())
"""
from repro_torch.telemetry.export import (chrome_trace, export_jsonl,
                                    export_prometheus, export_trace,
                                    prometheus_text)
from repro_torch.telemetry.record import (ENGINES, SCHEMA_VERSION,
                                    make_round_record, make_summary_record,
                                    validate_record)
from repro_torch.telemetry.recorder import (NULL_TELEMETRY, NullTelemetry, Span,
                                      Telemetry, resolve_telemetry)

__all__ = [
    "ENGINES", "NULL_TELEMETRY", "NullTelemetry", "SCHEMA_VERSION", "Span",
    "Telemetry", "chrome_trace", "export_jsonl", "export_prometheus",
    "export_trace", "make_round_record", "make_summary_record",
    "prometheus_text", "resolve_telemetry", "validate_record",
]
