"""Unified telemetry: spans, metrics, cross-rank aggregation, goodput
(the port's copy of ``hetu_tpu/telemetry/``, whose modules import no
compute stack: the port keeps its own, as it keeps every module it
needs).

- :mod:`~hetu_tpu_torch.telemetry.spans` — control-plane span tracer
  (step captures, checkpoint writes, prefetch stalls, request tracks),
  exportable as Chrome-trace JSON for Perfetto;
- :mod:`~hetu_tpu_torch.telemetry.metrics` — Counter/Gauge/Histogram
  registry with snapshot-to-dict and Prometheus-text exposition;
- :mod:`~hetu_tpu_torch.telemetry.aggregate` — per-host snapshots fanned
  through the coordinator KV; rank 0 emits cluster min/max/mean;
- :mod:`~hetu_tpu_torch.telemetry.goodput` — goodput / MFU accountant;
- :mod:`~hetu_tpu_torch.telemetry.flight` — the always-on flight
  recorder and the hang watchdog;
- :mod:`~hetu_tpu_torch.telemetry.slo` — the SLO/anomaly engine and the
  health document ``HEALTHZ`` serves;
- :mod:`~hetu_tpu_torch.telemetry.federation` — Prometheus text merge;
- :mod:`~hetu_tpu_torch.telemetry.tracecontext` — the ``traceparent``
  token a request carries across processes.

Process-global default instances live here (the Prometheus
default-registry idiom): instrumented hot paths write through
:func:`get_tracer` / :func:`get_registry` and pay near-zero cost until
:func:`enable` turns collection on. Everything is host-side: no
instrumented call site runs inside a captured CUDA graph or reads the
device. ``docs/OBSERVABILITY.md`` documents what is emitted where; the
series the port emits carry ``hetu_tpu``'s names, labels and help
strings (``python -m hetu_tpu_torch.tools.check_metrics_docs``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from hetu_tpu_torch.telemetry.aggregate import (
    aggregate_snapshots, cluster_aggregate, collect_snapshots,
    publish_snapshot,
)
from hetu_tpu_torch.telemetry.federation import (
    health_rollup, merge_prometheus, parse_prometheus,
)
from hetu_tpu_torch.telemetry.flight import (
    FlightRecorder, HangWatchdog, atomic_write_text, flight_record,
    get_flight_recorder, install_crash_handlers,
)
from hetu_tpu_torch.telemetry.goodput import (
    CATEGORIES, GoodputAccountant, GoodputReport, format_goodput_table,
    model_flops_per_token, report_from_records,
)
from hetu_tpu_torch.telemetry.metrics import (
    Counter, Gauge, Histogram, MetricRegistry, percentile,
)
from hetu_tpu_torch.telemetry.slo import (
    Alert, SLOEngine, default_serving_rules, default_training_rules,
    health_status,
)
from hetu_tpu_torch.telemetry.spans import (
    DEFAULT_COUNTER_TRACK_PREFIXES, NULL_SPAN, SpanEvent, Tracer,
)
from hetu_tpu_torch.telemetry.tracecontext import (
    TRACEPARENT_VERBS, current_traceparent, make_traceparent,
    new_span_id, parse_traceparent, use_trace,
)

_TRACER = Tracer(enabled=False)
_REGISTRY = MetricRegistry(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer (disabled until :func:`enable`)."""
    return _TRACER


def get_registry() -> MetricRegistry:
    """The process-global metric registry (disabled until :func:`enable`)."""
    return _REGISTRY


def enable(on: bool = True) -> None:
    """Master switch for the global tracer + registry. Off by default;
    the disabled fast path is a single attribute check per call site
    (<1% of any real step loop — asserted in
    ``tests/test_torch_telemetry.py``)."""
    _TRACER.enabled = on
    _REGISTRY.enabled = on


def enabled() -> bool:
    return _TRACER.enabled


def reset() -> None:
    """Drop all recorded events and metrics (tests / between runs) —
    including the flight recorder's ring (it stays enabled; it is the
    always-on black box, not part of the opt-in switch)."""
    _TRACER.clear()
    _REGISTRY.clear()
    get_flight_recorder().clear()
    from hetu_tpu_torch.telemetry.flight import _clear_trip_totals
    _clear_trip_totals()


def span(name: str, cat: str = "span", **attrs):
    """``with telemetry.span("compile", plan=...):`` on the global tracer."""
    return _TRACER.span(name, cat=cat, **attrs)


def export_dir(path: str, *, extra_records=(),
               tracer: Optional[Tracer] = None,
               registry: Optional[MetricRegistry] = None) -> dict:
    """Write the standard artifact pair under ``path``:

    - ``trace.json`` — Chrome-trace (open in Perfetto);
    - ``telemetry.jsonl`` — span records + a metrics snapshot +
      ``extra_records`` (e.g. a goodput report), one JSON object/line.

    Both artifacts are written to a temp file and ``os.replace``d into
    place, so a process dying mid-export never leaves a truncated
    ``trace.json``/``telemetry.jsonl`` (the reader sees either the
    previous complete artifact or the new one).

    Returns ``{"trace": ..., "jsonl": ...}`` with the written paths."""
    tracer = tracer if tracer is not None else _TRACER
    registry = registry if registry is not None else _REGISTRY
    os.makedirs(path, exist_ok=True)
    trace_path = os.path.join(path, "trace.json")
    jsonl_path = os.path.join(path, "telemetry.jsonl")
    # final counter-track sample so every exported trace carries at
    # least one point per mem_*/comm_* series (Perfetto counter tracks)
    tracer.record_counters(registry.snapshot())
    tracer.export_chrome(trace_path)          # atomic (temp + replace)
    lines = [json.dumps(rec) for rec in tracer.records()]
    snap_rec = registry.to_record()
    if snap_rec["metrics"]:
        lines.append(json.dumps(snap_rec))
    lines.extend(json.dumps(rec) for rec in extra_records)
    atomic_write_text(jsonl_path, "".join(ln + "\n" for ln in lines))
    return {"trace": trace_path, "jsonl": jsonl_path}


__all__ = [
    "Tracer", "SpanEvent", "NULL_SPAN",
    "DEFAULT_COUNTER_TRACK_PREFIXES",
    "MetricRegistry", "Counter", "Gauge", "Histogram", "percentile",
    "GoodputAccountant", "GoodputReport", "CATEGORIES",
    "model_flops_per_token", "format_goodput_table",
    "report_from_records",
    "publish_snapshot", "collect_snapshots", "aggregate_snapshots",
    "cluster_aggregate",
    "FlightRecorder", "HangWatchdog", "atomic_write_text",
    "flight_record", "get_flight_recorder", "install_crash_handlers",
    "SLOEngine", "Alert", "default_training_rules",
    "default_serving_rules", "health_status",
    "TRACEPARENT_VERBS", "make_traceparent", "parse_traceparent",
    "new_span_id", "current_traceparent", "use_trace",
    "parse_prometheus", "merge_prometheus", "health_rollup",
    "get_tracer", "get_registry", "enable", "enabled", "reset", "span",
    "export_dir",
]
