"""Telemetry: the metric registry and the cross-process trace context
(counterpart of ``hetu_tpu/telemetry/``, cut to what the serving front
end counts with).

- :mod:`~hetu_tpu_torch.telemetry.metrics` — Counter/Gauge/Histogram
  registry with snapshot-to-dict and Prometheus-text exposition;
- :mod:`~hetu_tpu_torch.telemetry.tracecontext` — the ``traceparent``
  token a request carries across processes.

The process-global registry lives here (the Prometheus default-registry
idiom): instrumented paths write through :func:`get_registry` and pay
near-zero cost until :func:`enable` turns collection on. Off by default,
as in ``hetu_tpu``.
"""

from __future__ import annotations

from hetu_tpu_torch.telemetry.metrics import (
    Counter, Gauge, Histogram, MetricRegistry, percentile,
)
from hetu_tpu_torch.telemetry.tracecontext import (
    TRACEPARENT_VERBS, current_traceparent, make_traceparent,
    new_span_id, parse_traceparent, use_trace,
)

_REGISTRY = MetricRegistry(enabled=False)


def get_registry() -> MetricRegistry:
    """The process-global metric registry (disabled until :func:`enable`)."""
    return _REGISTRY


def enable(on: bool = True) -> None:
    """Master switch for the global registry. Off by default; the
    disabled fast path is a single attribute check per call site."""
    _REGISTRY.enabled = on


def enabled() -> bool:
    return _REGISTRY.enabled


def reset() -> None:
    """Drop all recorded metrics (tests / between runs)."""
    _REGISTRY.clear()


__all__ = [
    "MetricRegistry", "Counter", "Gauge", "Histogram", "percentile",
    "TRACEPARENT_VERBS", "make_traceparent", "parse_traceparent",
    "new_span_id", "current_traceparent", "use_trace",
    "get_registry", "enable", "enabled", "reset",
]
