"""Metric registry: Counter / Gauge / Histogram with labels (a copy of
``hetu_tpu/telemetry/metrics.py``: the port keeps its own, as it keeps
every module it needs).

One registry every subsystem writes into and one snapshot the operator
reads out. The exposition formats are the two everything speaks: a
snapshot dict (→ JSONL records) and Prometheus text.

Conventions (Prometheus-style):

- counters only go up (``*_total``, ``*_seconds`` accumulators);
- gauges are last-write-wins instantaneous values;
- histograms keep count/sum/min/max exactly and percentiles from a
  bounded reservoir (tails stay accurate at any run length without
  unbounded host memory).
"""

from __future__ import annotations

import random
import threading
from typing import Optional, Sequence


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile of an ascending sequence;
    ``q`` in [0, 1]. Matches ``numpy.percentile(..., method="linear")``."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _series_name(name: str, key: tuple) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


def _escape_label_value(v: str) -> str:
    """Prometheus text exposition: label values escape backslash, the
    double quote and newline (in that order — backslash first)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_series(name: str, key: tuple) -> str:
    """Exposition-format series: like :func:`_series_name` but with the
    label values escaped (the snapshot keys keep the raw form — they are
    an internal schema, not the scrape surface)."""
    if not key:
        return name
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return f"{name}{{{inner}}}"


def _escape_help(s: str) -> str:
    """# HELP text escapes backslash and newline (not quotes)."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    kind = "metric"

    def __init__(self, registry: "MetricRegistry", name: str,
                 help: str = ""):
        self._reg = registry
        self.name = name
        self.help = help

    def _on(self) -> bool:
        return self._reg.enabled


class Counter(_Metric):
    kind = "counter"

    def __init__(self, registry, name, help=""):
        super().__init__(registry, name, help)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self._on():
            return
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._reg._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def _snapshot(self) -> dict[str, float]:
        return {_series_name(self.name, k): v
                for k, v in self._values.items()}


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, registry, name, help=""):
        super().__init__(registry, name, help)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        if not self._on():
            return
        with self._reg._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def _snapshot(self) -> dict[str, float]:
        return {_series_name(self.name, k): v
                for k, v in self._values.items()}


class _HistSeries:
    __slots__ = ("count", "sum", "min", "max", "sample", "_sorted")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.sample: list[float] = []
        # cached ascending view, invalidated on observe: snapshots are
        # taken every log interval, so idle series must not pay a
        # re-sort of a full 4096-sample reservoir each time
        self._sorted: Optional[list[float]] = None

    def sorted_sample(self) -> list[float]:
        if self._sorted is None:
            self._sorted = sorted(self.sample)
        return self._sorted


class Histogram(_Metric):
    """count/sum/min/max exact; percentiles from a bounded reservoir."""

    kind = "histogram"

    def __init__(self, registry, name, help="", max_samples: int = 4096):
        super().__init__(registry, name, help)
        self.max_samples = max_samples
        self._series: dict[tuple, _HistSeries] = {}

    def observe(self, value: float, **labels) -> None:
        if not self._on():
            return
        value = float(value)
        key = _label_key(labels)
        with self._reg._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries()
            s.count += 1
            s.sum += value
            s.min = min(s.min, value)
            s.max = max(s.max, value)
            s._sorted = None
            if len(s.sample) < self.max_samples:
                s.sample.append(value)
            else:
                # classic reservoir sampling: every observation keeps an
                # equal chance of being represented in the percentile pool
                j = random.randint(0, s.count - 1)
                if j < self.max_samples:
                    s.sample[j] = value

    def percentiles(self, qs: Sequence[float] = (0.5, 0.9, 0.99),
                    **labels) -> dict[float, float]:
        s = self._series.get(_label_key(labels))
        if s is None:
            return {q: 0.0 for q in qs}
        with self._reg._lock:
            vals = s.sorted_sample()
        return {q: percentile(vals, q) for q in qs}

    def summary(self, **labels) -> dict:
        s = self._series.get(_label_key(labels))
        if s is None or s.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0}
        with self._reg._lock:
            vals = s.sorted_sample()
        return {"count": s.count, "sum": s.sum, "min": s.min,
                "max": s.max, "p50": percentile(vals, 0.5),
                "p90": percentile(vals, 0.9),
                "p99": percentile(vals, 0.99)}

    def _snapshot(self) -> dict[str, dict]:
        return {_series_name(self.name, k): self.summary(**dict(k))
                for k in self._series}


class MetricRegistry:
    """Named metrics with get-or-create semantics (Prometheus idiom)."""

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.RLock()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 4096) -> Histogram:
        return self._get(Histogram, name, help, max_samples=max_samples)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- exposition ---------------------------------------------------------
    def snapshot(self) -> dict:
        """``{series_name: float | histogram-summary-dict}`` — the unit
        the JSONL records and the cross-rank aggregator consume."""
        out: dict = {}
        with self._lock:
            for m in self._metrics.values():
                out.update(m._snapshot())
        return out

    def to_record(self) -> dict:
        return {"kind": "metrics_snapshot", "metrics": self.snapshot()}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (histograms as summary quantiles).
        Exposition-format correct: label values are escaped
        (backslash/quote/newline) and ``quantile`` labels are the string
        forms ("0.5", "0.9", "0.99") the format requires."""
        lines: list[str] = []
        with self._lock:
            for m in self._metrics.values():
                if m.help:
                    lines.append(
                        f"# HELP {m.name} {_escape_help(m.help)}")
                lines.append(f"# TYPE {m.name} "
                             f"{'summary' if m.kind == 'histogram' else m.kind}")
                if isinstance(m, Histogram):
                    for key in m._series:
                        base = dict(key)
                        s = m.summary(**base)
                        for q, field in (("0.5", "p50"), ("0.9", "p90"),
                                         ("0.99", "p99")):
                            qkey = _label_key({**base, "quantile": q})
                            lines.append(
                                f"{_prom_series(m.name, qkey)} {s[field]}")
                        lines.append(
                            f"{_prom_series(m.name + '_count', key)} "
                            f"{s['count']}")
                        lines.append(
                            f"{_prom_series(m.name + '_sum', key)} "
                            f"{s['sum']}")
                else:
                    for key, v in m._values.items():
                        lines.append(f"{_prom_series(m.name, key)} {v}")
        return "\n".join(lines) + ("\n" if lines else "")
