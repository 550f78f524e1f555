"""Span tracer: nested timed events, Chrome-trace/Perfetto export (a
copy of ``hetu_tpu/telemetry/spans.py``: the port keeps its own).

The reference ships an op/graph profiler (``impl/profiler/profiler.h:25``,
``graph/profiler.h:40``) that times named regions on the device streams.
The device's op layer belongs to the kernels' own profiler; what the
framework itself must trace is the *control plane* — plan compiles, hot
switches, checkpoint writes, prefetch stalls — which is exactly what this
tracer records. Traces export as Chrome-trace JSON (``traceEvents``) so
they open in Perfetto / ``chrome://tracing`` next to the device
profiler's traces.

Design constraints:

- near-zero cost when disabled: ``span()`` on a disabled tracer returns a
  shared no-op context manager (no allocation, no clock read);
- thread-safe: spans nest per-thread (checkpoint writer threads and the
  data prefetcher record concurrently with the train loop);
- bounded: at most ``max_events`` are kept; later events are counted as
  dropped rather than growing host memory on 1M-step runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Iterator, Optional


@dataclasses.dataclass
class SpanEvent:
    """One completed span. ``ts_s`` is seconds since the tracer epoch."""

    name: str
    ts_s: float
    dur_s: float
    tid: int
    depth: int
    cat: str = "span"
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_record(self) -> dict:
        """JSONL form (``kind: span`` in the unified telemetry stream)."""
        return {"kind": "span", "name": self.name, "cat": self.cat,
                "ts_s": round(self.ts_s, 6), "dur_s": round(self.dur_s, 6),
                "tid": self.tid, "depth": self.depth, "attrs": self.attrs}


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()

#: registry series sampled into Perfetto counter tracks by default: the
#: memory-plane gauges, the data-plane byte/sync counters and the
#: control-plane cache counters — the series an operator scrubs against
#: the span timeline (everything else stays snapshot-only to keep traces
#: small).
DEFAULT_COUNTER_TRACK_PREFIXES = (
    "mem_", "comm_", "dp_grad_syncs_total", "optimizer_updates_total",
    "step_cache_", "tp_ring_fallback_total", "data_stall_seconds",
    "serving_", "slo_", "watchdog_",
)


class _Span:
    """Live span handle; records a SpanEvent on exit."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def set(self, **attrs):
        """Attach attributes mid-span (e.g. bytes moved, once known)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._record(SpanEvent(
            self.name, self._t0 - self._tracer.epoch, t1 - self._t0,
            threading.get_ident(), self._depth, self.cat, self.attrs))
        return False


#: per-request Perfetto tracks: synthetic tids offset far above real
#: thread ids so request timelines never collide with thread tracks.
#: Shared by serving.engine (replica-side phases) and serving.router
#: (dispatch / KV-handoff fragments) so tools/fleet_trace.py can merge
#: every process's ``req <trace_id>`` track into one fleet timeline.
REQ_TRACK_BASE = 1 << 40


def request_track_tid(trace_id: str) -> int:
    """The Perfetto track of one request: ``REQ_TRACK_BASE`` plus its
    12-hex-digit trace id (a CRC of a foreign id). ``hetu_tpu`` offsets
    by the request's id instead; keyed by the trace id, the router's
    fragments and each in-process replica's phases of one request share
    one track, where several engines' request ids would collide."""
    try:
        return REQ_TRACK_BASE + int(trace_id[:12], 16)
    except ValueError:
        import zlib
        return REQ_TRACK_BASE + zlib.crc32(trace_id.encode())


class Tracer:
    """Collects nested SpanEvents; exports Chrome trace / JSONL records."""

    def __init__(self, *, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        self.dropped = 0
        self._events: list[SpanEvent] = []
        self._counters: list[tuple] = []   # (name, ts_s, value) samples
        self._track_names: dict[int, str] = {}   # synthetic-track labels
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- recording ----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, cat: str = "span", **attrs):
        """``with tracer.span("compile", plan=...):`` — times the block."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, attrs)

    def complete(self, name: str, dur_s: float, *, cat: str = "span",
                 ts_s: Optional[float] = None, tid: Optional[int] = None,
                 **attrs) -> None:
        """Record an already-measured duration (caller held the clock).
        ``tid`` overrides the thread id — synthetic track ids let logical
        timelines (e.g. one serving request) render as their own
        Perfetto track; pair with :meth:`name_track`."""
        if not self.enabled:
            return
        now = time.perf_counter() - self.epoch
        ts = max(0.0, now - dur_s) if ts_s is None else ts_s
        self._record(SpanEvent(
            name, ts, dur_s,
            threading.get_ident() if tid is None else int(tid),
            len(self._stack()), cat, attrs))

    def name_track(self, tid: int, name: str) -> None:
        """Label a (synthetic) track id — becomes the Perfetto
        ``thread_name`` metadata row for that tid."""
        if not self.enabled:
            return
        with self._lock:
            self._track_names[int(tid)] = name

    def instant(self, name: str, cat: str = "event", **attrs) -> None:
        """Zero-duration marker event."""
        self.complete(name, 0.0, cat=cat, **attrs)

    def counter(self, name: str, value: float,
                ts_s: Optional[float] = None) -> None:
        """One sample of a counter track (Perfetto ``ph: "C"``): the
        time series a metric-registry gauge/counter traces out. Bounded
        by ``max_events`` like spans (over-limit samples count as
        dropped)."""
        if not self.enabled:
            return
        ts = time.perf_counter() - self.epoch if ts_s is None else ts_s
        with self._lock:
            if len(self._counters) >= self.max_events:
                self.dropped += 1
                return
            self._counters.append((name, ts, float(value)))

    def record_counters(self, snapshot: dict, *,
                        prefixes=DEFAULT_COUNTER_TRACK_PREFIXES,
                        ts_s: Optional[float] = None) -> int:
        """Sample every numeric series of a registry snapshot whose base
        name matches ``prefixes`` (None = all numeric series) into
        counter tracks; returns how many samples were taken. Called on
        the Trainer's log cadence so the memory-ledger gauges and the
        data-plane byte counters render as scrubbed tracks next to the
        span timeline."""
        if not self.enabled:
            return 0
        n = 0
        for series, v in snapshot.items():
            if not isinstance(v, (int, float)):
                continue          # histogram summaries stay snapshot-only
            if prefixes is not None:
                base = series.split("{")[0]
                if not any(base.startswith(p) for p in prefixes):
                    continue
            self.counter(series, v, ts_s=ts_s)
            n += 1
        return n

    def counter_samples(self) -> list[tuple]:
        with self._lock:
            return list(self._counters)

    def _record(self, ev: SpanEvent) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # -- inspection / export ------------------------------------------------
    def events(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self._track_names.clear()
            self.dropped = 0
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()

    def records(self) -> Iterator[dict]:
        for ev in self.events():
            yield ev.to_record()

    def to_chrome(self) -> dict[str, Any]:
        """Chrome-trace JSON object (the ``traceEvents`` schema Perfetto
        and ``chrome://tracing`` load). Spans become ``ph: "X"`` complete
        events with microsecond ``ts``/``dur``."""
        pid = os.getpid()
        trace_events: list[dict] = []
        tids = set()
        for ev in self.events():
            tids.add(ev.tid)
            trace_events.append({
                "name": ev.name, "cat": ev.cat, "ph": "X",
                "ts": round(ev.ts_s * 1e6, 3),
                "dur": max(round(ev.dur_s * 1e6, 3), 0.001),
                "pid": pid, "tid": ev.tid,
                "args": {k: v for k, v in ev.attrs.items()},
            })
        # counter tracks (ph "C"): one Perfetto track per sampled series
        # — the memory-ledger gauges / data-plane counters over time
        for name, ts, value in self.counter_samples():
            trace_events.append({
                "name": name, "cat": "counter", "ph": "C",
                "ts": round(ts * 1e6, 3), "pid": pid,
                "args": {"value": value},
            })
        # thread-name metadata rows so Perfetto labels the tracks
        # (synthetic tracks — per-request timelines — carry their
        # registered names)
        with self._lock:
            track_names = dict(self._track_names)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": "hetu_tpu"}}]
        for tid in sorted(tids | set(track_names)):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid,
                         "args": {"name": track_names.get(
                             tid, f"thread-{tid}")}})
        return {"traceEvents": meta + trace_events,
                "displayTimeUnit": "ms",
                "otherData": {"epoch_unix": self.epoch_unix,
                              "dropped_events": self.dropped}}

    def export_chrome(self, path: str) -> str:
        # temp + os.replace: a crash mid-export leaves the previous
        # complete trace, never a truncated JSON (telemetry.flight)
        from hetu_tpu_torch.telemetry.flight import atomic_write_text
        return atomic_write_text(path, json.dumps(self.to_chrome()))

    def export_jsonl(self, path: str, *, append: bool = False) -> str:
        from hetu_tpu_torch.telemetry.flight import atomic_write_text
        lines = "".join(json.dumps(rec) + "\n" for rec in self.records())
        if append:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            with open(path, "a") as f:
                f.write(lines)
            return path
        return atomic_write_text(path, lines)
