"""Flight recorder + hang watchdog: the production black box (a copy
of ``hetu_tpu/telemetry/flight.py``).

The span tracer and metric registry answer "how is the run doing?" —
this module answers "what was the system doing when it died?". Three
pieces, deliberately independent of the telemetry master switch (a
crash is exactly when opt-in observability has been left off):

- :class:`FlightRecorder` — an always-on bounded ring of structured
  events (step boundaries, admissions/evictions, strategy switches,
  checkpoints, collective bootstraps). A deque append per event: cheap
  enough to leave on for a 1M-step run, bounded so it never grows.
- :func:`install_crash_handlers` — wires :meth:`FlightRecorder.dump`
  to ``sys.excepthook``, ``SIGTERM`` and ``atexit`` so every failure
  mode leaves a ``flight_<rank>.jsonl`` postmortem (written atomically:
  a die-mid-dump never leaves a truncated artifact).
- :class:`HangWatchdog` — a monitor thread fed by ``beat()`` calls from
  the step/serving loop. When no beat lands within ``factor`` x the
  rolling median inter-beat interval, it dumps the flight record plus
  all-thread stacks (``faulthandler`` sidecar + a parseable
  ``thread_stacks`` JSON record) and increments
  ``watchdog_trips_total`` — turning a silent hang into a forensics
  artifact while the process is still alive to write one.

``tools/obs_report.py`` renders the dumps; docs/OBSERVABILITY.md
documents the event schema and the config knobs.
"""

from __future__ import annotations

import atexit
import collections
import faulthandler
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, Optional

#: flight-record schema version (bump on incompatible event changes)
FLIGHT_SCHEMA = 1


def atomic_write_text(path: str, text: str) -> str:
    """Write ``text`` to ``path`` via a temp file + ``os.replace`` so a
    crash mid-write never leaves a truncated artifact (the reader either
    sees the old complete file or the new complete file)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    # pid + thread id: concurrent dumpers of the SAME path (watchdog
    # monitor thread vs a signal handler on the main thread) must never
    # share a temp file — last os.replace wins with a complete artifact
    tmp = os.path.join(
        d, f".{os.path.basename(path)}.tmp.{os.getpid()}."
           f"{threading.get_ident()}")
    try:
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def _default_rank() -> int:
    for var in ("HETU_RANK", "JAX_PROCESS_INDEX"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def thread_stacks() -> dict[str, list[str]]:
    """All-thread stacks as ``{"<tid> <name>": [frame lines]}`` — the
    JSON-parseable complement to the faulthandler sidecar."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict[str, list[str]] = {}
    for tid, frame in sys._current_frames().items():
        lines = [ln.rstrip() for ln in traceback.format_stack(frame)]
        out[f"{tid} {names.get(tid, '?')}"] = lines
    return out


class FlightRecorder:
    """Bounded ring buffer of structured events, always on.

    Events are host-side dicts; the hot-path cost is one lock + deque
    append. ``capacity`` bounds memory (oldest events fall off), so the
    dump is "the last N things the system did" — which is what a
    postmortem needs.
    """

    def __init__(self, *, capacity: int = 4096, rank: Optional[int] = None):
        self.capacity = int(capacity)
        self.rank = _default_rank() if rank is None else int(rank)
        self.enabled = True
        self.dump_dir: Optional[str] = None
        # fleet identity: N engine processes on one host all
        # see rank 0 — the replica name/role disambiguate their dumps
        self.replica: Optional[str] = os.environ.get(
            "HETU_REPLICA_NAME") or None
        self.role: Optional[str] = os.environ.get(
            "HETU_REPLICA_ROLE") or None
        self.epoch_unix = time.time()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._total = 0
        self._dumps = 0
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one event. ``kind`` is the discriminator (``step``,
        ``switch``, ``checkpoint``, ``serving_admit``, ...); ``fields``
        must be JSON-serializable scalars/short strings."""
        if not self.enabled:
            return
        t = time.time()
        with self._lock:
            self._seq += 1
            self._total += 1
            self._ring.append((self._seq, t, threading.get_ident(),
                               kind, fields))

    def events(self) -> list[dict]:
        with self._lock:
            ring = list(self._ring)
        return [{"kind": "flight_event", "seq": s, "ts_unix": round(t, 6),
                 "tid": tid, "event": kind, **fields}
                for s, t, tid, kind, fields in ring]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._total = 0
        self.epoch_unix = time.time()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def set_identity(self, *, replica: Optional[str] = None,
                     role: Optional[str] = None) -> None:
        """Stamp this process's fleet identity (replica name / role)
        into future dump headers. Idempotent; ``None`` leaves a field
        unchanged."""
        if replica is not None:
            self.replica = replica
        if role is not None:
            self.role = role

    # -- dumping ------------------------------------------------------------
    def default_path(self, dir: Optional[str] = None) -> str:
        # pid in the name: N engine processes on one host all see rank
        # 0, and without it the last dump silently clobbers the rest.
        # obs_report globs *flight*.jsonl, so the
        # extra component stays discoverable.
        d = dir or self.dump_dir or "."
        return os.path.join(d, f"flight_{self.rank}.{os.getpid()}.jsonl")

    def dump(self, path: Optional[str] = None, *, reason: str = "manual",
             stacks: bool = False, extra: Optional[dict] = None) -> str:
        """Write the ring as JSONL (header record first, then events,
        then optionally a ``thread_stacks`` record), atomically."""
        path = path or self.default_path()
        with self._lock:
            total, dropped = self._total, self._total - len(self._ring)
        header = {"kind": "flight_header", "schema": FLIGHT_SCHEMA,
                  "reason": reason, "rank": self.rank, "pid": os.getpid(),
                  "ts_unix": round(time.time(), 6),
                  "epoch_unix": round(self.epoch_unix, 6),
                  "events_total": total, "events_dropped": dropped,
                  "argv": list(sys.argv)}
        if self.replica is not None:
            header["replica"] = self.replica
        if self.role is not None:
            header["role"] = self.role
        if extra:
            header.update(extra)
        lines = [json.dumps(header)]
        lines += [json.dumps(ev) for ev in self.events()]
        if stacks:
            lines.append(json.dumps({"kind": "thread_stacks",
                                     "ts_unix": round(time.time(), 6),
                                     "stacks": thread_stacks()}))
        atomic_write_text(path, "\n".join(lines) + "\n")
        with self._lock:
            self._dumps += 1
        return path


_FLIGHT = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """The process-global flight recorder (always on)."""
    return _FLIGHT


def flight_record(kind: str, **fields) -> None:
    """Record one event on the global flight recorder."""
    _FLIGHT.record(kind, **fields)


# -- crash wiring -----------------------------------------------------------

_install_lock = threading.Lock()
_installed: dict = {}


def _dump_at_exit(rec: FlightRecorder) -> None:
    """atexit hook: leave a postmortem on plain exits — but a
    crash/SIGTERM/watchdog dump already captured the failure (with
    stacks + reason), and the exit dump must not ``os.replace`` that
    forensics file with a stacks-free ``reason="atexit"`` one."""
    try:
        if len(rec) and rec._dumps == 0:
            rec.dump(reason="atexit")
    except Exception:
        pass


def install_crash_handlers(dir: str = ".", *,
                           recorder: Optional[FlightRecorder] = None,
                           sigterm: bool = True,
                           at_exit: bool = True) -> FlightRecorder:
    """Arrange for a ``flight_<rank>.jsonl`` postmortem on every failure
    mode: unhandled exception (``sys.excepthook``), ``SIGTERM`` (the
    preemption signal), and normal interpreter exit (``atexit`` — only
    when the recorder saw events, so idle imports never litter).
    Idempotent; chains any pre-existing hooks. Returns the recorder."""
    rec = recorder or _FLIGHT
    with _install_lock:
        rec.dump_dir = dir
        if _installed.get("done"):
            return rec

        prev_excepthook = sys.excepthook

        def _crash_hook(exc_type, exc, tb):
            try:
                rec.record("crash", error=exc_type.__name__,
                           message=str(exc)[:500])
                rec.dump(reason="crash", stacks=True)
            except Exception:
                pass
            prev_excepthook(exc_type, exc, tb)

        sys.excepthook = _crash_hook

        # sys.excepthook only fires for the MAIN thread; the serving
        # loop, prefetcher and checkpoint writer are daemon threads
        # whose deaths would otherwise leave no postmortem at all
        prev_thread_hook = threading.excepthook

        def _thread_crash_hook(args):
            try:
                rec.record(
                    "crash", error=args.exc_type.__name__,
                    message=str(args.exc_value)[:500],
                    thread=getattr(args.thread, "name", "?"))
                rec.dump(reason="thread_crash", stacks=True)
            except Exception:
                pass
            prev_thread_hook(args)

        threading.excepthook = _thread_crash_hook

        if sigterm:
            try:
                prev_term = signal.getsignal(signal.SIGTERM)

                def _term_handler(signum, frame):
                    try:
                        rec.record("sigterm")
                        rec.dump(reason="sigterm", stacks=True)
                    except Exception:
                        pass
                    if prev_term is signal.SIG_IGN:
                        return        # the process chose to ignore
                                      # SIGTERM; dump but don't die
                    if callable(prev_term) and \
                            prev_term is not signal.SIG_DFL:
                        prev_term(signum, frame)
                    else:
                        raise SystemExit(128 + signum)

                signal.signal(signal.SIGTERM, _term_handler)
            except ValueError:
                pass   # not the main thread: signal wiring unavailable

        if at_exit:
            atexit.register(_dump_at_exit, rec)

        _installed["done"] = True
    return rec


def _reset_crash_handlers_for_tests() -> None:
    """Test hook: forget the installed-once latch (handlers themselves
    stay chained — re-install only re-arms the dir)."""
    with _install_lock:
        _installed.clear()


# -- hang watchdog ----------------------------------------------------------

#: always-on mirror of ``watchdog_trips_total``: the registry no-ops its
#: writes while the telemetry master switch is off, but a hang is health
#: state that must survive exactly that configuration — HEALTHZ reads
#: this alongside the registry (telemetry/slo.health_status)
_TRIP_TOTALS: dict[str, int] = {}
_trip_lock = threading.Lock()


def watchdog_trip_totals() -> dict[str, int]:
    """``{watchdog_name: trips}`` across the process, independent of the
    telemetry switch."""
    with _trip_lock:
        return dict(_TRIP_TOTALS)


def _clear_trip_totals() -> None:
    """Part of ``telemetry.reset()`` (tests / between runs)."""
    with _trip_lock:
        _TRIP_TOTALS.clear()


class HangWatchdog:
    """Monitor thread that trips when the watched loop stops beating.

    The loop calls :meth:`beat` once per completed iteration; the
    watchdog keeps a rolling median of inter-beat intervals and trips
    when ``now - last_beat`` exceeds ``max(min_timeout_s, factor x
    median)``. One trip per hang: a trip latches until the next beat.

    On trip: ``watchdog_trips_total{name=...}`` is incremented, the
    flight record (plus all-thread stacks) is dumped to
    ``flight_<rank>.jsonl``, a ``faulthandler`` sidecar
    (``flight_<rank>.stacks``) captures the native-level view, and
    ``on_trip(reason)`` fires (e.g. to abort the run).
    """

    def __init__(self, *, name: str = "train", factor: float = 8.0,
                 min_timeout_s: float = 30.0, poll_s: float = 1.0,
                 window: int = 64,
                 dump_dir: Optional[str] = None,
                 recorder: Optional[FlightRecorder] = None,
                 registry=None,
                 on_trip: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.factor = float(factor)
        self.min_timeout_s = float(min_timeout_s)
        self.poll_s = float(poll_s)
        self.dump_dir = dump_dir
        self.recorder = recorder or _FLIGHT
        self._registry = registry
        self.on_trip = on_trip
        self._clock = clock
        self._intervals: collections.deque = collections.deque(
            maxlen=int(window))
        self._last_beat: Optional[float] = None
        self._tripped = False
        self.trips = 0
        self._lock = threading.Lock()
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- fed by the watched loop -------------------------------------------
    def beat(self) -> None:
        now = self._clock()
        with self._lock:
            if self._last_beat is not None:
                self._intervals.append(now - self._last_beat)
            self._last_beat = now
            self._tripped = False   # progress clears the latch

    def pause(self) -> None:
        """Suspend trip checks across a legitimately long blocking
        operation the caller knows about (a mid-run recompile, a
        synchronous checkpoint drain) — a pause without a matching
        :meth:`resume` keeps the watchdog dormant. The paused interval
        never enters the rolling median."""
        with self._lock:
            self._last_beat = None

    def resume(self) -> None:
        """Re-arm after :meth:`pause` (a fresh beat; the next interval
        starts from now)."""
        self.beat()

    def timeout_s(self) -> float:
        """The current trip threshold (rolling-median based)."""
        with self._lock:
            if not self._intervals:
                return self.min_timeout_s
            med = sorted(self._intervals)[len(self._intervals) // 2]
        return max(self.min_timeout_s, self.factor * med)

    def check(self) -> Optional[float]:
        """One monitor evaluation; returns the stall seconds when it
        trips, else None. (The monitor thread calls this on ``poll_s``;
        tests can call it directly.)"""
        with self._lock:
            last, tripped = self._last_beat, self._tripped
        if last is None or tripped:
            return None
        stalled = self._clock() - last
        if stalled <= self.timeout_s():
            return None
        self._trip(stalled)
        return stalled

    def _trip(self, stalled_s: float) -> None:
        with self._lock:
            self._tripped = True     # latch first: no double-trip
        reason = (f"watchdog[{self.name}]: no beat for {stalled_s:.1f}s "
                  f"(threshold {self.timeout_s():.1f}s)")
        reg = self._registry
        if reg is None:
            from hetu_tpu_torch import telemetry
            reg = telemetry.get_registry()
        reg.counter("watchdog_trips_total",
                    "hang-watchdog trips by loop name").inc(name=self.name)
        with _trip_lock:
            _TRIP_TOTALS[self.name] = _TRIP_TOTALS.get(self.name, 0) + 1
        self.recorder.record("watchdog_trip", name=self.name,
                             stalled_s=round(stalled_s, 3))
        try:
            path = self.recorder.dump(
                self.recorder.default_path(self.dump_dir),
                reason="watchdog", stacks=True,
                extra={"watchdog": self.name,
                       "stalled_s": round(stalled_s, 3)})
            # native-level sidecar: faulthandler sees threads the
            # interpreter-level walk can miss (C extensions, GIL holders)
            with open(path.rsplit(".jsonl", 1)[0] + ".stacks", "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
        except Exception:
            pass   # forensics must never crash the watched process
        if self.on_trip is not None:
            try:
                self.on_trip(reason)
            except Exception:
                pass
        with self._lock:
            # incremented LAST: observing trips > 0 means the dump and
            # the on_trip callback have completed (no forensics race)
            self.trips += 1

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "HangWatchdog":
        if self._thread is not None:
            return self
        with self._lock:
            # a restarted watchdog (engine stop()/start()) must not arm
            # against the previous session's last beat — that gap is
            # downtime, not a hang
            self._last_beat = None
            self._tripped = False
        self._stop = threading.Event()

        def monitor():
            while not self._stop.wait(self.poll_s):
                self.check()

        self._thread = threading.Thread(
            target=monitor, name=f"watchdog-{self.name}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
