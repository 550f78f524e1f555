"""Token push subscriptions: the engine half of the streaming front end
(a copy of ``hetu_tpu/serving/streaming.py``).

A :class:`TokenSubscription` is a bounded queue of token EVENTS for one
request. The producer — ``ServingEngine._pump_stream_subs`` at the end
of every step, after its commit — calls
:func:`push_delta`, which folds the request's newly committed tokens
into one event and enqueues it WITHOUT blocking: a slow or dead
consumer overflows its own queue, is marked ``dropped`` (counted), and
degrades to RESULT polling; the step loop never waits on a socket.

Every event carries a per-request MONOTONIC TOKEN OFFSET (``off`` = how
many generated tokens preceded this delta), so a subscriber that
reconnects passes the count it already holds and the replay starts
exactly there — nothing lost, nothing duplicated, across socket drops
and KV resumes (a resumed request preloads its token list, so offsets
stay consistent).

Pure stdlib and host-only: no tensor is touched.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional


def _registry():
    from hetu_tpu_torch import telemetry
    return telemetry.get_registry()


def count_subscribe(mode: str) -> None:
    """``mode="new"`` for a first subscription, ``"resume"`` for a
    resubscribe-at-offset after a stream loss."""
    try:
        _registry().counter(
            "serving_stream_subscribes_total",
            "token-stream subscriptions by mode (new vs "
            "resubscribe-at-offset after a stream loss)").inc(mode=mode)
    except Exception:                                 # noqa: BLE001
        pass


def count_fallback(reason: str) -> None:
    """One subscriber fell back from push to RESULT polling."""
    try:
        _registry().counter(
            "serving_stream_fallbacks_total",
            "stream-loss fallbacks to the RESULT poll lane, by reason "
            "(the poll lane survives only as this loud fallback)").inc(
            reason=reason)
    except Exception:                                 # noqa: BLE001
        pass


class TokenSubscription:
    """Bounded per-subscriber event queue for one request's tokens.

    ``sent`` is the subscription's token cursor: the number of
    generated tokens already folded into events. The producer advances
    it; the consumer (a drainer thread writing frames, or a local
    iterator) only reads events. ``dropped`` flips when the queue
    overflows — the producer stops feeding it and the drainer tells
    the subscriber to fall back to polling.
    """

    def __init__(self, req_id: int, *, offset: int = 0,
                 max_queue: int = 256):
        self.req_id = int(req_id)
        self.sent = max(0, int(offset))
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(max_queue)))
        self.dropped = False
        self.closed = False
        self._close_ev = threading.Event()

    def emit(self, ev: dict) -> bool:
        """Enqueue one event; never blocks. False = subscriber lost
        (queue full → dropped, or already closed)."""
        if self.dropped or self.closed:
            return False
        try:
            self._q.put_nowait(ev)
            return True
        except queue.Full:
            self.dropped = True
            try:
                _registry().counter(
                    "serving_stream_subscriber_drops_total",
                    "subscriptions dropped because their bounded event "
                    "queue overflowed (slow/dead consumer degraded to "
                    "RESULT polling — the step loop never stalls)").inc()
            except Exception:                         # noqa: BLE001
                pass
            return False

    def get(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Dequeue the next event (None on timeout)."""
        try:
            if timeout is None:
                return self._q.get_nowait()
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self.closed = True
        self._close_ev.set()


def delta_event(req, sub: TokenSubscription, *,
                now: Optional[float] = None) -> Optional[dict]:
    """Build the next event for ``sub`` from ``req``'s current state
    and advance the cursor; None when nothing new happened.

    ``req`` is duck-typed (the engine's Request, or anything with):
    ``id``, ``trace_id``, ``tokens``, ``status``,
    ``done``, ``result()``. Terminal states fold the full ``result()``
    (the trailing timing payload) into the final frame; an out-of-band
    exit (evicted / cancelled / P-D handoff park) emits ``end`` so the
    subscriber falls back — whoever took the request out owns it now.
    """
    n = len(req.tokens)
    terminal = req.done.is_set()
    interrupted = (not terminal) and req.status in (
        "evicted", "cancelled", "prefilled")
    if n <= sub.sent and not terminal and not interrupted:
        return None
    toks = [int(t) for t in list(req.tokens)[sub.sent:n]]
    ev = {"req": int(req.id), "trace": req.trace_id,
          "off": sub.sent, "toks": toks,
          "first": sub.sent == 0 and n > 0,
          "done": bool(terminal),
          "ts": round(time.monotonic() if now is None else now, 6)}
    sub.sent = n
    if terminal:
        ev["result"] = req.result()
    elif interrupted:
        ev["end"] = req.status
    return ev


def push_delta(req, sub: TokenSubscription, *,
               now: Optional[float] = None) -> Optional[dict]:
    """``delta_event`` + enqueue + accounting; closes the subscription
    on its terminal frame. Returns the event (even if the enqueue was
    refused — the caller can tell from ``sub.dropped``)."""
    ev = delta_event(req, sub, now=now)
    if ev is None:
        return None
    if sub.emit(ev):
        try:
            reg = _registry()
            reg.counter(
                "serving_stream_events_total",
                "token events pushed into subscriber queues (one per "
                "request per step with news)").inc()
            if ev["toks"]:
                reg.counter(
                    "serving_stream_tokens_total",
                    "tokens delivered via push subscriptions (vs the "
                    "RESULT poll lane)").inc(len(ev["toks"]))
        except Exception:                             # noqa: BLE001
            pass
    if ev.get("done") or ev.get("end"):
        sub.close()
    return ev
