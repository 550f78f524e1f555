"""Persistent multiplexed stream channel over the coordinator port (a
copy of ``hetu_tpu/rpc/stream.py``).

The line protocol (``py_server.py``) costs one round trip per RESULT
poll. This module adds the push lane: a client opens ONE
long-lived socket per (client, server) pair, sends the hello line
``HSTRM1 [token]\\n`` (sniffable by the server's existing
``readline()``), and both directions switch to length-framed compact
JSON messages tagged with a stream id:

    4-byte big-endian length | {"k": <kind>, "sid": <id>, ...}

Client → server kinds:

- ``req``     — one multiplexed one-shot verb (``line`` = the same
  text a line-protocol client would send); answered by ``res``.
- ``sub``     — subscribe to request ``id`` from token offset ``off``;
  the server replays everything from that offset, so reconnect loses
  nothing and replays nothing.
- ``stream``  — SUBMIT (``payload`` = the URL-quoted SUBMIT payload,
  idempotency key + traceparent included) and subscribe in one frame;
  answered by ``ack`` (request id + trace id) then ``ev`` frames.
- ``unsub``   — drop one subscription.
- ``ping``    — liveness; answered by ``pong``.

Server → client kinds:

- ``hello``   — auth accepted, stream mode live.
- ``res`` / ``ack`` / ``pong`` — responses, matched by ``sid``.
- ``ev``      — one token event: ``off`` (per-request monotonic token
  offset), ``toks`` (newly committed ids), ``first``/``done`` markers,
  ``result`` (trailing timing payload on the final frame), ``end``
  (out-of-band exit: evicted/cancelled — the subscriber falls back).
- ``drop``    — subscription killed server-side (slow consumer,
  unknown request, unsupported) — the client falls back to RESULT
  polls and may resubscribe-at-offset.
- ``err``     — request-level failure.

One-shot verbs keep working unchanged on the same listener: the first
bytes decide the protocol, nothing else changes.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
from typing import Callable, Optional

MAGIC = "HSTRM1"

#: frame size ceiling — a corrupt length prefix must not allocate GBs
MAX_FRAME = 64 * 1024 * 1024


def _count_frame(kind: str, direction: str) -> None:
    """Wire instrumentation (never breaks the protocol): stream frames
    by kind and direction — client uses tx/rx, server in/out, matching
    ``rpc_payload_bytes_total``'s convention."""
    try:
        from hetu_tpu_torch import telemetry
        telemetry.get_registry().counter(
            "rpc_stream_frames_total",
            "stream-channel frames by kind and direction (client: "
            "tx/rx, server: in/out)").inc(kind=kind, dir=direction)
    except Exception:                                 # noqa: BLE001
        pass


def _count_connect(role: str) -> None:
    try:
        from hetu_tpu_torch import telemetry
        telemetry.get_registry().counter(
            "rpc_stream_connects_total",
            "stream-channel connections established, by role").inc(
            role=role)
    except Exception:                                 # noqa: BLE001
        pass


def write_frame(wfile, lock: threading.Lock, obj: dict, *,
                direction: str) -> None:
    """Serialize one frame onto ``wfile`` (length prefix + compact
    JSON). ``lock`` serializes concurrent writers on one connection —
    a torn frame desyncs everything after it."""
    body = json.dumps(obj, separators=(",", ":")).encode()
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(body)} bytes")
    buf = len(body).to_bytes(4, "big") + body
    with lock:
        wfile.write(buf)
        wfile.flush()
    _count_frame(str(obj.get("k", "?")), direction)


def read_frame(rfile, *, direction: str) -> Optional[dict]:
    """Read one frame from ``rfile``; None on clean EOF. Raises
    ValueError on a corrupt length prefix (caller closes the
    connection — there is no resynchronizing a framed stream)."""
    head = rfile.read(4)
    if not head:
        return None
    if len(head) < 4:
        raise ValueError("truncated frame header")
    n = int.from_bytes(head, "big")
    if not 0 < n <= MAX_FRAME:
        raise ValueError(f"bad frame length: {n}")
    body = rfile.read(n)
    if len(body) < n:
        raise ValueError("truncated frame body")
    fr = json.loads(body)
    if not isinstance(fr, dict):
        raise ValueError("frame is not an object")
    _count_frame(str(fr.get("k", "?")), direction)
    return fr


class StreamChannel:
    """Client end of one persistent multiplexed connection.

    A single background reader thread demultiplexes inbound frames:
    ``res``/``ack``/``pong`` resolve the waiter parked on their stream
    id, ``ev``/``drop``/``err`` frames go to the subscription's sink
    callable (invoked ON the reader thread — sinks must be quick and
    never block, exactly like the engine's token callbacks). When the
    socket dies every sink receives a final ``{"k": "lost"}`` event,
    which is the subscriber's cue to fall back to RESULT polling and
    resubscribe-at-offset on a fresh channel.
    """

    def __init__(self, port: int, host: str = "127.0.0.1", *,
                 token: Optional[str] = None,
                 connect_timeout: float = 10.0):
        self._host, self._port = host, int(port)
        tok = token if token is not None \
            else os.environ.get("HETU_COORD_TOKEN") or ""
        self._sock = socket.create_connection(
            (host, int(port)), timeout=connect_timeout)
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._sids = itertools.count(1)
        self._sinks: dict[int, Callable[[dict], None]] = {}
        self._waiters: dict[int, tuple[threading.Event, dict]] = {}
        self.alive = False
        hello = f"{MAGIC} {tok}".rstrip() + "\n"
        self._sock.sendall(hello.encode())
        first = read_frame(self._rfile, direction="rx")
        if first is None or first.get("k") != "hello":
            self._close_sock()
            raise ConnectionError(
                f"stream hello rejected: {first!r}")
        self._sock.settimeout(None)    # reader blocks until frames/EOF
        self.alive = True
        _count_connect("client")
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"stream-chan-{port}")
        self._reader.start()

    # -- plumbing -----------------------------------------------------------
    def _send(self, obj: dict) -> None:
        if not self.alive:
            raise ConnectionError("stream channel is down")
        try:
            write_frame(self._wfile, self._wlock, obj, direction="tx")
        except (OSError, ValueError):
            self._down()
            raise

    def _read_loop(self) -> None:
        try:
            while True:
                fr = read_frame(self._rfile, direction="rx")
                if fr is None:
                    break
                self._dispatch(fr)
        except (OSError, ValueError, json.JSONDecodeError):
            pass
        self._down()

    def _dispatch(self, fr: dict) -> None:
        sid = int(fr.get("sid", 0))
        kind = fr.get("k")
        if kind in ("res", "ack", "pong", "err"):
            with self._lock:
                w = self._waiters.pop(sid, None)
            if w is not None:
                w[1]["fr"] = fr
                w[0].set()
                return
            if kind != "err":
                return                 # late response, waiter gave up
        with self._lock:
            sink = self._sinks.get(sid)
            terminal = kind in ("drop", "err") or (
                kind == "ev" and (fr.get("done") or fr.get("end")))
            if terminal:
                self._sinks.pop(sid, None)
        if sink is not None:
            try:
                sink(fr)
            except Exception:                         # noqa: BLE001
                pass                   # a broken sink must not kill
            #                            the channel for its siblings

    def _down(self) -> None:
        with self._lock:
            if not self.alive and not self._sinks and not self._waiters:
                return
            self.alive = False
            sinks = list(self._sinks.items())
            waiters = list(self._waiters.values())
            self._sinks.clear()
            self._waiters.clear()
        for ev, box in waiters:
            box["fr"] = {"k": "err", "msg": "stream channel lost"}
            ev.set()
        for sid, sink in sinks:
            try:
                sink({"k": "lost", "sid": sid})
            except Exception:                         # noqa: BLE001
                pass
        self._close_sock()

    def _close_sock(self) -> None:
        # shutdown FIRST: it unblocks a reader parked in recv (a bare
        # close of a buffered reader another thread is blocked inside
        # deadlocks on the buffer's internal lock)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        for closer in (self._wfile, self._sock):
            try:
                closer.close()
            except OSError:
                pass
        # _rfile belongs to the reader thread; anyone else closing it
        # races the blocked read on the buffer lock. The shutdown above
        # EOFs the reader, which drops through here itself on exit.
        reader = getattr(self, "_reader", None)
        if reader is None or reader is threading.current_thread():
            try:
                self._rfile.close()
            except OSError:
                pass

    # -- API ----------------------------------------------------------------
    def request(self, line: str, *, timeout: float = 30.0) -> str:
        """One multiplexed one-shot verb; returns the response line
        (exactly what the line protocol would answer). Concurrent
        requests interleave freely on the shared socket."""
        sid = next(self._sids)
        done, box = threading.Event(), {}
        with self._lock:
            self._waiters[sid] = (done, box)
        try:
            self._send({"k": "req", "sid": sid, "line": line})
        except Exception:
            with self._lock:
                self._waiters.pop(sid, None)
            raise
        if not done.wait(timeout):
            with self._lock:
                self._waiters.pop(sid, None)
            raise TimeoutError(f"stream request timed out: {line!r}")
        fr = box["fr"]
        if fr.get("k") == "err":
            raise ConnectionError(
                f"stream request failed: {fr.get('msg')}")
        return str(fr.get("line", ""))

    def subscribe(self, req_id: int, *, offset: int = 0,
                  sink: Callable[[dict], None]) -> int:
        """Subscribe to token events for ``req_id`` starting at token
        ``offset`` — the server replays everything from there, so a
        reconnecting subscriber passes the count it already holds and
        the stream resumes seamlessly. Returns the stream id."""
        sid = next(self._sids)
        with self._lock:
            self._sinks[sid] = sink
        try:
            self._send({"k": "sub", "sid": sid, "id": int(req_id),
                        "off": int(offset)})
        except Exception:
            with self._lock:
                self._sinks.pop(sid, None)
            raise
        return sid

    def stream_submit(self, payload: str, *,
                      sink: Callable[[dict], None],
                      offset: int = 0,
                      timeout: float = 30.0) -> dict:
        """SUBMIT + subscribe in one frame. ``payload`` is the same
        URL-quoted SUBMIT payload the line protocol carries (the
        idempotency key and traceparent ride inside it, so a retried
        delivery joins the original request). Returns
        ``{"id", "trace", "sid"}`` once the server acks."""
        sid = next(self._sids)
        done, box = threading.Event(), {}
        with self._lock:
            self._sinks[sid] = sink
            self._waiters[sid] = (done, box)
        try:
            self._send({"k": "stream", "sid": sid, "payload": payload,
                        "off": int(offset)})
        except Exception:
            with self._lock:
                self._sinks.pop(sid, None)
                self._waiters.pop(sid, None)
            raise
        if not done.wait(timeout):
            with self._lock:
                self._sinks.pop(sid, None)
                self._waiters.pop(sid, None)
            raise TimeoutError("stream submit timed out")
        fr = box["fr"]
        if fr.get("k") != "ack":
            with self._lock:
                self._sinks.pop(sid, None)
            raise RuntimeError(
                f"stream submit failed: {fr.get('msg', fr)}")
        return {"id": int(fr["id"]), "trace": fr.get("trace", ""),
                "sid": sid}

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._sinks.pop(sid, None)
        try:
            self._send({"k": "unsub", "sid": int(sid)})
        except Exception:                             # noqa: BLE001
            pass                        # channel already down — moot

    def ping(self, timeout: float = 5.0) -> bool:
        sid = next(self._sids)
        done, box = threading.Event(), {}
        with self._lock:
            self._waiters[sid] = (done, box)
        try:
            self._send({"k": "ping", "sid": sid})
        except Exception:                             # noqa: BLE001
            return False
        if not done.wait(timeout):
            with self._lock:
                self._waiters.pop(sid, None)
            return False
        return box["fr"].get("k") == "pong"

    def close(self) -> None:
        self._down()
