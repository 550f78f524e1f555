"""The coordinator server, line protocol over TCP (a copy of
``hetu_tpu/rpc/py_server.py``): RANK/KV/BARRIER/BEAT/STATUS for a
training fleet, the serving verbs when an engine or a fleet
``serving.router.Router`` is attached (``serving/server.py`` answers
them), and the length-framed stream mode
(``rpc/stream.py``) on the same listener: the first line a client sends
decides which protocol its connection speaks.

``port=0`` binds a free port; :attr:`PyCoordinatorServer.port` holds
the bound one after :meth:`~PyCoordinatorServer.start`. HEALTHZ answers
the health document of ``telemetry.health_status`` (SLO state, watchdog
trips, the attached engine's queue, occupancy and loop liveness, or a
Router's ``fleet_status()``: no live replica reads degraded) with, for a
Router, its federated rollup under ``fleet``, URL quoted onto one ``VAL``
line; METRICS the registry's Prometheus text. With a Router attached,
BEAT also reaches its replica staleness tracking.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Optional


#: serving verbs forwarded to ``serving/server.py`` — duplicated here
#: (instead of imported) so the bare coordinator does not import the
#: engine; ``tests/test_torch_server.py`` asserts this mirrors
#: ``serving.server.SERVING_COMMANDS``.
_SERVING_VERBS = ("SUBMIT", "RESULT", "GENERATE",
                  "FLEET", "DRAIN", "RESUME",
                  "ESTATUS", "CANCELQ", "EVICT", "PREFILL",
                  "SWAPWEIGHTS", "STOPENGINE",
                  "DUMPOBS", "FLEETMETRICS",
                  "KVEXPORT", "KVIMPORT", "KVREPL", "KVFETCH",
                  "KVBUDDY")


def _rpc_server_observe(verb: str, dur_ms: float,
                        n_in: int, n_out: int) -> None:
    """Server-end wire instrumentation: per-verb handling
    latency + payload bytes. ``dir`` uses in/out here (the client uses
    tx/rx) so both ends can share one registry in a single-process
    test without colliding."""
    from hetu_tpu_torch import telemetry
    reg = telemetry.get_registry()
    reg.histogram(
        "rpc_server_verb_ms",
        "server-side handling ms per line-protocol verb (parse to "
        "reply write)").observe(dur_ms, verb=verb)
    c = reg.counter(
        "rpc_payload_bytes_total",
        "line-protocol bytes by verb and direction (client: tx/rx, "
        "server: in/out)")
    c.inc(n_in, verb=verb, dir="in")
    c.inc(n_out, verb=verb, dir="out")


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.ranks: dict[str, int] = {}
        self.kv: dict[str, str] = {}
        self.beats: dict[str, float] = {}
        self.barriers: dict[str, dict] = {}


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        st: _State = self.server.state  # type: ignore[attr-defined]
        token: str = self.server.token  # type: ignore[attr-defined]
        authed = False
        first = True
        while True:
            line = self.rfile.readline()
            if not line:
                return
            if first:
                first = False
                # protocol sniff: a client whose first line
                # is the stream hello flips this connection into the
                # length-framed multiplexed mode; everything else stays
                # on the unchanged line protocol.
                if line.split(b" ", 1)[0].rstrip() == b"HSTRM1":
                    return self._stream_session(line)
            parts = line.decode().strip().split()
            if not parts:
                continue
            cmd, args = parts[0], parts[1:]
            # wire instrumentation window: _send() closes it (BARRIER
            # deliberately includes its wait — that IS its wire cost)
            self._verb, self._t0, self._rx_bytes = \
                cmd, time.perf_counter(), len(line)
            # auth gate (same contract as coordinator.cpp): PING stays
            # open for liveness probes, everything else needs the token
            if token and cmd != "PING" and not authed:
                import hmac
                if cmd == "AUTH" and args \
                        and hmac.compare_digest(args[0], token):
                    authed = True
                    self._send("OK")
                    continue
                self._send("ERR bad token" if cmd == "AUTH"
                           else "ERR auth required")
                return                       # close the connection
            if cmd == "AUTH":
                self._send("OK")             # no-token / already authed
            elif cmd == "RANK":
                with st.lock:
                    r = st.ranks.setdefault(args[0], len(st.ranks))
                self._send(f"RANK {r}")
            elif cmd == "SET":
                with st.lock:
                    st.kv[args[0]] = args[1]
                self._send("OK")
            elif cmd == "GET":
                with st.lock:
                    v = st.kv.get(args[0])
                self._send("NONE" if v is None else f"VAL {v}")
            elif cmd == "BEAT":
                with st.lock:
                    st.beats[args[0]] = time.monotonic()
                # a fleet front door forwards replica beats into the
                # attached Router (names it does not know are training
                # workers, ignored there)
                serving = getattr(self.server, "serving", None)
                if serving is not None and hasattr(serving, "heartbeat"):
                    try:
                        serving.heartbeat(args[0])
                    except Exception:       # noqa: BLE001
                        pass
                self._send("OK")
            elif cmd == "STATUS":
                timeout = int(args[0]) / 1e3
                now = time.monotonic()
                with st.lock:
                    alive = [n for n, t in st.beats.items()
                             if now - t <= timeout]
                    dead = [n for n, t in st.beats.items()
                            if now - t > timeout]
                self._send(f"ALIVE {','.join(alive)} DEAD "
                           f"{','.join(dead)}")
            elif cmd == "BARRIER":
                name, target, who = args[0], int(args[1]), args[2]
                with st.lock:
                    b = st.barriers.setdefault(
                        name, {"event": threading.Event(), "who": set()})
                    b["who"].add(who)
                    if len(b["who"]) >= target:
                        b["event"].set()
                        st.barriers.pop(name, None)
                        ev = b["event"]
                    else:
                        ev = b["event"]
                ev.wait()
                self._send("OK")
            elif cmd in _SERVING_VERBS:
                # serving-plane verbs (serving/server.py) — the lazy
                # import keeps the bare coordinator free of the engine
                from hetu_tpu_torch.serving.server import \
                    handle_serving_command
                resp = handle_serving_command(
                    getattr(self.server, "serving", None), cmd, args)
                self._send(resp or "ERR unknown command")
            elif cmd == "HEALTHZ":
                # live health document: SLO state, watchdog trips,
                # serving queue/occupancy (telemetry/slo.health_status)
                import urllib.parse

                from hetu_tpu_torch.telemetry.slo import health_status
                serving = getattr(self.server, "serving", None)
                doc = health_status(serving=serving,
                                    slo=getattr(serving, "slo", None))
                if hasattr(serving, "fleet_healthz"):
                    # a Router front door: the federated rollup that
                    # names the degraded replica
                    try:
                        doc["fleet"] = serving.fleet_healthz()
                    except Exception:       # noqa: BLE001
                        pass
                self._send("VAL " + urllib.parse.quote(
                    json.dumps(doc, separators=(",", ":")), safe=""))
            elif cmd == "METRICS":
                # Prometheus text exposition of the process-global
                # registry (URL-quoted onto the one-line protocol)
                import urllib.parse

                from hetu_tpu_torch import telemetry
                self._send("VAL " + urllib.parse.quote(
                    telemetry.get_registry().to_prometheus(), safe=""))
            elif cmd == "PING":
                self._send("PONG")
            elif cmd == "SHUTDOWN":
                self._send("OK")
                threading.Thread(
                    target=self.server.shutdown, daemon=True).start()
                return
            else:
                self._send("ERR unknown command")

    # -- streaming mode -------------------------------------------------------
    def _stream_session(self, hello: bytes) -> None:
        """One persistent multiplexed connection: frames in, frames
        out (``rpc/stream.py`` documents the kinds). The read loop
        stays single-threaded; one-shot verbs run on short-lived
        threads (a slow GENERATE must not block the channel) and every
        subscription gets its own drainer thread pulling events off
        the engine's bounded queue — all socket writes serialize on
        one lock, so frames never tear."""
        from hetu_tpu_torch.rpc.stream import read_frame, write_frame
        wlock = threading.Lock()
        parts = hello.decode(errors="replace").split()
        token: str = self.server.token  # type: ignore[attr-defined]
        if token:
            import hmac
            if len(parts) < 2 or not hmac.compare_digest(parts[1],
                                                         token):
                try:
                    write_frame(self.wfile, wlock,
                                {"k": "err", "sid": 0,
                                 "msg": "auth required"},
                                direction="out")
                except (OSError, ValueError):
                    pass
                return
        write_frame(self.wfile, wlock, {"k": "hello", "sid": 0, "v": 1},
                    direction="out")
        try:
            from hetu_tpu_torch.rpc.stream import _count_connect
            _count_connect("server")
        except Exception:                             # noqa: BLE001
            pass
        subs: dict[int, object] = {}
        closed = threading.Event()
        try:
            while True:
                fr = read_frame(self.rfile, direction="in")
                if fr is None:
                    return
                kind = fr.get("k")
                sid = int(fr.get("sid", 0))
                if kind == "req":
                    threading.Thread(
                        target=self._stream_req, args=(fr, wlock),
                        daemon=True).start()
                elif kind == "sub":
                    self._stream_sub(fr, wlock, subs, closed)
                elif kind == "stream":
                    self._stream_submit(fr, wlock, subs, closed)
                elif kind == "unsub":
                    sub = subs.pop(sid, None)
                    if sub is not None:
                        sub.close()
                elif kind == "ping":
                    write_frame(self.wfile, wlock,
                                {"k": "pong", "sid": sid},
                                direction="out")
        except (OSError, ValueError):
            return                      # client gone / corrupt stream
        finally:
            closed.set()
            for sub in subs.values():
                try:
                    sub.close()
                except Exception:                     # noqa: BLE001
                    pass

    def _stream_req(self, fr: dict, wlock: threading.Lock) -> None:
        """One multiplexed one-shot verb: same dispatch as the line
        loop for the serving family (+ PING), answered by a ``res``
        frame carrying the exact response line."""
        from hetu_tpu_torch.rpc.stream import write_frame
        line = str(fr.get("line", ""))
        parts = line.strip().split()
        t0 = time.perf_counter()
        if not parts:
            resp = "ERR empty"
        elif parts[0] == "PING":
            resp = "PONG"
        elif parts[0] in _SERVING_VERBS:
            from hetu_tpu_torch.serving.server import handle_serving_command
            try:
                resp = handle_serving_command(
                    getattr(self.server, "serving", None),
                    parts[0], parts[1:]) or "ERR unknown command"
            except Exception as e:                    # noqa: BLE001
                resp = f"ERR {type(e).__name__}: {e}"
        else:
            resp = "ERR verb not multiplexable"
        try:
            write_frame(self.wfile, wlock,
                        {"k": "res", "sid": fr.get("sid", 0),
                         "line": resp}, direction="out")
            if parts:
                _rpc_server_observe(
                    parts[0], (time.perf_counter() - t0) * 1e3,
                    n_in=len(line), n_out=len(resp))
        except (OSError, ValueError):
            pass                        # connection died mid-reply

    def _start_sub(self, req, fr: dict, wlock: threading.Lock,
                   subs: dict, closed: threading.Event) -> None:
        """Attach one subscription (shared by ``sub`` and ``stream``):
        the serving object replays from the requested token offset,
        then a drainer thread forwards events as they land."""
        from hetu_tpu_torch.rpc.stream import write_frame
        serving = getattr(self.server, "serving", None)
        sid = int(fr.get("sid", 0))
        off = max(0, int(fr.get("off", 0)))
        if serving is None or not hasattr(serving, "stream_subscribe"):
            write_frame(self.wfile, wlock,
                        {"k": "drop", "sid": sid,
                         "reason": "unsupported"}, direction="out")
            return
        try:
            sub = serving.stream_subscribe(req, offset=off)
        except Exception as e:                        # noqa: BLE001
            write_frame(self.wfile, wlock,
                        {"k": "err", "sid": sid,
                         "msg": f"{type(e).__name__}: {e}"},
                        direction="out")
            return
        try:
            from hetu_tpu_torch.serving.streaming import count_subscribe
            count_subscribe("resume" if off > 0 else "new")
        except Exception:                             # noqa: BLE001
            pass
        subs[sid] = sub
        threading.Thread(
            target=self._stream_drain, args=(sid, sub, wlock, closed),
            daemon=True,
            name=f"stream-drain-{getattr(req, 'id', '?')}").start()

    def _stream_sub(self, fr: dict, wlock: threading.Lock,
                    subs: dict, closed: threading.Event) -> None:
        from hetu_tpu_torch.rpc.stream import write_frame
        serving = getattr(self.server, "serving", None)
        sid = int(fr.get("sid", 0))
        req = None
        if serving is not None:
            req = getattr(serving, "_requests_by_id", {}).get(
                int(fr.get("id", -1)))
        if req is None:
            write_frame(self.wfile, wlock,
                        {"k": "drop", "sid": sid,
                         "reason": "unknown_request"}, direction="out")
            return
        self._start_sub(req, fr, wlock, subs, closed)

    def _stream_submit(self, fr: dict, wlock: threading.Lock,
                       subs: dict, closed: threading.Event) -> None:
        """``stream`` = SUBMIT (idempotency-keyed payload) + subscribe
        in one frame, acked with the request/trace ids before the
        first event."""
        from hetu_tpu_torch.rpc.stream import write_frame
        serving = getattr(self.server, "serving", None)
        sid = int(fr.get("sid", 0))
        if serving is None:
            write_frame(self.wfile, wlock,
                        {"k": "err", "sid": sid,
                         "msg": "serving disabled"}, direction="out")
            return
        from hetu_tpu_torch.serving.server import handle_stream_submit
        req, err = handle_stream_submit(serving,
                                        str(fr.get("payload", "")))
        if err is not None:
            write_frame(self.wfile, wlock,
                        {"k": "err", "sid": sid, "msg": err},
                        direction="out")
            return
        write_frame(self.wfile, wlock,
                    {"k": "ack", "sid": sid, "id": int(req.id),
                     "trace": req.trace_id}, direction="out")
        self._start_sub(req, fr, wlock, subs, closed)

    def _stream_drain(self, sid: int, sub, wlock: threading.Lock,
                      closed: threading.Event) -> None:
        """Per-subscription drainer: pulls events OFF the step lock's
        bounded queue and writes frames. A queue overflow (slow
        consumer) sends one ``drop`` frame and stops — the client
        falls back to RESULT polling."""
        from hetu_tpu_torch.rpc.stream import write_frame
        try:
            while not closed.is_set():
                ev = sub.get(timeout=0.25)
                if ev is None:
                    if sub.dropped:
                        write_frame(self.wfile, wlock,
                                    {"k": "drop", "sid": sid,
                                     "reason": "slow"},
                                    direction="out")
                        return
                    if sub.closed:
                        return
                    continue
                write_frame(self.wfile, wlock,
                            {"k": "ev", "sid": sid, **ev},
                            direction="out")
                if ev.get("done") or ev.get("end"):
                    return
        except (OSError, ValueError):
            sub.close()                 # connection gone — stop feeding

    def _send(self, s: str):
        self.wfile.write((s + "\n").encode())
        self.wfile.flush()
        verb = getattr(self, "_verb", None)
        if verb is not None:
            self._verb = None
            try:
                _rpc_server_observe(
                    verb, (time.perf_counter() - self._t0) * 1e3,
                    n_in=self._rx_bytes, n_out=len(s) + 1)
            except Exception:               # noqa: BLE001
                pass    # instrumentation must never break the protocol


class PyCoordinatorServer:
    def __init__(self, port: int, bind: str = "127.0.0.1",
                 token: str = "", serving=None):
        self.bind = bind
        self.port = port
        self.token = token
        self.serving = serving   # optional ServingEngine or fleet
        #                          Router (SUBMIT/.../FLEET verbs)
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()

    def start(self):
        socketserver.ThreadingTCPServer.allow_reuse_address = True
        self._server = socketserver.ThreadingTCPServer(
            (self.bind, self.port), _Handler)
        self._server.state = _State()  # type: ignore[attr-defined]
        self._server.token = self.token  # type: ignore[attr-defined]
        self._server.serving = self.serving  # type: ignore[attr-defined]
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]    # port 0: bound now
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self._ready.set()

    def wait_ready(self, timeout: float = 10.0):
        self._ready.wait(timeout)

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
