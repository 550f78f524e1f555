"""Coordinator client, line protocol over TCP (a copy of
``hetu_tpu/rpc/client.py``): the training plane's RANK/KV/BARRIER/BEAT
verbs and the serving plane's SUBMIT/RESULT/GENERATE, the push stream
(``generate_stream``) and the engine verbs. The fleet verbs are kept
whole; a server without a fleet answers them with an error line.
"""

from __future__ import annotations

import json
import os
import random
import socket
import time
import urllib.parse
import uuid
from typing import Any, Optional


def _rpc_registry():
    """The process-global metric registry, lazily imported: this module
    must stay importable without the rest of the framework, and the
    disabled-registry fast path keeps the per-verb cost near zero."""
    from hetu_tpu_torch import telemetry
    return telemetry.get_registry()


def _rpc_observe(verb: str, dur_ms: float, tx: int, rx: int) -> None:
    """Client-end wire instrumentation: per-verb latency +
    payload bytes. ``dir`` uses tx/rx on the client (the server uses
    in/out), so a test process hosting both ends keeps the series
    distinct."""
    reg = _rpc_registry()
    reg.histogram(
        "rpc_client_verb_ms",
        "client-side wall ms per line-protocol verb (send + reply, "
        "including retries and backoff)").observe(dur_ms, verb=verb)
    c = reg.counter(
        "rpc_payload_bytes_total",
        "line-protocol bytes by verb and direction (client: tx/rx, "
        "server: in/out)")
    c.inc(tx, verb=verb, dir="tx")
    c.inc(rx, verb=verb, dir="rx")


class CoordinatorClient:
    """Line-protocol client.

    The serving-plane verbs carry ``retries`` + jittered exponential
    backoff (reconnect between attempts) instead of blocking forever on
    a dead replica socket: the socket ``timeout`` bounds every recv and
    a connection failure reconnects and retries. SUBMIT/GENERATE carry
    an IDEMPOTENCY KEY the server dedups on, so even a response timeout
    retries safely (a duplicate delivery joins the original request);
    only verbs whose effect has no key stay at most once
    (DRAIN/EVICT/SWAPWEIGHTS: one delivery attempt).
    Training-plane verbs (RANK/KV/BARRIER) keep their original
    semantics — BARRIER is *supposed* to block.
    """

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout: float = 30.0,
                 token: Optional[str] = None,
                 retries: int = 2, backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0):
        self._host, self._port, self._timeout = host, port, timeout
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        self._backoff_max_s = float(backoff_max_s)
        # auth-enabled coordinators require AUTH first on every
        # connection; workers inherit the pool's token via env
        self._token = token if token is not None \
            else os.environ.get("HETU_COORD_TOKEN")
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout)
        self._buf = b""
        if self._token:
            resp = self._cmd(f"AUTH {self._token}")
            if resp != "OK":
                raise ConnectionError(f"coordinator auth failed: {resp}")

    def _reconnect(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._connect()

    def _cmd(self, line: str) -> str:
        self._sock.sendall(line.encode() + b"\n")
        while b"\n" not in self._buf:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise ConnectionError("coordinator closed connection")
            self._buf += chunk
        resp, self._buf = self._buf.split(b"\n", 1)
        return resp.decode()

    def _drop_sock(self) -> None:
        """Close and forget the connection. Mandatory on any failed
        command whose response may still arrive: a late response left
        in the socket would be read as the NEXT command's reply and
        desync every call after it — the next verb reconnects clean."""
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None
        self._buf = b""

    def _cmd_retry(self, line: str, *, idempotent: bool = True) -> str:
        """``_cmd`` with bounded retries + jittered exponential backoff.

        At-most-once for non-idempotent verbs (SUBMIT/GENERATE): once
        the command has been handed to a socket, ANY failure — timeout,
        reset, close — may mean it was already delivered and processed,
        so only failures during connection establishment (nothing sent
        yet) are retried. Idempotent verbs retry through a fresh socket
        regardless. Every raise path drops the connection so a late
        response can never poison the next command."""
        verb = line.split(" ", 1)[0]
        t0 = time.perf_counter()
        attempt = 0
        while True:
            sent = False
            try:
                if self._sock is None:       # prior reconnect failed
                    self._connect()
                sent = True        # past here the line may be delivered
                resp = self._cmd(line)
                _rpc_observe(verb,
                             (time.perf_counter() - t0) * 1e3,
                             tx=len(line) + 1, rx=len(resp) + 1)
                return resp
            except (TimeoutError, ConnectionError, OSError):
                attempt += 1
                if attempt > self._retries \
                        or (sent and not idempotent):
                    self._drop_sock()
                    raise
                _rpc_registry().counter(
                    "rpc_retries_total",
                    "line-protocol retry attempts by verb (transport "
                    "failures that reconnected and retried)").inc(
                    verb=verb)
                delay = min(self._backoff_max_s,
                            self._backoff_s * (2 ** (attempt - 1)))
                time.sleep(delay * (0.5 + random.random()))  # jitter
                try:
                    self._reconnect()
                except OSError:
                    # burn this attempt; the next loop turn re-tries
                    # the connect itself (bounded by the same budget)
                    self._sock = None

    # -- rank / membership --------------------------------------------------
    def rank(self, name: str) -> int:
        resp = self._cmd(f"RANK {name}")
        return int(resp.split()[1])

    def heartbeat(self, name: str):
        assert self._cmd(f"BEAT {name}") == "OK"

    def status(self, timeout_ms: int = 5000) -> tuple[list[str], list[str]]:
        resp = self._cmd(f"STATUS {timeout_ms}")
        # "ALIVE a,b DEAD c"
        parts = resp.split()
        alive = parts[1].split(",") if len(parts) > 1 and parts[1] else []
        dead_idx = parts.index("DEAD")
        dead = parts[dead_idx + 1].split(",") \
            if len(parts) > dead_idx + 1 and parts[dead_idx + 1] else []
        return [a for a in alive if a], [d for d in dead if d]

    # -- KV (typed, like the reference's double/int/string/json) ------------
    def put(self, key: str, value: Any):
        enc = urllib.parse.quote(json.dumps(value), safe="")
        assert self._cmd(f"SET {key} {enc}") == "OK"

    def get(self, key: str, default: Any = None) -> Any:
        resp = self._cmd(f"GET {key}")
        if resp == "NONE":
            return default
        return json.loads(urllib.parse.unquote(resp.split(" ", 1)[1]))

    # -- synchronization ----------------------------------------------------
    def barrier(self, name: str, n: int, who: str):
        """Blocks until ``n`` distinct participants arrive."""
        assert self._cmd(f"BARRIER {name} {n} {who}") == "OK"

    # -- serving plane (hetu_tpu/serving — coordinator with an engine) ------
    def _serving_payload(self, prompt, **sampling) -> str:
        obj = {"prompt": [int(t) for t in prompt],
               **{k: v for k, v in sampling.items() if v is not None}}
        return urllib.parse.quote(
            json.dumps(obj, separators=(",", ":")), safe="")

    def serving_submit(self, prompt, *, idem_key: Optional[str] = None,
                       **sampling) -> int:
        """Queue a generation request; returns its id (FCFS).

        Every submit carries an IDEMPOTENCY KEY (auto-generated unless
        ``idem_key`` names one): the server dedups by key, so a
        response timeout is now safely retried — a duplicate delivery
        returns the ORIGINAL request's id instead of queueing a second
        generation."""
        return int(self.serving_submit_info(
            prompt, idem_key=idem_key, **sampling)["id"])

    def serving_submit_info(self, prompt, *,
                            idem_key: Optional[str] = None,
                            resume: Optional[dict] = None,
                            traceparent: Optional[str] = None,
                            **sampling) -> dict:
        """:meth:`serving_submit` returning the full handshake:
        ``{"id", "trace_id", "resumed"}``. ``resume`` attaches a
        wire-format KV spill (``serving.server.spill_to_wire``) — the
        fleet proxy's resumable requeue; ``resumed`` reports whether
        the engine accepted it (layout + weight version compatible).
        ``traceparent`` propagates the caller's trace context so the
        remote request joins the caller's trace."""
        payload = dict(sampling)
        payload["idem"] = idem_key or uuid.uuid4().hex
        if resume is not None:
            payload["resume"] = resume
        if traceparent:
            payload["traceparent"] = traceparent
        resp = self._cmd_retry(
            f"SUBMIT {self._serving_payload(prompt, **payload)}")
        if not resp.startswith("ID "):
            raise RuntimeError(f"serving submit failed: {resp}")
        parts = resp.split()
        return {"id": int(parts[1]),
                "trace_id": parts[2] if len(parts) > 2 else "",
                "resumed": len(parts) > 3 and parts[3] == "R"}

    def serving_result(self, req_id: int,
                       timeout_ms: int = 0) -> Optional[dict]:
        """Poll a queued request: dict result, or None while pending.
        Safe to retry (and retried) across timeouts — polling twice is
        harmless."""
        resp = self._cmd_retry(f"RESULT {req_id} {timeout_ms}")
        if resp == "PEND":
            return None
        if not resp.startswith("VAL "):
            raise RuntimeError(f"serving result failed: {resp}")
        return json.loads(urllib.parse.unquote(resp.split(" ", 1)[1]))

    def serving_generate(self, prompt, *,
                         idem_key: Optional[str] = None,
                         traceparent: Optional[str] = None,
                         **sampling) -> dict:
        """Blocking generate over the line protocol (engine loop must
        be running server-side, e.g. ``ServingServer.start()``).
        Idempotency-keyed like :meth:`serving_submit`: a retried
        delivery joins the original request instead of generating
        twice."""
        payload = dict(sampling)
        payload["idem"] = idem_key or uuid.uuid4().hex
        if traceparent:
            payload["traceparent"] = traceparent
        resp = self._cmd_retry(
            f"GENERATE {self._serving_payload(prompt, **payload)}")
        if not resp.startswith("VAL "):
            raise RuntimeError(f"serving generate failed: {resp}")
        return json.loads(urllib.parse.unquote(resp.split(" ", 1)[1]))

    # -- streaming ------------------------------------------------------------
    def _stream_channel(self):
        """This client's persistent multiplexed channel (lazy,
        recreated after a loss)."""
        ch = getattr(self, "_stream", None)
        if ch is not None and ch.alive:
            return ch
        from hetu_tpu_torch.rpc.stream import StreamChannel
        ch = StreamChannel(self._port, host=self._host,
                           token=self._token or "",
                           connect_timeout=self._timeout)
        self._stream = ch
        return ch

    @staticmethod
    def _count_stream_fallback(reason: str) -> None:
        try:
            from hetu_tpu_torch.serving.streaming import count_fallback
            count_fallback(reason)
        except Exception:                             # noqa: BLE001
            pass

    def generate_stream(self, prompt, *,
                        idem_key: Optional[str] = None,
                        traceparent: Optional[str] = None,
                        event_timeout_s: float = 60.0,
                        max_reconnects: int = 3,
                        **sampling):
        """Streaming generate: yields event dicts ``{"tokens":
        [newly committed ids], "first": bool, "done": bool}`` as the
        engine commits them; the final event adds ``"result"`` — the
        full result with the trailing timing payload, byte-identical
        to what :meth:`serving_generate` returns for the same request.

        Rides the persistent multiplexed channel end to end (router →
        engine → here). Self-healing: a dead socket reconnects and
        resubscribes at the token offset already received (the
        idempotency key re-joins the original request even when the
        loss predates the ack), and after ``max_reconnects`` losses —
        or a server-side drop — the tail degrades to RESULT polling,
        loudly counted. Every path yields each token exactly once."""
        payload = dict(sampling)
        payload["idem"] = idem_key or uuid.uuid4().hex
        if traceparent:
            payload["traceparent"] = traceparent
        received: list[int] = []
        req_id: Optional[int] = None
        reconnects = 0
        while reconnects <= max_reconnects:
            import queue as _queue
            q: "_queue.Queue" = _queue.Queue()
            try:
                ch = self._stream_channel()
                if req_id is None:
                    ack = ch.stream_submit(
                        self._serving_payload(prompt, **payload),
                        sink=q.put, offset=len(received))
                    req_id = int(ack["id"])
                else:
                    ch.subscribe(req_id, offset=len(received),
                                 sink=q.put)
            except RuntimeError:
                raise                  # admission rejection: terminal
            except Exception:                         # noqa: BLE001
                reconnects += 1
                continue
            degrade = False
            while not degrade:
                try:
                    fr = q.get(timeout=event_timeout_s)
                except _queue.Empty:
                    degrade = True     # silent stream: stop trusting it
                    break
                kind = fr.get("k")
                if kind == "ev":
                    off = int(fr.get("off", 0))
                    toks = [int(t) for t in fr.get("toks", [])]
                    skip = len(received) - off
                    if skip < 0:       # lost frame — never guess
                        degrade = True
                        break
                    if skip:
                        toks = toks[skip:]
                    received.extend(toks)
                    out = {"tokens": toks,
                           "first": bool(fr.get("first")),
                           "done": bool(fr.get("done"))}
                    if fr.get("done"):
                        out["result"] = fr.get("result")
                        yield out
                        return
                    if fr.get("end"):
                        degrade = True     # evicted/cancelled: poll
                        break              # the router for the retry
                    if toks:
                        yield out
                elif kind == "lost":
                    reconnects += 1
                    break              # reconnect + resubscribe-at-
                #                        offset on a fresh channel
                else:                  # drop / err: server said stop
                    degrade = True
                    break
            if degrade:
                break
        # -- loud fallback: the RESULT poll lane finishes the request --
        self._count_stream_fallback("client_poll")
        if req_id is None:
            # the loss predates the ack — the idempotency key makes
            # this re-delivery join the original request if it landed
            doc = self.serving_generate(prompt,
                                        idem_key=payload["idem"],
                                        traceparent=traceparent,
                                        **sampling)
        else:
            doc = None
            while doc is None:
                doc = self.serving_result(req_id, timeout_ms=500)
        tail = [int(t) for t in doc.get("tokens", [])][len(received):]
        received.extend(tail)
        yield {"tokens": tail, "first": False, "done": True,
               "result": doc}

    # -- engine verbs (one engine process behind the server) -----------------
    def _val_verb(self, line: str, *, idempotent: bool = True) -> dict:
        resp = self._cmd_retry(line, idempotent=idempotent)
        if not resp.startswith("VAL "):
            raise RuntimeError(f"{line.split()[0]} failed: {resp}")
        return json.loads(urllib.parse.unquote(resp.split(" ", 1)[1]))

    def serving_estatus(self) -> dict:
        """Light engine-status poll (load / queue depth / occupancy /
        weight version / has_work) — the remote replica handle's
        heartbeat-cum-load signal."""
        return self._val_verb("ESTATUS")

    def serving_cancel_queued(self, ids) -> dict:
        """Pull queued (not yet admitted) requests off the remote
        engine — the router's drain leg. Returns
        ``{"cancelled": [{"id", "spill"}]}`` with wire-format spills
        for requests that carried KV."""
        enc = urllib.parse.quote(json.dumps(
            {"ids": [int(i) for i in ids]},
            separators=(",", ":")), safe="")
        return self._val_verb(f"CANCELQ {enc}", idempotent=False)

    def serving_evict(self, req_id: int,
                      lock_timeout_s: Optional[float] = None,
                      traceparent: Optional[str] = None) -> dict:
        """Force one request out of the remote engine, salvaging its
        resident KV: ``{"status", "spill": wire | None}``.
        ``traceparent`` stamps the salvaged spill with the fleet trace
        context when the remote request predates it."""
        obj = {"id": int(req_id), "lock_timeout_s": lock_timeout_s}
        if traceparent:
            obj["traceparent"] = traceparent
        enc = urllib.parse.quote(json.dumps(
            obj, separators=(",", ":")), safe="")
        return self._val_verb(f"EVICT {enc}", idempotent=False)

    def serving_prefill(self, prompt, *,
                        traceparent: Optional[str] = None,
                        **sampling) -> dict:
        """Prefill-tier verb: admission + prefill on the remote engine,
        blocking until the KV is ready. Returns ``{"done": True,
        "result": ...}`` for requests that finished within their first
        token, else ``{"done": False, "id", "tokens", "spill": wire}``
        — the KV-block payload a decode replica resumes from."""
        if traceparent:
            sampling["traceparent"] = traceparent
        resp = self._cmd_retry(
            f"PREFILL {self._serving_payload(prompt, **sampling)}",
            idempotent=False)
        if not resp.startswith("VAL "):
            raise RuntimeError(f"serving prefill failed: {resp}")
        return json.loads(urllib.parse.unquote(resp.split(" ", 1)[1]))

    def serving_swap_weights(self, path: str, version: int,
                             traceparent: Optional[str] = None) -> dict:
        """Remote leg of a dist-checkpoint weight push: the engine
        process loads ``path`` onto its own topology and swaps. NOT
        retried on timeout — the load may already be in flight.
        ``traceparent`` lets the push's trace context travel with the
        swap so remote flight events correlate with it."""
        obj = {"path": path, "version": int(version)}
        if traceparent:
            obj["traceparent"] = traceparent
        enc = urllib.parse.quote(json.dumps(
            obj, separators=(",", ":")), safe="")
        return self._val_verb(f"SWAPWEIGHTS {enc}", idempotent=False)

    def serving_stop_engine(self) -> None:
        resp = self._cmd_retry("STOPENGINE", idempotent=False)
        if resp != "OK":
            raise RuntimeError(f"stop engine failed: {resp}")

    # -- fleet-global KV verbs ------------------------------------------------
    def serving_kv_export(self, tokens) -> dict:
        """Gather the remote replica's cached whole-block prefix of
        ``tokens``: ``{"spill": wire | None}``. Read-only (the prefix
        cache keeps its refs) — safe to retry."""
        enc = urllib.parse.quote(json.dumps(
            {"tokens": [int(t) for t in tokens]},
            separators=(",", ":")), safe="")
        return self._val_verb(f"KVEXPORT {enc}")

    def serving_kv_import(self, spill_wire: dict) -> dict:
        """Map a peer-exported prefix into the remote replica's prefix
        cache: ``{"ok": bool}`` (False = refused — stale version or
        layout mismatch — the caller prefills instead). Idempotent by
        construction: re-importing an already-cached prefix is a
        no-op."""
        enc = urllib.parse.quote(json.dumps(
            {"spill": spill_wire}, separators=(",", ":")), safe="")
        return self._val_verb(f"KVIMPORT {enc}")

    def serving_kv_put(self, doc: dict) -> None:
        """Deliver one decode-KV replication shipment to the remote
        buddy's replica store. Idempotent: shipments overwrite by
        (trace_id, block index)."""
        enc = urllib.parse.quote(json.dumps(
            doc, separators=(",", ":")), safe="")
        resp = self._cmd_retry(f"KVREPL {enc}")
        if resp != "OK":
            raise RuntimeError(f"kv put failed: {resp}")

    def serving_kv_fetch(self, trace_id: str) -> dict:
        """Assemble the buddy-held replica set for ``trace_id``:
        ``{"spill": wire | None}`` — the recovery path's resume
        payload."""
        enc = urllib.parse.quote(json.dumps(
            {"trace_id": str(trace_id)},
            separators=(",", ":")), safe="")
        return self._val_verb(f"KVFETCH {enc}")

    def serving_kv_buddy(self, host: Optional[str], port: int = 0, *,
                         token: Optional[str] = None, origin: str = "",
                         cadence_s: float = 0.02) -> None:
        """Point the remote engine's replication stream at a buddy
        replica (``host=None`` disables replication)."""
        obj = {"host": host, "port": int(port), "origin": origin,
               "cadence_s": float(cadence_s)}
        if token:
            obj["token"] = token
        enc = urllib.parse.quote(json.dumps(
            obj, separators=(",", ":")), safe="")
        resp = self._cmd_retry(f"KVBUDDY {enc}")
        if resp != "OK":
            raise RuntimeError(f"kv buddy failed: {resp}")

    # -- fleet verbs (a coordinator serving a fleet router) -------------------
    def fleet_status(self) -> dict:
        """Fleet-wide aggregation: per-replica state/load/version,
        pending + requeue counters (``Router.fleet_status``)."""
        resp = self._cmd_retry("FLEET")
        if not resp.startswith("VAL "):
            raise RuntimeError(f"fleet status failed: {resp}")
        return json.loads(urllib.parse.unquote(resp.split(" ", 1)[1]))

    def fleet_drain(self, name: str) -> dict:
        """Drain one replica (requests re-dispatch to peers); returns
        ``{"requeued": n}``. NOT retried on timeout: drain blocks
        server-side until the replica runs dry."""
        resp = self._cmd_retry(f"DRAIN {name}", idempotent=False)
        if not resp.startswith("VAL "):
            raise RuntimeError(f"fleet drain failed: {resp}")
        return json.loads(urllib.parse.unquote(resp.split(" ", 1)[1]))

    def fleet_resume(self, name: str) -> None:
        resp = self._cmd_retry(f"RESUME {name}", idempotent=False)
        if resp != "OK":
            raise RuntimeError(f"fleet resume failed: {resp}")

    def fleet_metrics_text(self) -> str:
        """Federated Prometheus page from a Router front door: every
        replica's series labeled ``replica="<name>"`` plus
        pre-aggregated ``replica="_fleet"`` totals."""
        resp = self._cmd_retry("FLEETMETRICS")
        if not resp.startswith("VAL "):
            raise RuntimeError(f"fleet metrics failed: {resp}")
        return urllib.parse.unquote(resp.split(" ", 1)[1])

    def dump_obs(self) -> dict:
        """The serving process's observability bundle (chrome trace +
        flight ring + fleet identity) via the DUMPOBS verb."""
        resp = self._cmd_retry("DUMPOBS")
        if not resp.startswith("VAL "):
            raise RuntimeError(f"dump obs failed: {resp}")
        return json.loads(urllib.parse.unquote(resp.split(" ", 1)[1]))

    # -- live observability (HEALTHZ / METRICS verbs) -----------------------
    def healthz(self) -> dict:
        """Live health document: overall status, watchdog trips, SLO
        alerting state, serving queue/occupancy (telemetry.health_status
        evaluated on the coordinator process)."""
        resp = self._cmd_retry("HEALTHZ")
        if not resp.startswith("VAL "):
            raise RuntimeError(f"healthz failed: {resp}")
        return json.loads(urllib.parse.unquote(resp.split(" ", 1)[1]))

    def metrics_text(self) -> str:
        """Prometheus text exposition of the coordinator process's
        metric registry (scrape-through for a sidecar exporter)."""
        resp = self._cmd_retry("METRICS")
        if not resp.startswith("VAL "):
            raise RuntimeError(f"metrics failed: {resp}")
        return urllib.parse.unquote(resp.split(" ", 1)[1])

    def ping(self) -> bool:
        return self._cmd("PING") == "PONG"

    def shutdown(self):
        self._cmd("SHUTDOWN")

    def close(self):
        ch = getattr(self, "_stream", None)
        if ch is not None:
            try:
                ch.close()
            except Exception:                         # noqa: BLE001
                pass
            self._stream = None
        if self._sock is not None:
            self._sock.close()
