"""Serving front end over the coordinator line protocol (counterpart of
``hetu_tpu/serving/server.py``).

The serving plane rides the coordinator's newline-delimited command
protocol (``rpc/py_server.py``) instead of a second server: SUBMIT /
RESULT / GENERATE carry URL-quoted compact JSON payloads, one space-free
token each, and the stream mode of the same listener pushes each
request's tokens as the engine commits them (``rpc/stream.py``).

``ServingServer`` is the bundle: the engine's background loop plus a
coordinator with the engine attached. ``rpc/client.py``'s
``CoordinatorClient`` has the matching ``serving_*`` calls and
``generate_stream``.

The serving object is one engine or a fleet
:class:`~hetu_tpu_torch.serving.router.Router`: SUBMIT, RESULT and
GENERATE take either; FLEET, DRAIN, RESUME and FLEETMETRICS need a
Router; the engine verbs ESTATUS, CANCELQ, EVICT, PREFILL (the prefill
tier of a prefill/decode split), STOPENGINE and the fleet KV verbs
KVEXPORT, KVIMPORT, KVREPL, KVFETCH and KVBUDDY need an engine; DUMPOBS
(this process's observability bundle: the chrome trace of the global
tracer, the flight ring and the process identity, ``hetu_tpu``'s schema)
takes either. SWAPWEIGHTS needs the distributed checkpoint, which the
port does not have yet: it answers the one line ``ERR SWAPWEIGHTS not
ported``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from typing import Optional

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.serving.fleet import spill_from_wire, spill_to_wire
from hetu_tpu_torch.serving.scheduler import Request, SamplingParams


def encode_payload(obj: dict) -> str:
    """dict → one URL-quoted, space-free line-protocol token."""
    return urllib.parse.quote(
        json.dumps(obj, separators=(",", ":")), safe="")


def decode_payload(tok: str) -> dict:
    return json.loads(urllib.parse.unquote(tok))


def sampling_from_payload(p: dict) -> SamplingParams:
    return SamplingParams(
        temperature=float(p.get("temperature", 0.0)),
        top_k=int(p.get("top_k", 0)),
        top_p=float(p.get("top_p", 0.0)),
        eos_id=None if p.get("eos_id") is None else int(p["eos_id"]),
        max_tokens=int(p.get("max_tokens", 16)),
        priority=int(p.get("priority", 1)),
        tenant=p.get("tenant"),
        adapter=p.get("adapter"))


def submit_payload(engine, tok: str) -> Request:
    """SUBMIT handler: decode one request payload and queue it."""
    p = decode_payload(tok)
    return engine.submit(p["prompt"], sampling_from_payload(p))


class ServingServer:
    """Engine loop + coordinator in one lifecycle.

    The coordinator keeps its full role (RANK/KV/BARRIER for a training
    fleet); the serving verbs answer because an engine is attached — one
    process can coordinate training and serve. ``port=0`` binds a free
    port: :attr:`port` is the bound one after :meth:`start`.
    """

    def __init__(self, engine, port: int, bind: str = "127.0.0.1",
                 token: str = ""):
        from hetu_tpu_torch.rpc.py_server import PyCoordinatorServer
        self.engine = engine
        self.coordinator = PyCoordinatorServer(port, bind=bind,
                                               token=token,
                                               serving=engine)

    @property
    def port(self) -> int:
        return self.coordinator.port

    def start(self) -> None:
        self.engine.start()
        self.coordinator.start()

    def wait_ready(self, timeout: float = 10.0) -> None:
        self.coordinator.wait_ready(timeout)

    def stop(self) -> None:
        self.coordinator.stop()
        self.engine.stop()


#: SUBMITted-but-never-polled requests must not leak in a long-running
#: server: beyond this many live entries, FINISHED requests are evicted
#: oldest-first (in-flight ones are always kept — their slots are real)
_REQUEST_MAP_CAP = 4096


def _prune_request_map(m: dict) -> None:
    if len(m) <= _REQUEST_MAP_CAP:
        return
    for rid in [rid for rid, r in m.items()
                if r.done.is_set()][:len(m) - _REQUEST_MAP_CAP]:
        m.pop(rid, None)


#: the serving verbs the coordinator forwards here (``hetu_tpu``'s tuple:
#: SUBMIT/RESULT/GENERATE, the router's FLEET/DRAIN/RESUME, the engine
#: verbs ESTATUS..STOPENGINE, the observability verbs DUMPOBS and
#: FLEETMETRICS, and the fleet KV verbs). ``rpc/py_server.py`` mirrors
#: this tuple.
SERVING_COMMANDS = ("SUBMIT", "RESULT", "GENERATE",
                    "FLEET", "DRAIN", "RESUME",
                    "ESTATUS", "CANCELQ", "EVICT", "PREFILL",
                    "SWAPWEIGHTS", "STOPENGINE",
                    "DUMPOBS", "FLEETMETRICS",
                    "KVEXPORT", "KVIMPORT", "KVREPL", "KVFETCH",
                    "KVBUDDY")

#: the verbs whose modules the port does not have yet (SWAPWEIGHTS: the
#: distributed checkpoint)
NOT_PORTED = ("SWAPWEIGHTS",)


_idem_init_lock = threading.Lock()

#: dedup-window TTL: a finished entry older than this can no longer be
#: a retry-after-timeout join (clients give up in seconds) — evicting
#: it bounds a long soak's memory instead of growing forever
_IDEM_TTL_S = 900.0


class IdemMap:
    """Bounded idempotency-key → request map with TTL + LRU eviction.

    SUBMIT/GENERATE/STREAM payloads carry an ``idem`` key; a duplicate
    delivery — the client retrying after a response timeout, or two
    front ends racing one logical request — joins the ORIGINAL request
    instead of queueing a second generation. Every hit refreshes
    recency, FINISHED entries expire after ``ttl_s`` (the dedup window a
    retry could still arrive in), and past ``max_entries`` the
    least-recently-used entry goes — done entries first, in-flight ones
    only when nothing else is left. Evictions are counted
    (``serving_idem_evictions_total``). ``lock`` makes check-and-insert
    atomic across the coordinator's handler threads; callers hold it
    around get/put."""

    def __init__(self, max_entries: int = _REQUEST_MAP_CAP,
                 ttl_s: float = _IDEM_TTL_S):
        self.lock = threading.Lock()
        self.max_entries = int(max_entries)
        self.ttl_s = float(ttl_s)
        self._m: "dict[str, list]" = {}    # key -> [req, deadline]

    def __len__(self) -> int:
        return len(self._m)

    @staticmethod
    def _count_evict(reason: str, n: int = 1) -> None:
        if not n:
            return
        telemetry.get_registry().counter(
            "serving_idem_evictions_total",
            "idempotency-map entries evicted (ttl: dedup window "
            "expired; cap: LRU past max_entries)").inc(n, reason=reason)

    def get(self, key: str, now: Optional[float] = None):
        ent = self._m.get(key)
        if ent is None:
            return None
        now = time.monotonic() if now is None else now
        ent[1] = now + self.ttl_s
        # refresh recency: re-insert at the back of the dict's
        # insertion order (the LRU order the cap eviction walks)
        self._m[key] = self._m.pop(key)
        return ent[0]

    def put(self, key: str, req, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._m.pop(key, None)
        self._m[key] = [req, now + self.ttl_s]
        self.prune(now)

    def prune(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        stale = [k for k, (r, dl) in self._m.items()
                 if dl <= now and r.done.is_set()]
        for k in stale:
            del self._m[k]
        self._count_evict("ttl", len(stale))
        dropped = 0
        while len(self._m) > self.max_entries:
            victim = next((k for k, (r, _dl) in self._m.items()
                           if r.done.is_set()), None)
            if victim is None:
                victim = next(iter(self._m))
            del self._m[victim]
            dropped += 1
        self._count_evict("cap", dropped)


def _idem_map(engine) -> IdemMap:
    """Per-server :class:`IdemMap` (attached to the engine the
    coordinator serves)."""
    m = getattr(engine, "_idem_requests", None)
    if m is None:
        with _idem_init_lock:
            m = getattr(engine, "_idem_requests", None)
            if m is None:
                m = IdemMap()
                engine._idem_requests = m
    return m


def _count_dedup(verb: str) -> None:
    telemetry.get_registry().counter(
        "serving_idem_dedup_total",
        "duplicate SUBMIT/GENERATE deliveries suppressed by "
        "idempotency key (client retry-after-timeout joined the "
        "original request)").inc(verb=verb)


def _submit_from_payload(engine, p: dict):
    """Decode one SUBMIT/GENERATE payload and queue it; a wire-format KV
    spill (``resume``) rides along for a cross-process resume."""
    kw = {}
    if p.get("resume") is not None:
        kw["resume"] = spill_from_wire(p["resume"])
    if p.get("traceparent"):
        kw["traceparent"] = p["traceparent"]
    return engine.submit(p["prompt"], sampling_from_payload(p), **kw)


def _submit_with_idem(engine, p: dict, verb: str):
    """The one idempotency-keyed submit path SUBMIT / GENERATE / the
    stream frames all share: an ``idem``-keyed duplicate delivery joins
    the original request, everything else queues fresh."""
    key = p.get("idem")
    if not key:
        return _submit_from_payload(engine, p)
    m = _idem_map(engine)
    with m.lock:                        # atomic check-and-queue
        req = m.get(key)
        if req is not None:
            _count_dedup(verb)
            return req
        req = _submit_from_payload(engine, p)
        if req.status != "rejected":
            m.put(key, req)
    return req


def handle_stream_submit(serving, payload: str):
    """The ``stream`` frame's submit half (SUBMIT semantics — same
    payload format, idempotency key and traceparent included).
    Returns ``(request, None)`` or ``(None, "ERR ...")``; the caller
    (``py_server._stream_submit``) acks and subscribes."""
    try:
        p = decode_payload(payload)
        req = _submit_with_idem(serving, p, "STREAM")
    except Exception as e:                            # noqa: BLE001
        return None, f"ERR {type(e).__name__}: {e}"
    if req.status == "rejected":
        return None, f"ERR rejected: {req.error}"
    serving._requests_by_id[req.id] = req
    _prune_request_map(serving._requests_by_id)
    return req, None


def handle_serving_command(engine, cmd: str, args: list) -> Optional[str]:
    """Dispatch one serving line-protocol command; None = not ours.

    A failure inside a verb answers ``ERR <type>: <message>`` for that
    request, as ``hetu_tpu`` does; it never takes the server down."""
    if cmd not in SERVING_COMMANDS:
        return None
    if engine is None:
        return "ERR serving disabled"
    if cmd in NOT_PORTED:
        return f"ERR {cmd} not ported"
    if cmd in ("FLEET", "DRAIN", "RESUME", "FLEETMETRICS"):
        if not hasattr(engine, "fleet_status"):
            return "ERR not a fleet (attach a serving.router.Router)"
        try:
            if cmd == "FLEET":
                return f"VAL {encode_payload(engine.fleet_status())}"
            if cmd == "FLEETMETRICS":
                # federated Prometheus text (replica-labeled, plus the
                # _fleet aggregates), URL-quoted like METRICS/HEALTHZ
                return "VAL " + urllib.parse.quote(
                    engine.fleet_metrics_text(), safe="")
            if cmd == "DRAIN":
                n = engine.drain(args[0])
                return f"VAL {encode_payload({'requeued': n})}"
            engine.resume(args[0])
            return "OK"
        except Exception as e:                    # noqa: BLE001
            return f"ERR {type(e).__name__}: {e}"
    try:
        if cmd == "SUBMIT":
            p = decode_payload(args[0])
            req = _submit_with_idem(engine, p, "SUBMIT")
            if req.status == "rejected":
                return f"ERR rejected: {req.error}"
            engine._requests_by_id[req.id] = req
            _prune_request_map(engine._requests_by_id)
            # id + trace_id; the trailing R acknowledges an accepted KV
            # resume
            tail = " R" if p.get("resume") is not None \
                and req.spill is not None else ""
            return f"ID {req.id} {req.trace_id}{tail}"
        if cmd == "RESULT":
            req = engine._requests_by_id.get(int(args[0]))
            if req is None:
                return "ERR unknown request id"
            timeout_ms = int(args[1]) if len(args) > 1 else 0
            r = engine.result(req, timeout=timeout_ms / 1e3)
            if r is None:
                return "PEND"
            engine._requests_by_id.pop(req.id, None)
            return f"VAL {encode_payload(r)}"
        if cmd == "GENERATE":
            # blocking submit + wait (the engine loop must be running —
            # ServingServer.start does that)
            p = decode_payload(args[0])
            req = _submit_with_idem(engine, p, "GENERATE")
            r = req.result() if req.status == "rejected" \
                else engine.result(req, timeout=None)
            return f"VAL {encode_payload(r)}"
        return _handle_engine_command(engine, cmd, args)
    except Exception as e:                        # noqa: BLE001
        return f"ERR {type(e).__name__}: {e}"


def _handle_engine_command(engine, cmd: str, args: list) -> str:
    """The engine-process verbs (ESTATUS, CANCELQ, EVICT, PREFILL,
    STOPENGINE, the fleet KV verbs) and DUMPOBS. A Router front door
    answers ESTATUS with what it has and refuses the engine-only verbs."""
    if cmd == "ESTATUS":
        sched = getattr(engine, "scheduler", None)
        doc = {"load": getattr(engine, "load", 0),
               "weight_version": getattr(engine, "weight_version", 0),
               "has_work": engine.has_work()
               if hasattr(engine, "has_work") else False,
               # wall-clock stamp mid-RTT: the caller's offset handshake
               "ts_unix": round(time.time(), 6),
               "depth": getattr(sched, "depth", 0) if sched else 0,
               "occupancy": round(getattr(sched, "occupancy", 0.0), 4)
               if sched else 0.0,
               # the router's prefix directory hashes whole-block prefixes
               # at this replica's block size
               "block_size": int(getattr(getattr(engine, "pool", None),
                                         "block_size", 0) or 0)}
        return f"VAL {encode_payload(doc)}"
    if cmd == "DUMPOBS":
        # this process's observability bundle: the local chrome trace,
        # the flight ring and the process identity
        rec = telemetry.get_flight_recorder()
        tracer = telemetry.get_tracer()
        doc = {"pid": os.getpid(), "ts_unix": round(time.time(), 6),
               "rank": rec.rank, "replica": rec.replica,
               "role": rec.role,
               "epoch_unix": round(tracer.epoch_unix, 6),
               "chrome": tracer.to_chrome(),
               "flight": rec.events()}
        return f"VAL {encode_payload(doc)}"
    if cmd == "STOPENGINE":
        engine.stop()
        return "OK"
    if cmd == "CANCELQ":
        if not hasattr(engine, "cancel_queued"):
            return "ERR not an engine"
        p = decode_payload(args[0])
        moved = engine.cancel_queued({int(i) for i in p["ids"]})
        out = []
        for r in moved:
            engine._requests_by_id.pop(r.id, None)
            out.append({"id": r.id,
                        "spill": spill_to_wire(r.spill)
                        if r.spill is not None else None})
        return f"VAL {encode_payload({'cancelled': out})}"
    if cmd == "EVICT":
        p = decode_payload(args[0])
        req = engine._requests_by_id.get(int(p["id"]))
        if req is None:
            return "ERR unknown request id"
        if p.get("traceparent") and req.traceparent is None:
            req.traceparent = p["traceparent"]
        entry = engine.evict_request(
            req, lock_timeout_s=p.get("lock_timeout_s"))
        if req.status == "evicted":
            engine._requests_by_id.pop(req.id, None)
        doc = {"status": req.status,
               "spill": spill_to_wire(entry) if entry is not None else None}
        return f"VAL {encode_payload(doc)}"
    if cmd == "PREFILL":
        if not hasattr(engine, "prefill_only"):
            return "ERR not an engine"
        p = decode_payload(args[0])
        req, entry = engine.prefill_only(p["prompt"],
                                         sampling_from_payload(p),
                                         traceparent=p.get("traceparent"))
        if req.status == "rejected":
            return f"ERR rejected: {req.error}"
        if entry is None:
            doc = {"done": True, "id": req.id, "trace_id": req.trace_id,
                   "result": req.result()}
        else:
            doc = {"done": False, "id": req.id, "trace_id": req.trace_id,
                   "tokens": [int(t) for t in req.tokens],
                   "weight_version": req.weight_version,
                   "spill": spill_to_wire(entry)}
        return f"VAL {encode_payload(doc)}"
    if cmd == "KVEXPORT":
        if not hasattr(engine, "export_prefix"):
            return "ERR not an engine"
        entry = engine.export_prefix(decode_payload(args[0])["tokens"])
        doc = {"spill": spill_to_wire(entry) if entry is not None else None}
        return f"VAL {encode_payload(doc)}"
    if cmd == "KVIMPORT":
        if not hasattr(engine, "import_prefix"):
            return "ERR not an engine"
        p = decode_payload(args[0])
        ok = engine.import_prefix(spill_from_wire(p["spill"]))
        return f"VAL {encode_payload({'ok': bool(ok)})}"
    if cmd in ("KVREPL", "KVFETCH"):
        store = getattr(engine, "kv_replica_store", None)
        if store is None:
            return "ERR no replica store"
        p = decode_payload(args[0])
        if cmd == "KVREPL":
            store.put(p)
            return "OK"
        entry = store.fetch(p["trace_id"])
        doc = {"spill": spill_to_wire(entry) if entry is not None else None}
        return f"VAL {encode_payload(doc)}"
    if cmd == "KVBUDDY":
        if not hasattr(engine, "configure_replication"):
            return "ERR not an engine"
        p = decode_payload(args[0])
        if not p.get("host"):
            engine.configure_replication(None)
            return "OK"
        engine.configure_replication(
            _kv_put_sink(p), origin=p.get("origin", ""),
            cadence_s=float(p.get("cadence_s", 0.02)))
        return "OK"
    return "ERR unknown command"


def _kv_put_sink(p: dict):
    """The KVBUDDY replication sink: each shipment goes to the buddy's
    front door as KVREPL, over a connection the replication thread opens
    on its first shipment and drops on any failure (the next cadence
    reconnects)."""
    from hetu_tpu_torch.rpc.client import CoordinatorClient
    from hetu_tpu_torch.serving.fleet import repl_doc_to_wire
    box: dict = {}

    def sink(doc):
        cli = box.get("cli")
        if cli is None:
            cli = CoordinatorClient(int(p["port"]), host=p["host"],
                                    token=p.get("token") or None,
                                    timeout=5.0, retries=1)
            box["cli"] = cli
        try:
            cli.serving_kv_put(repl_doc_to_wire(doc))
        except Exception:
            box.pop("cli", None)
            try:
                cli.close()
            except OSError:
                pass
            raise
    return sink
