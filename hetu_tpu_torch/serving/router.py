"""The serving fleet: a router over N ``ServingEngine`` replicas, and the
live train→serve weight push (counterpart of ``hetu_tpu/serving/
router.py``).

- :class:`Router`: replica registration, heartbeat, drain, resume and
  death; load-aware dispatch (least loaded by the engine's queued +
  prefilling + decoding count, TTFT EWMA as the tiebreak) with adapter
  affinity, the fleet prefix directory and rendezvous prefix affinity,
  each honored only within ``affinity_slack`` of the least loaded;
  resumable requeue when a replica dies or drains (a mid-decode request
  carries its KV spill to a peer, or is recovered from its buddy's
  replicated KV); the prefill/decode handoff; fleet-wide prefix pulls;
  token streams that survive failovers; fleet status, metrics and health;
- :class:`WeightPublisher`: the trainer's push, drain → swap → resume one
  replica at a time, so the fleet never has zero live replicas.

Replicas are engines on threads of this process (the single-host shape of
``hetu_tpu``'s fleet: its suite and its rollout loop). Engine processes
behind ``RemoteEngineProxy`` are not ported yet, nor is the push's
distributed-checkpoint transport. Everything here is host-side control
plane: the replicas' captured lanes never see the router. Series, flight
events and request-track spans keep ``hetu_tpu``'s names
(``tools/fleet_trace.py`` and ``tools/check_metrics_docs.py`` read them).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
import uuid
from collections import deque
from typing import Mapping, Optional, Sequence, Union

import torch

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.serving.engine import ServingEngine
from hetu_tpu_torch.serving.scheduler import Request, SamplingParams
from hetu_tpu_torch.telemetry.flight import flight_record
from hetu_tpu_torch.telemetry.spans import request_track_tid


@dataclasses.dataclass
class RouterRequest:
    """One request's fleet-level lifecycle: dispatched to a replica,
    possibly re-dispatched after a replica's death or drain, finished
    exactly once. It has the engine ``Request``'s surface (``id``,
    ``status``, ``done``, ``result()``), so the line-protocol front end
    serves a Router and an engine through the same verbs."""

    id: int
    prompt: list
    sampling: SamplingParams
    submit_s: float
    status: str = "queued"       # queued|dispatched|done|rejected|failed
    replica: Optional[str] = None        # current / last assignment
    attempts: int = 0                    # dispatches (1 = never requeued)
    tokens: list = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    weight_version: Optional[int] = None
    finish_s: Optional[float] = None
    spill: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)  # SpillEntry salvaged
    #                                    from a dead or draining replica:
    #                                    it rides the next dispatch, so
    #                                    the peer resumes, not re-prefills
    resumed_dispatches: int = 0          # dispatches that carried KV
    trace_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:12])
    traceparent: Optional[str] = None    # inbound wire context: when set,
    #                                      trace_id matches it and every
    #                                      dispatch propagates it
    inner: Optional[Request] = dataclasses.field(
        default=None, repr=False, compare=False)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    def result(self) -> dict:
        timing: dict = {"trace_id": self.trace_id,
                        "attempts": self.attempts}
        if self.inner is not None:
            timing.update(self.inner.timing())
            timing["trace_id"] = self.trace_id   # the router's id wins
        if self.finish_s is not None:
            timing["router_total_ms"] = round(
                (self.finish_s - self.submit_s) * 1e3, 3)
        return {"id": self.id, "status": self.status,
                "tokens": list(self.tokens), "error": self.error,
                "replica": self.replica,
                "weight_version": self.weight_version,
                "timing": timing}


class _StreamBridge:
    """Joins one outward token subscription on a :class:`RouterRequest` to
    whatever inner request currently serves it.

    The bridge owns a global token cursor (``sub.sent``): every attach
    (the first dispatch, or a re-dispatch after a replica's death)
    replays the inner stream from that cursor and clips any overlap, so a
    subscriber across a failover sees each token exactly once, in order.
    Inner ``done``/``end`` markers are not forwarded: the terminal frame
    is the router's (:meth:`finalize`), with the router-level result."""

    def __init__(self, rreq: "RouterRequest", sub):
        self.rreq = rreq
        self.sub = sub
        self._detach_cb = None
        self._emlock = threading.Lock()

    @property
    def dead(self) -> bool:
        return self.sub.closed or self.sub.dropped

    def attach(self, h: "ReplicaHandle") -> None:
        """Feed the bridge from ``rreq.inner`` on ``h``: a subscription on
        the replica's engine drained by a forwarder thread. A failure
        degrades to the terminal frame alone (``finalize`` still delivers
        every token)."""
        self.detach()
        inner = self.rreq.inner
        if inner is None or self.dead:
            return
        try:
            isub = h.engine.stream_subscribe(inner, offset=self.sub.sent,
                                             max_queue=1024)
            stop = threading.Event()
            threading.Thread(
                target=self._forward, args=(isub, stop), daemon=True,
                name=f"stream-bridge-{self.rreq.id}").start()

            def _cb(isub=isub, stop=stop):
                stop.set()
                isub.close()
            self._detach_cb = _cb
        except Exception:                             # noqa: BLE001
            self._detach_cb = None

    def detach(self) -> None:
        cb, self._detach_cb = self._detach_cb, None
        if cb is not None:
            try:
                cb()
            except Exception:                         # noqa: BLE001
                pass

    def _forward(self, isub, stop: threading.Event) -> None:
        while not stop.is_set() and not self.dead:
            ev = isub.get(timeout=0.2)
            if ev is None:
                if isub.closed or isub.dropped:
                    return
                continue
            self._on_inner(ev)
            if ev.get("done") or ev.get("end"):
                return

    def _on_inner(self, ev: dict) -> None:
        """Forward one inner token delta, clipped at the global cursor.
        Inner offsets are global offsets: a KV-resumed inner request
        preloads the tokens generated before the failover."""
        if ev.get("k") not in (None, "ev"):
            return        # drop/lost frames: a reattach or finalize recovers
        toks = ev.get("toks") or []
        off = int(ev.get("off", 0))
        with self._emlock:
            skip = self.sub.sent - off
            if skip < 0 or skip >= len(toks):
                return     # a gap (wait for finalize) or a full overlap
            out_toks = [int(t) for t in toks[skip:]]
            out = {"req": self.rreq.id, "trace": self.rreq.trace_id,
                   "off": self.sub.sent, "toks": out_toks,
                   "first": self.sub.sent == 0, "done": False,
                   "ts": ev.get("ts", round(time.monotonic(), 6))}
            if self.sub.emit(out):
                self.sub.sent += len(out_toks)

    def finalize(self) -> None:
        """The terminal frame: the remaining delta and the router-level
        result."""
        self.detach()
        rreq = self.rreq
        with self._emlock:
            toks = [int(t) for t in rreq.tokens[self.sub.sent:]]
            ev = {"req": rreq.id, "trace": rreq.trace_id,
                  "off": self.sub.sent, "toks": toks,
                  "first": self.sub.sent == 0 and bool(toks),
                  "done": True, "result": rreq.result(),
                  "ts": round(time.monotonic(), 6)}
            self.sub.sent = len(rreq.tokens)
            self.sub.emit(ev)
            self.sub.close()


class FleetPrefixDirectory:
    """The router's map from whole-block prompt-prefix hashes to the
    replica whose radix prefix cache holds that prefix
    (``hetu_tpu/serving/router.py:238``).

    Entries are tagged ``(replica, weight_version)``: :meth:`flush_stale`
    drops a replica's entries at a weight push or its death, so the
    directory never routes a pull at KV prefilled under superseded
    weights (the engine's ``SpillEntry.compatible_with`` is the second
    line). Host bookkeeping only: hashes, never KV bytes, so a wrong
    entry costs one failed pull and a plain prefill, never a wrong token.

    One publish records every whole-block boundary of the prompt (k
    blocks for k = 1..nb), so a later prompt sharing only part of the
    prefix still finds its longest cached span. Capacity is a FIFO cap on
    the entries; re-publishing refreshes an entry's position."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = int(max_entries)
        #: hash(block_size, token prefix) -> (replica, weight_version,
        #: n_blocks, block_size); insertion order is the FIFO order
        self._entries: dict[str, tuple[str, int, int, int]] = {}
        self._block_sizes: set[int] = set()
        self.published_total = 0
        self.flushed_total = 0

    @staticmethod
    def _key(tokens: Sequence[int], n_tokens: int, block_size: int) -> str:
        h = hashlib.blake2b(digest_size=16)
        h.update(f"{block_size}|".encode())
        h.update(",".join(str(int(t)) for t in tokens[:n_tokens]).encode())
        return h.hexdigest()

    def __len__(self) -> int:
        return len(self._entries)

    def publish(self, replica: str, tokens: Sequence[int], *,
                block_size: int, weight_version: int) -> int:
        """Record that ``replica`` holds every whole-block prefix of
        ``tokens`` under ``weight_version``; returns the blocks recorded."""
        bs = int(block_size)
        nb = 0 if bs <= 0 else len(tokens) // bs
        if nb <= 0:
            return 0
        self._block_sizes.add(bs)
        for k in range(1, nb + 1):
            key = self._key(tokens, k * bs, bs)
            self._entries.pop(key, None)        # refresh the FIFO position
            self._entries[key] = (replica, int(weight_version), k, bs)
        self.published_total += nb
        while len(self._entries) > self.max_entries:
            self._entries.pop(next(iter(self._entries)))
        return nb

    def lookup(self, tokens: Sequence[int]
               ) -> Optional[tuple[str, int, int]]:
        """The longest known whole-block prefix of ``tokens`` →
        ``(replica, n_blocks, block_size)``, or None."""
        best: Optional[tuple[str, int, int]] = None
        for bs in self._block_sizes:
            for k in range(len(tokens) // bs, 0, -1):
                if best is not None and k * bs <= best[1] * best[2]:
                    break                # cannot beat the current best
                ent = self._entries.get(self._key(tokens, k * bs, bs))
                if ent is None:
                    continue
                best = (ent[0], k, bs)
                break
        return best

    def flush_stale(self, *, replica: Optional[str] = None,
                    below_version: Optional[int] = None) -> int:
        """Drop the entries of ``replica`` and/or those tagged below
        ``below_version``; returns how many went."""
        doomed = [k for k, (rep, ver, _nb, _bs) in self._entries.items()
                  if (replica is not None and rep == replica)
                  or (below_version is not None
                      and ver < int(below_version))]
        for k in doomed:
            self._entries.pop(k, None)
        self.flushed_total += len(doomed)
        return len(doomed)

    def drop_replica(self, replica: str) -> int:
        return self.flush_stale(replica=replica)


class ReplicaHandle:
    """The router's view of one registered replica."""

    def __init__(self, name: str, engine: ServingEngine):
        self.name = name
        self.engine = engine
        self.state = "live"          # live | draining | dead
        self.role = "both"           # both | prefill | decode
        self.registered_s = time.monotonic()
        self.last_beat: Optional[float] = None   # external heartbeats
        self.inflight: dict[int, RouterRequest] = {}   # inner id -> rreq
        self.dispatched = 0
        self.ttft_ewma_s: Optional[float] = None

    def loop_alive(self) -> bool:
        t = self.engine._thread
        return t is not None and t.is_alive()

    def loop_died(self) -> bool:
        """True only for a loop that ran and exited: a replica registered
        with ``start=False`` (its caller steps it) is not dead."""
        t = self.engine._thread
        return t is not None and not t.is_alive()

    @property
    def load(self) -> int:
        return self.engine.load

    @property
    def weight_version(self) -> int:
        return self.engine.weight_version

    def status(self) -> dict:
        return {"state": self.state, "role": self.role,
                "load": self.load,
                "queue_depth": self.engine.scheduler.depth,
                "occupancy": round(self.engine.scheduler.occupancy, 4),
                "loop_running": self.loop_alive(),
                "weight_version": self.weight_version,
                "dispatched": self.dispatched,
                "inflight": len(self.inflight),
                "ttft_ewma_ms": None if self.ttft_ewma_s is None
                else round(self.ttft_ewma_s * 1e3, 3)}


class Router:
    """Load-aware, prefix-sticky dispatch over registered replicas.

    A replica is a :class:`ServingEngine` whose background loop runs on a
    thread of this process. Its death is its loop thread's exit (or a
    stale heartbeat when its caller steps it); a monitor thread finalizes
    completions, hands prefilled requests from the prefill tier to the
    decode tier, requeues a dead replica's undelivered requests onto
    peers, keeps the buddies of decode-KV replication wired and the fleet
    gauges fresh.

    ``kv_pull`` consults the fleet prefix directory at dispatch and pulls
    a cached prefix onto the replica a request lands on;
    ``replicate_kv`` streams each decoding request's completed KV blocks
    to a rendezvous buddy every ``replicate_cadence_s``, so a killed
    replica's mid-decode requests resume from the buddy's copy when its
    arena cannot be read."""

    def __init__(self, *, affinity_tokens: int = 16,
                 affinity_slack: int = 2,
                 beat_timeout_s: float = 2.0,
                 max_attempts: int = 5,
                 poll_s: float = 0.002,
                 scrape_every_s: float = 1.0,
                 kv_pull: bool = True,
                 replicate_kv: bool = False,
                 replicate_cadence_s: float = 0.02,
                 directory_max_entries: int = 4096):
        self.affinity_tokens = int(affinity_tokens)
        #: a sticky pick (adapter, directory, rendezvous) is honored only
        #: while its load is within this many requests of the least
        #: loaded replica: past that, cache locality loses to balance
        self.affinity_slack = int(affinity_slack)
        self.beat_timeout_s = float(beat_timeout_s)
        self.max_attempts = int(max_attempts)
        self.poll_s = float(poll_s)
        self._replicas: dict[str, ReplicaHandle] = {}
        self._pending: deque[RouterRequest] = deque()
        self._lock = threading.RLock()
        self._next_id = 0
        self._requests_by_id: dict[int, RouterRequest] = {}  # the RPC poll
        self.requeues_total = 0
        self._monitor: Optional[threading.Thread] = None
        self._stop_ev: Optional[threading.Event] = None
        self.slo = None          # the HEALTHZ surface an engine has
        # metrics/health federation: snapshots of each replica's health on
        # this cadence, read by FLEETMETRICS and the fleet HEALTHZ
        self.scrape_every_s = float(scrape_every_s)
        self._fed_lock = threading.Lock()
        self._fed: dict[str, dict] = {}      # name -> {metrics, health}
        self._fed_ts = 0.0                   # monotonic of the last scrape
        # the fleet-global KV plane
        self.kv_pull = bool(kv_pull)
        self.replicate_kv = bool(replicate_kv)
        self.replicate_cadence_s = float(replicate_cadence_s)
        self._directory = FleetPrefixDirectory(directory_max_entries)
        self._buddy_of: dict[str, str] = {}  # origin -> buddy name
        # rreq id -> the bridges feeding its outward token subscriptions
        self._stream_bridges: dict[int, list[_StreamBridge]] = {}

    # -- replica lifecycle ----------------------------------------------------
    def register(self, name: str, engine: ServingEngine, *,
                 start: bool = True, role: str = "both") -> ReplicaHandle:
        """Add a replica (its engine's loop is started unless it runs or
        ``start=False``) and make sure the monitor runs.

        ``role`` is the prefill/decode tier: ``"both"`` (colocated),
        ``"prefill"`` (admission and prefill only: the finished KV goes to
        the decode tier) or ``"decode"``. Dispatch splits only while a
        live prefill replica and a live decode-capable one both exist."""
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both|prefill|decode, "
                             f"got {role!r}")
        if getattr(engine, "remote", False):
            raise ValueError(
                "remote replicas (engine processes behind a proxy) are "
                "not ported yet: register in-process ServingEngines")
        with self._lock:
            if name in self._replicas \
                    and self._replicas[name].state != "dead":
                raise ValueError(f"replica {name!r} already registered")
            if start:
                # start before the handle is visible: the monitor marks a
                # replica whose loop thread died as dead
                engine.start()
            h = ReplicaHandle(name, engine)
            h.role = role
            self._replicas[name] = h
        flight_record("router_replica", replica=name, state="live",
                      event="register", role=role)
        self.start()
        return h

    def heartbeat(self, name: str) -> None:
        with self._lock:
            self._replicas[name].last_beat = time.monotonic()

    def drain(self, name: str, *, timeout_s: float = 30.0,
              preempt: bool = False) -> int:
        """Stop dispatching to ``name``, re-dispatch its queued (not yet
        admitted) requests onto peers, and wait for its admitted work to
        run out; returns how many requests were re-dispatched. The
        engine's loop keeps running: drain is a routing state.

        ``preempt=True`` (the publisher's default) evicts the admitted
        requests instead of waiting for them: a mid-decode one spills its
        KV and resumes on a peer with no prefill. Only when a live peer at
        the same weight version can take them; otherwise (the last
        replica of a rolling push) they run out here under the weights
        they started with: one request, one version."""
        with self._lock:
            h = self._replicas[name]
            if h.state == "dead":
                raise ValueError(f"replica {name!r} is dead")
            h.state = "draining"
            # only the queued requests the router owns: one submitted to
            # the engine directly drains through its normal admission
            moved = h.engine.cancel_queued(set(h.inflight.keys()))
            n = 0
            for inner in moved:
                rreq = h.inflight.pop(inner.id, None)
                if rreq is not None:
                    rreq.spill = inner.spill   # a preempted request keeps
                    #                            its KV
                    self._requeue_locked(rreq, from_replica=name,
                                         reason="drain")
                    n += 1
            if preempt:
                version = h.engine.weight_version
                peer_ok = any(
                    p.state == "live" and p is not h
                    and p.role in ("both", "decode")
                    and p.engine.weight_version == version
                    for p in self._replicas.values())
                if peer_ok:
                    for inner_id, rreq in list(h.inflight.items()):
                        if rreq.inner is None or rreq.inner.done.is_set():
                            continue
                        try:
                            entry = h.engine.evict_request(
                                rreq.inner, lock_timeout_s=5.0)
                        except Exception:            # noqa: BLE001
                            continue             # best effort: let it run
                        if rreq.inner.status != "evicted":
                            continue             # finished under us
                        h.inflight.pop(inner_id, None)
                        rreq.spill = entry
                        self._requeue_locked(rreq, from_replica=name,
                                             reason="drain_preempt")
                        n += 1
        flight_record("router_replica", replica=name, state="draining",
                      event="drain", requeued=n)
        deadline = time.monotonic() + timeout_s
        while h.engine.has_work():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {name!r} still busy after {timeout_s}s "
                    f"drain (load={h.load})")
            time.sleep(self.poll_s)
        return n

    def resume(self, name: str) -> None:
        """Return a drained replica to the dispatch pool."""
        with self._lock:
            h = self._replicas[name]
            if h.state == "dead":
                raise ValueError(f"replica {name!r} is dead")
            h.state = "live"
        flight_record("router_replica", replica=name, state="live",
                      event="resume")

    def kill_replica(self, name: str) -> int:
        """Chaos hook: treat ``name`` as crashed now: stop its loop
        without waiting, mark it dead and requeue every undelivered
        request onto peers. Returns the number requeued."""
        with self._lock:
            h = self._replicas[name]
            if h.engine._stop is not None:
                h.engine._stop.set()     # crash semantics: no join
            return self._mark_dead_locked(h, reason="killed")

    def _mark_dead_locked(self, h: ReplicaHandle, *, reason: str) -> int:
        if h.state == "dead":
            return 0
        h.state = "dead"
        # the dead replica's replication stream stops too: a later
        # cadence would tombstone the very shipments recovery reads
        try:
            h.engine.configure_replication(None)
        except Exception:                            # noqa: BLE001
            pass
        n = 0
        for inner_id, rreq in list(h.inflight.items()):
            h.inflight.pop(inner_id)
            if rreq.inner is not None and rreq.inner.done.is_set():
                self._finalize_locked(h, rreq)    # it did finish
                continue
            # salvage the KV: a killed replica is a stopped loop in this
            # process, so its arena is still readable (the eviction waits
            # for the iteration in flight and for its replays). Bounded:
            # a replica dead because its step is wedged still holds its
            # iteration lock, and this runs under the router lock: a
            # timed-out eviction degrades to a fresh requeue
            if rreq.inner is not None:
                try:
                    rreq.spill = h.engine.evict_request(
                        rreq.inner, lock_timeout_s=2.0)
                except Exception:                    # noqa: BLE001
                    rreq.spill = None
            # second line: the buddy's replica set holds the request's
            # streamed decode KV, fetched by trace id, so the requeue
            # resumes mid-decode instead of replaying the prompt
            if rreq.spill is None and self.replicate_kv \
                    and rreq.inner is not None:
                rreq.spill = self._fetch_buddy_kv_locked(h, rreq)
            self._requeue_locked(rreq, from_replica=h.name, reason=reason)
            n += 1
        # the dead replica's directory entries and buddy wiring are void;
        # origins that replicated to it rewire at the next tick
        self._directory.drop_replica(h.name)
        self._buddy_of.pop(h.name, None)
        for origin, b in list(self._buddy_of.items()):
            if b == h.name:
                self._buddy_of.pop(origin, None)
        flight_record("router_replica", replica=h.name, state="dead",
                      event=reason, requeued=n)
        return n

    # -- dispatch -------------------------------------------------------------
    def _affinity_pick(self, prompt: Sequence[int],
                       live: list[ReplicaHandle]) -> ReplicaHandle:
        """Rendezvous (highest-random-weight) hash of the prompt's first
        ``affinity_tokens`` ids over the live replicas' names: requests
        sharing a prefix agree on a replica, and a replica's arrival or
        death moves only the keys that hashed to it."""
        key = ",".join(str(int(t)) for t in prompt[:self.affinity_tokens])
        return max(live, key=lambda h: hashlib.blake2b(
            f"{h.name}|{key}".encode(), digest_size=8).digest())

    def _pick_locked(self, prompt, *, tier: str = "decode", sampling=None
                     ) -> Optional[tuple[ReplicaHandle, str]]:
        roles = ("prefill",) if tier == "prefill" else ("both", "decode")
        live = [h for h in self._replicas.values()
                if h.state == "live" and h.role in roles]
        if not live:
            return None
        loads = {h.name: h.load for h in live}
        least = min(live, key=lambda h: (
            loads[h.name],
            h.ttft_ewma_s if h.ttft_ewma_s is not None else 0.0, h.name))
        # adapter affinity: a request with a LoRA adapter prefers a
        # replica whose arena already holds it (no load, no eviction of
        # another tenant's page), within the load slack
        adapter = getattr(sampling, "adapter", None) \
            if sampling is not None else None
        if adapter is not None:
            tenant = getattr(sampling, "tenant", None)
            holders = [h for h in live
                       if h.engine.tenancy is not None
                       and h.engine.tenancy.registry.resident(tenant,
                                                              adapter)]
            if holders:
                best = min(holders, key=lambda h: (loads[h.name], h.name))
                if loads[best.name] <= loads[least.name] \
                        + self.affinity_slack:
                    return best, "adapter"
        # the prefix directory outranks rendezvous affinity: it records
        # where a prefix is, affinity only guesses where it should be.
        # Past the slack the pull moves the prefix instead
        if self.kv_pull and tier != "prefill":
            hit = self._directory.lookup(prompt)
            if hit is not None:
                owner = self._replicas.get(hit[0])
                if owner is not None and owner.name in loads \
                        and loads[owner.name] <= loads[least.name] \
                        + self.affinity_slack:
                    return owner, "directory"
        sticky = self._affinity_pick(prompt, live)
        if loads[sticky.name] <= loads[least.name] + self.affinity_slack:
            return sticky, "affinity"
        return least, "least_loaded"

    def _dispatch_locked(self, rreq: RouterRequest) -> bool:
        """Place ``rreq`` on a live replica; False parks it pending."""
        if rreq.attempts >= self.max_attempts:
            rreq.status = "failed"
            rreq.error = (f"gave up after {rreq.attempts} dispatch "
                          f"attempts (replicas kept dying)")
            rreq.finish_s = time.monotonic()
            rreq.done.set()
            self._stream_finish_locked(rreq)
            return True                      # terminal, not pending
        # prefill/decode split: a fresh request (no KV riding along) goes
        # to the prefill tier while one is live beside a decode-capable
        # replica; it parks after its first token and the monitor hands
        # its KV to the decode tier. A request with a spill goes straight
        # to the decode tier: its KV exists
        handoff = False
        picked = None
        if rreq.spill is None and any(
                h.state == "live" and h.role == "prefill"
                for h in self._replicas.values()) and any(
                h.state == "live" and h.role in ("both", "decode")
                for h in self._replicas.values()):
            picked = self._pick_locked(rreq.prompt, tier="prefill",
                                       sampling=rreq.sampling)
            handoff = picked is not None
        if picked is None:
            picked = self._pick_locked(rreq.prompt, sampling=rreq.sampling)
        if picked is None:
            return False
        h, reason = picked
        # the fleet prefix plane: a fresh request landing off the
        # directory's owner first pulls the cached prefix onto its replica
        # (export → import), so a fleet-hot prefix prefills once per
        # weight version wherever balance scatters its requests
        if not handoff and rreq.spill is None and self.kv_pull:
            warm = self._pull_prefix_locked(h, rreq)
            reg0 = telemetry.get_registry()
            reg0.counter(
                "fleet_prefix_hit_tokens_total",
                "prompt tokens covered by the fleet prefix directory "
                "at dispatch (served from cached KV — locally or via "
                "a cross-replica pull — not the prefill lane)").inc(warm)
            reg0.counter(
                "fleet_prefix_miss_tokens_total",
                "prompt tokens the fleet prefix directory could not "
                "cover at dispatch (prefilled from scratch)").inc(
                max(0, len(rreq.prompt) - warm))
        # every dispatch hop mints a span id under the request's one trace
        # id: the replica's spans and flight events join the fleet trace
        tp = telemetry.make_traceparent(rreq.trace_id)
        t0 = time.perf_counter()
        if handoff:
            reason = "pd_prefill"
            inner = h.engine.submit(rreq.prompt, rreq.sampling,
                                    handoff=True, traceparent=tp)
        else:
            inner = h.engine.submit(rreq.prompt, rreq.sampling,
                                    resume=rreq.spill, traceparent=tp)
        if rreq.spill is not None:
            if inner.spill is rreq.spill:     # the peer took the KV
                rreq.resumed_dispatches += 1
                telemetry.get_registry().counter(
                    "router_resumed_requeues_total",
                    "requeued requests whose KV spill a peer accepted "
                    "(resumed mid-decode, no re-prefill)").inc()
            rreq.spill = None     # stale either way once dispatched
        if not handoff:
            # a prefill-tier placement is half of the normal split, not a
            # retry: only the decode placement and real requeues spend
            # the attempts (a handoff whose KV pull failed is charged in
            # _handoff_locked)
            rreq.attempts += 1
        rreq.replica = h.name
        rreq.inner = inner
        if inner.status == "rejected":       # the admission gate: terminal
            rreq.status = "rejected"
            rreq.error = inner.error
            rreq.finish_s = time.monotonic()
            rreq.done.set()
            self._stream_finish_locked(rreq)
            return True
        rreq.status = "dispatched"
        h.inflight[inner.id] = rreq
        for br in self._stream_bridges.get(rreq.id, ()):
            br.attach(h)                 # resume the push at the cursor
        h.dispatched += 1
        reg = telemetry.get_registry()
        reg.counter("router_requests_total",
                    "requests dispatched by the fleet router, by "
                    "replica").inc(replica=h.name)
        reg.counter("router_dispatch_reason_total",
                    "why the router picked the replica it picked").inc(
            reason=reason)
        flight_record("router_dispatch", req=rreq.id, trace=rreq.trace_id,
                      replica=h.name, reason=reason, attempt=rreq.attempts,
                      load=h.load)
        self._trace_req_span(rreq, "dispatch", t0, replica=h.name,
                             reason=reason)
        return True

    def _trace_req_span(self, rreq: RouterRequest, name: str, t0: float,
                        **attrs) -> None:
        """A span on the request's Perfetto track in this process: the
        router's fragments (dispatch, KV pull and handoff) that
        ``tools/fleet_trace.py`` merges with the replicas' queued, prefill
        and decode fragments into one request timeline by ``trace_id``."""
        tracer = telemetry.get_tracer()
        if not tracer.enabled:
            return
        tid = request_track_tid(rreq.trace_id)
        tracer.name_track(tid, f"req {rreq.trace_id}")
        tracer.complete(name, time.perf_counter() - t0, cat="request",
                        tid=tid, trace_id=rreq.trace_id, req=rreq.id,
                        **attrs)

    # -- the fleet-global KV plane --------------------------------------------
    def _pull_prefix_locked(self, h: ReplicaHandle,
                            rreq: RouterRequest) -> int:
        """Pull the directory's cached span of ``rreq.prompt`` onto ``h``
        when another live replica owns it (owner export → ``h`` import).
        Returns the prompt tokens now warm on ``h`` (0: it prefills).
        Every failure (a dead owner, an export miss, another weight
        version, a full arena) degrades to that plain prefill."""
        hit = self._directory.lookup(rreq.prompt)
        if hit is None:
            return 0
        owner_name, nb, bs = hit
        span = nb * bs
        if owner_name == h.name:
            return span              # the dispatch landed on the owner
        owner = self._replicas.get(owner_name)
        if owner is None or owner.state == "dead":
            self._directory.drop_replica(owner_name)
            return 0
        t0 = time.perf_counter()
        try:
            entry = owner.engine.export_prefix(rreq.prompt[:span])
        except Exception:                             # noqa: BLE001
            entry = None
        if entry is None:
            # the owner no longer holds it (LRU churn, a swap's flush, a
            # wedged step): the directory was wrong, retract it
            self._directory.flush_stale(replica=owner_name)
            return 0
        try:
            ok = h.engine.import_prefix(entry)
        except Exception:                             # noqa: BLE001
            ok = False
        if not ok:
            return 0
        reg = telemetry.get_registry()
        reg.counter(
            "fleet_kv_pull_blocks_total",
            "KV blocks pulled between replicas by the fleet prefix "
            "directory (a fleet-hot prefix prefills once, then "
            "travels)").inc(entry.n_blocks)
        reg.counter(
            "fleet_kv_pull_bytes_total",
            "KV bytes moved by fleet prefix-directory pulls").inc(
            entry.nbytes())
        # the pulled span is cached here too now
        self._directory.publish(
            h.name, list(entry.tokens), block_size=entry.block_size,
            weight_version=entry.weight_version)
        flight_record("fleet_kv_pull", req=rreq.id, trace=rreq.trace_id,
                      owner=owner_name, to=h.name, blocks=entry.n_blocks,
                      bytes=entry.nbytes())
        self._trace_req_span(rreq, "kv_pull", t0, owner=owner_name,
                             to=h.name, blocks=entry.n_blocks)
        return entry.n_blocks * entry.block_size

    def _buddy_pick(self, origin: ReplicaHandle,
                    candidates: list) -> ReplicaHandle:
        """Rendezvous hash over (origin, candidate) pairs: a replica's
        arrival or death moves only the origins that hashed to it."""
        return max(candidates, key=lambda p: hashlib.blake2b(
            f"{origin.name}|{p.name}".encode(), digest_size=8).digest())

    def _assign_buddies_locked(self) -> None:
        """Keep every decode-capable replica's replication stream pointed
        at its rendezvous buddy; rewires only on a membership change."""
        live = [h for h in self._replicas.values()
                if h.state in ("live", "draining")]
        for h in live:
            if h.role == "prefill":
                continue         # the prefill tier holds no decode KV
            peers = [p for p in live if p is not h
                     and p.role in ("both", "decode")]
            cur = self._buddy_of.get(h.name)
            if not peers:
                if cur is not None:
                    self._wire_buddy(h, None)
                continue
            buddy = self._buddy_pick(h, peers)
            if buddy.name != cur:
                self._wire_buddy(h, buddy)

    def _wire_buddy(self, h: ReplicaHandle,
                    buddy: Optional[ReplicaHandle]) -> None:
        try:
            if buddy is None:
                h.engine.configure_replication(None)
                self._buddy_of.pop(h.name, None)
                return
            h.engine.configure_replication(
                buddy.engine.kv_replica_store.put, origin=h.name,
                cadence_s=self.replicate_cadence_s)
            self._buddy_of[h.name] = buddy.name
            flight_record("fleet_kv_buddy", origin=h.name, buddy=buddy.name)
        except Exception:                             # noqa: BLE001
            pass          # a wiring failure: the next tick retries

    def _fetch_buddy_kv_locked(self, h: ReplicaHandle,
                               rreq: RouterRequest):
        """A dead replica's mid-decode request from its buddy's replica
        set, by ``trace_id``; None when the buddy is gone or never got a
        complete shipment (the requeue then replays the prompt, which
        greedy decoding keeps token-identical, only slower)."""
        buddy = self._replicas.get(self._buddy_of.get(h.name, ""))
        if buddy is None or buddy.state == "dead":
            return None
        try:
            entry = buddy.engine.kv_replica_store.fetch(rreq.trace_id)
        except Exception:                             # noqa: BLE001
            return None
        if entry is not None:
            telemetry.get_registry().counter(
                "fleet_kv_recoveries_total",
                "mid-decode requests resumed from a buddy's "
                "replicated KV after their replica died (no prefill "
                "replay)").inc()
            flight_record("fleet_kv_recover", req=rreq.id,
                          trace=rreq.trace_id, victim=h.name,
                          buddy=buddy.name, blocks=entry.n_blocks,
                          pos=entry.pos)
        return entry

    def _requeue_locked(self, rreq: RouterRequest, *, from_replica: str,
                        reason: str) -> None:
        for br in self._stream_bridges.get(rreq.id, ()):
            br.detach()                  # stop feeding from the old one
        rreq.inner = None                # the old replica's work is void
        rreq.status = "queued"
        reg = telemetry.get_registry()
        if reason == "pd_handoff":
            # the planned prefill→decode hop is not a failure requeue
            reg.counter(
                "fleet_pd_handoffs_total",
                "requests handed from the prefill tier to the decode "
                "tier (P/D disaggregation — KV streamed, zero "
                "re-prefill)").inc()
        else:
            self.requeues_total += 1
            reg.counter(
                "router_requeues_total",
                "in-flight requests re-dispatched after a replica "
                "drain/death").inc()
        flight_record("router_requeue", req=rreq.id, trace=rreq.trace_id,
                      from_replica=from_replica, reason=reason)
        if not self._dispatch_locked(rreq):
            self._pending.append(rreq)

    # -- the request surface (the engine's shape) -----------------------------
    def submit(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None, *,
               traceparent: Optional[str] = None) -> RouterRequest:
        """Dispatch one request to the fleet; it waits pending while no
        replica is live (the monitor places it as soon as one is).
        ``traceparent`` adopts an upstream trace context."""
        sampling = sampling or SamplingParams()
        with self._lock:
            rreq = RouterRequest(
                id=self._next_id, prompt=[int(t) for t in prompt],
                sampling=sampling, submit_s=time.monotonic())
            self._next_id += 1
            if traceparent:
                tid, _span = telemetry.parse_traceparent(traceparent)
                if tid:
                    rreq.trace_id = tid
                    rreq.traceparent = traceparent
            if not self._dispatch_locked(rreq):
                self._pending.append(rreq)
        return rreq

    def result(self, req: RouterRequest,
               timeout: Optional[float] = None) -> Optional[dict]:
        if not req.done.wait(timeout):
            return None
        return req.result()

    def stream_subscribe(self, rreq: RouterRequest, *, offset: int = 0,
                         max_queue: int = 256):
        """The engine's ``stream_subscribe`` for a fleet request: a
        bounded token subscription fed by whichever replica serves
        ``rreq``, surviving requeues and failovers (each re-dispatch
        resumes the push at the subscription's cursor)."""
        from hetu_tpu_torch.serving.streaming import TokenSubscription
        sub = TokenSubscription(rreq.id, offset=offset, max_queue=max_queue)
        br = _StreamBridge(rreq, sub)
        with self._lock:
            if rreq.done.is_set():
                br.finalize()            # the backlog and the terminal
                return sub
            self._stream_bridges.setdefault(rreq.id, []).append(br)
            if rreq.status == "dispatched" and rreq.inner is not None:
                h = self._replicas.get(rreq.replica)
                if h is not None:
                    br.attach(h)
        return sub

    def _stream_finish_locked(self, rreq: RouterRequest) -> None:
        for br in self._stream_bridges.pop(rreq.id, ()):
            br.finalize()

    def generate_many(
            self, prompts: Sequence[Sequence[int]],
            sampling: Union[SamplingParams, Sequence[SamplingParams],
                            None] = None) -> list[list[int]]:
        """The fleet's ``generate_many``: submit every prompt, wait, and
        return each request's tokens in submission order (the replica that
        served a request never changes its greedy tokens). Raises on an
        admission rejection, as the engine does."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling or SamplingParams()] * len(prompts)
        reqs = [self.submit(p, sp) for p, sp in zip(prompts, sampling)]
        bad = [r for r in reqs if r.status == "rejected"]
        if bad:
            raise ValueError(
                f"{len(bad)} request(s) rejected at admission: "
                + "; ".join(f"#{r.id}: {r.error}" for r in bad[:3]))
        for r in reqs:
            r.done.wait()
            if r.status != "done":
                raise RuntimeError(f"request #{r.id} {r.status}: {r.error}")
        return [list(r.tokens) for r in reqs]

    # -- the monitor ----------------------------------------------------------
    def _finalize_locked(self, h: ReplicaHandle,
                         rreq: RouterRequest) -> None:
        inner = rreq.inner
        rreq.tokens = list(inner.tokens)
        rreq.status = inner.status
        rreq.error = inner.error
        rreq.weight_version = inner.weight_version
        rreq.finish_s = time.monotonic()
        if inner.first_token_s is not None:
            ttft = inner.first_token_s - inner.submit_s
            h.ttft_ewma_s = ttft if h.ttft_ewma_s is None \
                else 0.8 * h.ttft_ewma_s + 0.2 * ttft
        # a finished request leaves its prompt's whole blocks in the
        # replica's radix cache: publish them (version-tagged) to the
        # directory, so peers can pull them
        if self.kv_pull and rreq.status == "done" and h.state != "dead":
            bs = int(h.engine.pool.block_size)
            self._directory.publish(
                h.name, rreq.prompt, block_size=bs,
                weight_version=int(rreq.weight_version or 0))
        rreq.done.set()
        self._stream_finish_locked(rreq)

    def _handoff_locked(self, h: ReplicaHandle, inner_id: int,
                        rreq: RouterRequest, reg) -> None:
        """Move one prefilled request from its prefill-tier replica to the
        decode tier: evict the parked KV (a ``SpillEntry``, the payload
        preemption and drains move) and requeue the request with it, so
        the decode replica resumes it with no prefill."""
        inner = rreq.inner
        t0 = time.perf_counter()
        try:
            entry = h.engine.evict_request(inner, lock_timeout_s=5.0)
        except Exception:                             # noqa: BLE001
            entry = None
        if inner.done.is_set():          # it finished under us
            h.inflight.pop(inner_id, None)
            self._finalize_locked(h, rreq)
            return
        h.inflight.pop(inner_id, None)
        rreq.spill = entry
        if entry is None:
            # the KV did not come out (a wedged engine): this re-enters
            # the prefill tier for a fresh prefill, so it is charged an
            # attempt, and a failing replica cannot loop it forever
            rreq.attempts += 1
        else:
            reg.counter(
                "fleet_kv_stream_blocks_total",
                "KV blocks streamed between fleet replicas "
                "(prefill→decode handoffs, cross-process drains and "
                "salvage)").inc(entry.n_blocks)
            flight_record("fleet_kv_stream", req=rreq.id,
                          trace=rreq.trace_id, from_replica=h.name,
                          blocks=entry.n_blocks, tokens=len(entry.tokens))
            self._trace_req_span(rreq, "kv_handoff", t0,
                                 from_replica=h.name, blocks=entry.n_blocks)
        self._requeue_locked(rreq, from_replica=h.name, reason="pd_handoff")

    def _tick(self) -> None:
        now = time.monotonic()
        reg = telemetry.get_registry()
        with self._lock:
            for h in list(self._replicas.values()):
                if h.state == "dead":
                    continue
                # a stale heartbeat means death only for a replica whose
                # loop this process does not run: a live loop thread
                # outranks a stale beat
                beat_stale = h.last_beat is not None \
                    and now - h.last_beat > self.beat_timeout_s \
                    and not h.loop_alive()
                if h.loop_died() or beat_stale:
                    self._mark_dead_locked(
                        h, reason="beat_timeout" if beat_stale
                        else "loop_dead")
                    continue
                for inner_id, rreq in list(h.inflight.items()):
                    if rreq.inner is not None and rreq.inner.done.is_set():
                        h.inflight.pop(inner_id)
                        self._finalize_locked(h, rreq)
                    elif rreq.inner is not None and rreq.inner.handoff \
                            and rreq.inner.status == "prefilled":
                        # the prefill finished and parked: move its KV to
                        # the decode tier
                        self._handoff_locked(h, inner_id, rreq, reg)
            if self.replicate_kv:
                self._assign_buddies_locked()
            # place pending requests as capacity (re)appears
            still: deque[RouterRequest] = deque()
            while self._pending:
                rreq = self._pending.popleft()
                if not self._dispatch_locked(rreq):
                    still.append(rreq)
                    break                    # no live replica: stop
            still.extend(self._pending)
            self._pending = still
            live = sum(1 for h in self._replicas.values()
                       if h.state == "live")
            reg.gauge("router_replicas_live",
                      "replicas currently accepting dispatch").set(live)
            for h in self._replicas.values():
                reg.gauge("router_replica_load",
                          "per-replica queued+prefilling+decoding "
                          "requests, as dispatch sees it").set(
                    0 if h.state == "dead" else h.load, replica=h.name)

    def start(self) -> None:
        with self._lock:
            if self._monitor is not None and self._monitor.is_alive():
                return
            self._stop_ev = stop = threading.Event()

            def loop():
                while not stop.is_set():
                    self._tick()
                    # the federation snapshot on its own (slower) cadence,
                    # outside the tick's lock
                    if time.monotonic() - self._fed_ts \
                            >= self.scrape_every_s:
                        self._scrape_replicas()
                    stop.wait(self.poll_s)

            self._monitor = threading.Thread(target=loop, daemon=True,
                                             name="router-monitor")
            self._monitor.start()

    def stop(self) -> None:
        """Stop the monitor and every live replica's engine loop."""
        if self._stop_ev is not None:
            self._stop_ev.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
            self._monitor = None
        with self._lock:
            handles = list(self._replicas.values())
        for h in handles:
            if h.state != "dead":
                h.engine.stop()

    # -- fleet observability --------------------------------------------------
    def fleet_status(self) -> dict:
        """The whole fleet in one document: what FLEET returns and what
        HEALTHZ embeds when a Router is the attached serving object."""
        with self._lock:
            reps = {name: h.status() for name, h in self._replicas.items()}
            return {
                "replicas": reps,
                "live": sum(1 for r in reps.values()
                            if r["state"] == "live"),
                "pending": len(self._pending),
                "requests_total": self._next_id,
                "requeues_total": self.requeues_total,
                "weight_versions": sorted(
                    {r["weight_version"] for r in reps.values()
                     if r["state"] != "dead"}),
                "prefix_directory": {
                    "entries": len(self._directory),
                    "published_total": self._directory.published_total,
                    "flushed_total": self._directory.flushed_total},
                "kv_buddies": dict(self._buddy_of),
            }

    def _scrape_replicas(self) -> None:
        """One federation round: each replica's health. In-process
        replicas share this process's registry, so they carry no metrics
        text of their own (``fleet_metrics_text`` adds the registry once,
        under ``_local``)."""
        with self._lock:
            targets = list(self._replicas.items())
        results: dict[str, dict] = {}
        for name, h in targets:
            if h.state == "dead":
                results[name] = {"metrics": None,
                                 "health": {"status": "dead",
                                            "state": "dead"}}
                continue
            health = dict(h.status())
            health["status"] = "ok" if h.state == "live" else "degraded"
            results[name] = {"metrics": None, "health": health}
        with self._fed_lock:
            self._fed = results
            self._fed_ts = time.monotonic()

    def _fed_fresh(self, max_age_s: Optional[float]) -> dict:
        """The federation snapshot, taken first when stale or never
        taken."""
        max_age = self.scrape_every_s if max_age_s is None \
            else float(max_age_s)
        if time.monotonic() - self._fed_ts > max_age or not self._fed:
            self._scrape_replicas()
        with self._fed_lock:
            return dict(self._fed)

    def fleet_metrics_text(self, *,
                           max_age_s: Optional[float] = None) -> str:
        """The fleet's Prometheus page (the FLEETMETRICS verb): each
        replica's series labeled ``replica="<name>"`` (in-process replicas
        share the registry, served once under ``replica="_local"``), plus
        the pre-aggregated ``replica="_fleet"`` totals."""
        fed = self._fed_fresh(max_age_s)
        texts = {name: doc["metrics"] for name, doc in fed.items()
                 if doc.get("metrics")}
        texts["_local"] = telemetry.get_registry().to_prometheus()
        return telemetry.merge_prometheus(texts)

    def fleet_healthz(self, *, max_age_s: Optional[float] = None) -> dict:
        """The fleet health rollup naming the degraded replicas, embedded
        in the front door's HEALTHZ when a Router is attached."""
        fed = self._fed_fresh(max_age_s)
        return telemetry.health_rollup(
            {name: doc["health"] for name, doc in fed.items()})


def materialize_params(params) -> dict:
    """``params`` as the mapping ``ServingEngine.swap_params`` takes: each
    parameter name of the model to a tensor of its shape and dtype
    (``hetu_tpu/serving/router.py:1420``). ``params`` is a mapping
    already, a model (``nn.Module``) or a trainer state (``.model``).

    JAX force-copies here, because a trainer's next step donates its
    buffers. Torch donates nothing, and ``swap_params`` copies every
    value into the replica's own tensors in place: that copy is the
    forced one, and no second copy is made here."""
    src = getattr(params, "model", params)
    if isinstance(src, torch.nn.Module):
        src = dict(src.named_parameters())
    if not isinstance(src, Mapping):
        raise TypeError(f"params must be a mapping, a model or a trainer "
                        f"state, got {type(params).__name__}")
    return dict(src)


class WeightPublisher:
    """The trainer's live weight push: rolling drain → swap → resume
    (``hetu_tpu/serving/router.py:1443``).

    One :meth:`publish` walks the fleet one replica at a time; while a
    replica drains, dispatch (and the requeue of its queued requests)
    moves its traffic to peers, so with two or more replicas the fleet
    never has zero live replicas. Requests admitted before a replica's
    swap finish under the old weights (tagged with that version), those
    after under the new. A replica that cannot drain within
    ``drain_timeout_s`` is declared dead (its work requeues).

    Drains are resumable by default (``preempt=True``): mid-decode
    requests move to a same-version peer with their KV, so a push does
    not wait for the longest decode; the last replica of a push (no
    old-version peer left) runs its requests out.

    ``transport="reshard"`` moves the parameters in memory (in-process
    replicas): ``swap_params`` copies them into each replica's tensors,
    and ``weight_push_bytes_total{transport="reshard"}`` counts those
    bytes, per replica. ``transport="dist_ckpt"`` (a sharded checkpoint
    written once and loaded by each replica) needs the distributed
    checkpoint, which is not ported yet."""

    def __init__(self, router: Router, *, drain_timeout_s: float = 60.0,
                 preempt: bool = True, transport: str = "reshard"):
        if transport == "dist_ckpt":
            raise ValueError(
                "transport='dist_ckpt' needs the distributed checkpoint "
                "(utils/dist_checkpoint.py), which the port does not have "
                "yet: use transport='reshard' with in-process replicas")
        if transport != "reshard":
            raise ValueError(f"transport must be reshard|dist_ckpt, "
                             f"got {transport!r}")
        self.router = router
        self.drain_timeout_s = float(drain_timeout_s)
        self.preempt = bool(preempt)
        self.transport = transport
        self._last_version = 0       # keeps auto-versioning monotonic

    def _swap_replica(self, h: ReplicaHandle, params, version, reg) -> dict:
        local = materialize_params(params)
        reg.counter(
            "weight_push_bytes_total",
            "parameter bytes moved by fleet weight pushes, by "
            "transport (dist_ckpt counts bytes WRITTEN once per push "
            "— delta savings show here; reshard counts device-copy "
            "bytes per replica)").inc(
            sum(p.numel() * p.element_size()
                for p in h.engine.model.parameters()),
            transport="reshard")
        return h.engine.swap_params(local, version=version)

    def publish(self, state_or_params, *,
                version: Optional[int] = None) -> dict:
        """Push ``state_or_params`` (a trainer state, a model or a
        parameter mapping) to every replica that is not dead. Returns the
        push report (each replica's drain + swap time and flushed
        blocks)."""
        t0 = time.perf_counter()
        # the push has its own trace context, active for the whole walk:
        # the drain and swap flight events (and a concurrent chaos kill)
        # carry it, so fleet_trace.py can pin a TTFT spike on the push
        push_tp = telemetry.make_traceparent(uuid.uuid4().hex[:12])
        with telemetry.use_trace(push_tp):
            return self._publish_traced(state_or_params, t0, push_tp,
                                        version=version)

    def _publish_traced(self, params, t0: float, push_tp: str, *,
                        version: Optional[int]) -> dict:
        reg = telemetry.get_registry()
        with self.router._lock:
            names = sorted(n for n, h in self.router._replicas.items()
                           if h.state != "dead")
            if version is None:
                version = max(
                    1 + max((self.router._replicas[n].weight_version
                             for n in names), default=0),
                    self._last_version + 1)
        self._last_version = max(self._last_version, int(version))
        per = []
        for name in names:
            h = self.router._replicas.get(name)
            if h is None or h.state == "dead":
                continue
            t1 = time.perf_counter()
            try:
                requeued = self.router.drain(
                    name, timeout_s=self.drain_timeout_s,
                    preempt=self.preempt)
            except TimeoutError:
                with self.router._lock:
                    self.router._mark_dead_locked(h, reason="drain_timeout")
                per.append({"replica": name, "skipped": "drain_timeout"})
                continue
            t2 = time.perf_counter()
            info = self._swap_replica(h, params, version, reg)
            t3 = time.perf_counter()
            # the swap flushed the replica's stale prefix cache: flush the
            # directory's view of it too, so no peer pulls superseded KV
            self.router._directory.flush_stale(replica=name)
            self.router.resume(name)
            per.append({"replica": name, "requeued": requeued,
                        "flushed_blocks": info.get("flushed_blocks", 0),
                        "drain_ms": round((t2 - t1) * 1e3, 3),
                        "swap_ms": round((t3 - t2) * 1e3, 3),
                        "ms": round((time.perf_counter() - t1) * 1e3, 3)})
        dur_ms = (time.perf_counter() - t0) * 1e3
        reg.histogram("weight_push_duration_ms",
                      "one rolling fleet weight push, end to end "
                      "(drain + reshard + swap, all replicas)").observe(
            dur_ms)
        reg.counter("weight_pushes_total",
                    "rolling fleet weight pushes completed").inc()
        flight_record("weight_push", version=version, replicas=len(per),
                      ms=round(dur_ms, 3), trace=push_tp)
        return {"version": version, "replicas": per,
                "duration_ms": round(dur_ms, 3), "trace": push_tp}

    # -- per-tenant adapter push ----------------------------------------------
    def publish_adapter(self, tenant: str, name: str, weights, *,
                        scaling: float = 1.0) -> dict:
        """Push one tenant's LoRA adapter (``weights``: the pages dict
        ``ServingEngine.load_adapter`` takes) to every replica that is not
        dead, draining nothing: adapters hot-swap under live traffic, and
        the base weights and every other tenant are untouched. (Loading
        from a ``save_adapter_distributed`` path waits for the
        distributed checkpoint.)"""
        t0 = time.perf_counter()
        with self.router._lock:
            names = sorted(n for n, h in self.router._replicas.items()
                           if h.state != "dead")
        per = []
        for rname in names:
            h = self.router._replicas.get(rname)
            if h is None or h.state == "dead":
                continue
            if h.engine.tenancy is None:
                per.append({"replica": rname, "skipped": "no_tenancy"})
                continue
            t1 = time.perf_counter()
            try:
                info = h.engine.load_adapter(tenant, name, weights,
                                             scaling=scaling)
            except Exception as err:  # a replica's own failure: walk on
                per.append({"replica": rname,
                            "skipped": f"{type(err).__name__}: {err}"})
                continue
            per.append({"replica": rname, "version": info["version"],
                        "uid": info["uid"],
                        "flushed_blocks": info["flushed_blocks"],
                        "ms": round((time.perf_counter() - t1) * 1e3, 3)})
        dur_ms = (time.perf_counter() - t0) * 1e3
        telemetry.get_registry().counter(
            "adapter_pushes_total",
            "fleet-wide per-tenant adapter pushes completed (no "
            "drain — adapters hot-swap under live traffic)").inc()
        flight_record("adapter_push", tenant=tenant, adapter=name,
                      replicas=len(per), ms=round(dur_ms, 3))
        return {"tenant": tenant, "adapter": name, "replicas": per,
                "duration_ms": round(dur_ms, 3)}

    def evict_adapter(self, tenant: str, name: str) -> dict:
        """Deregister ``(tenant, name)`` fleet-wide: each replica drops
        the registry entry, frees its arena page once the last pinned
        request finishes, and flushes the adapter's prefix spans."""
        with self.router._lock:
            names = sorted(n for n, h in self.router._replicas.items()
                           if h.state != "dead")
        per = []
        for rname in names:
            h = self.router._replicas.get(rname)
            if h is None or h.state == "dead" or h.engine.tenancy is None:
                continue
            try:
                per.append({"replica": rname,
                            **h.engine.evict_adapter(tenant, name)})
            except KeyError:
                per.append({"replica": rname, "skipped": "unknown"})
        flight_record("adapter_evict_fleet", tenant=tenant, adapter=name,
                      replicas=len(per))
        return {"tenant": tenant, "adapter": name, "replicas": per}


__all__ = ["FleetPrefixDirectory", "ReplicaHandle", "Router",
           "RouterRequest", "WeightPublisher", "materialize_params"]
