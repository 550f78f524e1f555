"""The fleet's KV payloads (counterpart of the first part of
``hetu_tpu/serving/fleet.py``): the KV wire format and the buddy-side
store of replicated decode KV.

- :func:`array_to_wire` / :func:`array_from_wire`: one tensor as a
  JSON-safe dict (dtype, shape, raw bytes in base64), lossless for every
  arena dtype (bf16, and the int8 pages with their fp32 scales);
- :func:`spill_to_wire` / :func:`spill_from_wire`: a
  :class:`~hetu_tpu_torch.serving.kv_pool.SpillEntry` on the line
  protocol, the payload that moves KV between engines (preemptive drains,
  kill salvage, prefill→decode handoffs, prefix pulls).
  ``from_wire(to_wire(e))`` reproduces every block bit for bit. The port
  carries the sampled request's ``torch.Generator`` state
  (``gen_state``) where ``hetu_tpu`` carries its PRNG ``key_state``;
- :class:`KVReplicaStore`: a buddy replica's accumulator of a peer's
  streamed decode KV, keyed by trace id, from which the router recovers
  a dead replica's mid-decode requests.

The engine processes of ``hetu_tpu``'s fleet (``RemoteEngineProxy``,
``RemoteReplicaHandle``, ``replica_main``) are not ported yet.
"""

from __future__ import annotations

import base64
import threading
from typing import Optional

import torch

from hetu_tpu_torch.serving.kv_pool import SpillEntry

# -- the KV wire format ---------------------------------------------------------


def array_to_wire(a) -> dict:
    """One tensor (or numpy array) → a JSON-safe dict: dtype, shape and
    the raw bytes in base64. ``hetu_tpu``'s format, so each package reads
    the other's arrays (numpy has no bfloat16: bf16 travels by name)."""
    t = torch.as_tensor(a).detach().contiguous().cpu()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return {"dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape),
            "b64": base64.b64encode(raw).decode("ascii")}


def array_from_wire(d: dict) -> torch.Tensor:
    raw = bytearray(base64.b64decode(d["b64"]))
    dtype = getattr(torch, d["dtype"])
    if not raw:
        return torch.empty(d["shape"], dtype=dtype)
    return torch.frombuffer(raw, dtype=torch.uint8).view(dtype).reshape(
        d["shape"])


def spill_to_wire(entry: SpillEntry) -> dict:
    """A :class:`SpillEntry` for the line protocol: the payload that moves
    an evicted request's KV blocks to another engine."""
    d = {"req_id": entry.req_id, "n_blocks": entry.n_blocks,
         "block_size": entry.block_size, "pos": entry.pos,
         "last_tok": entry.last_tok,
         "tokens": [int(t) for t in entry.tokens],
         "weight_version": entry.weight_version, "adapter": entry.adapter,
         "data": [array_to_wire(a) for a in entry.data]}
    if entry.traceparent:
        d["traceparent"] = entry.traceparent
    if entry.gen_state is not None:
        # a sampled request's generator state travels with its KV: a
        # resume without it would fork the sample stream
        d["gen_state"] = array_to_wire(entry.gen_state)
    return d


def spill_from_wire(d: dict) -> SpillEntry:
    gs = d.get("gen_state")
    return SpillEntry(
        req_id=int(d["req_id"]),
        data=tuple(array_from_wire(a) for a in d["data"]),
        n_blocks=int(d["n_blocks"]), block_size=int(d["block_size"]),
        pos=int(d["pos"]), last_tok=int(d["last_tok"]),
        tokens=[int(t) for t in d["tokens"]],
        weight_version=int(d["weight_version"]),
        traceparent=d.get("traceparent"),
        gen_state=array_from_wire(gs) if gs is not None else None,
        adapter=int(d.get("adapter", 0)))


# -- decode-KV replication: the buddy-side store --------------------------------


def _host_array(a) -> torch.Tensor:
    """A shipment's array: a host tensor as an in-process origin ships
    it, or its wire dict as KVREPL delivers it."""
    return a if isinstance(a, torch.Tensor) else array_from_wire(a)


def repl_doc_to_wire(doc: dict) -> dict:
    """A replication shipment (or tombstone) for the line protocol: its
    tensors as wire dicts (KVBUDDY's sink sends it as KVREPL)."""
    out = dict(doc)
    if "data" in out:
        out["data"] = [a if isinstance(a, dict) else array_to_wire(a)
                       for a in out["data"]]
    if isinstance(out.get("gen_state"), torch.Tensor):
        out["gen_state"] = array_to_wire(out["gen_state"])
    return out



class KVReplicaStore:
    """A buddy replica's accumulator of a decoding peer's replicated KV
    (``hetu_tpu/serving/fleet.py:123-216``).

    The origin engine streams newly completed blocks on a block-granular
    cadence (``ServingEngine.configure_replication``); each shipment is a
    doc with a contiguous block range ``[start, start + n)`` of every
    arena leaf (host tensors from an in-process origin, which ships them
    without an encoding pass on the interpreter its loop shares; wire
    dicts over KVREPL, ``hetu_tpu``'s JSON-safe form) and a consistent snapshot (pos, tokens, last token,
    generator state) taken under the origin's iteration lock with the
    blocks. Entries are keyed by ``trace_id``, the one identity that
    survives the origin's death and any number of requeues, and
    :meth:`fetch` assembles a :class:`SpillEntry` that ``submit(resume=)``
    on a live peer takes: a resume like any preemption's.

    Host only: ``put`` runs on the origin's replication thread (in
    process) or on a verb handler's thread (KVREPL), under this store's
    own lock."""

    def __init__(self, max_traces: int = 256):
        self.max_traces = int(max_traces)
        self._lock = threading.Lock()
        self._by_trace: dict[str, dict] = {}     # insertion order = LRU
        self.put_total = 0

    @property
    def blocks_held(self) -> int:
        with self._lock:
            return sum(len(e["blocks"]) for e in self._by_trace.values())

    def __contains__(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._by_trace

    def put(self, doc: dict) -> None:
        """Absorb one replication shipment, or a ``{"drop": trace_id}``
        tombstone when the origin finished the request."""
        tid = doc.get("drop")
        if tid:
            with self._lock:
                self._by_trace.pop(tid, None)
            return
        tid = doc["trace_id"]
        data = [_host_array(a) for a in doc["data"]]
        start = int(doc["start"])
        with self._lock:
            ent = self._by_trace.pop(tid, None) or {"blocks": {}}
            self._by_trace[tid] = ent            # refresh the LRU position
            for j in range(int(data[0].shape[1])):
                ent["blocks"][start + j] = [a[:, j:j + 1] for a in data]
            ent["meta"] = {k: doc.get(k) for k in (
                "origin", "req_id", "weight_version", "block_size", "pos",
                "last_tok", "tokens", "gen_state", "traceparent")}
            self.put_total += 1
            while len(self._by_trace) > self.max_traces:
                self._by_trace.pop(next(iter(self._by_trace)))

    def fetch(self, trace_id: str) -> Optional[SpillEntry]:
        """Assemble the replica set into a resumable :class:`SpillEntry`,
        or None while coverage is incomplete (a request that died before
        its first shipment replays from its prompt)."""
        with self._lock:
            ent = self._by_trace.get(trace_id)
            if ent is None or "meta" not in ent:
                return None
            m = ent["meta"]
            bs, pos = int(m["block_size"]), int(m["pos"])
            nb = max(1, -(-pos // bs))
            blocks = ent["blocks"]
            if any(i not in blocks for i in range(nb)):
                return None
            data = tuple(
                torch.cat([blocks[i][leaf] for i in range(nb)], dim=1)
                for leaf in range(len(blocks[0])))
        gs = m.get("gen_state")
        return SpillEntry(
            req_id=int(m["req_id"]), data=data, n_blocks=nb,
            block_size=bs, pos=pos, last_tok=int(m["last_tok"]),
            tokens=[int(t) for t in m["tokens"]],
            weight_version=int(m["weight_version"]),
            traceparent=m.get("traceparent"),
            gen_state=_host_array(gs) if gs is not None else None)


__all__ = ["KVReplicaStore", "array_from_wire", "array_to_wire",
           "repl_doc_to_wire", "spill_from_wire", "spill_to_wire"]
