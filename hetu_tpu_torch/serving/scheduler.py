"""Request lifecycle + slot scheduler for the serving engine (counterpart
of ``hetu_tpu/serving/scheduler.py``, cut to what the port's engine
runs).

Orca-style continuous batching (iteration-level scheduling, OSDI'22)
reduces, on the scheduling side, to a small amount of bookkeeping: a
queue, a free-slot list over the KV pool, and an admission gate that
answers one question — does this request's worst case
(``len(prompt) + max_tokens``) fit a slot, in free blocks net of the
prefix cache? Everything dynamic (admission, completion, release) is a
host-side list operation; the device only sees tensors of block ids.

The scheduler is pure logic the engine drives. Under pressure a queued
request may preempt a running one of a strictly lower class
(:meth:`Scheduler.preemption_victim`): the engine spills the victim's KV
to its host arena and requeues it at the head of the queue
(:meth:`Scheduler.requeue_preempted`); a request carrying a spill
(``Request.spill``) is admitted through :meth:`Scheduler._resume_plan`
— fresh blocks, no prefill, no prefix cache. Uniform-priority traffic
never preempts, so it keeps the run-to-completion guarantee. An
``admission_gate`` (the engine's tenant QoS) takes a deferred request out
of a round's selection without charging its class.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from collections import deque
from typing import Optional

import numpy as np

from hetu_tpu_torch.models.generation import PromptTooLongError


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode knobs.

    ``priority`` is the request's class: LOWER is more urgent (0 =
    interactive, 1 = standard/default, 2+ = batch). Admission is
    deficit-weighted across classes (class ``c`` gets a ``2^-c`` share
    of admissions when everything is backlogged — urgent traffic goes
    first but batch traffic never starves), and a queued request may
    PREEMPT a
    running strictly-lower-priority one when slots or blocks run dry:
    the victim's KV spills to the host arena and resumes later without
    re-running prefill."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: Optional[int] = None
    max_tokens: int = 16
    priority: int = 1
    #: multi-tenant serving (``serving/tenancy.py``): ``tenant`` names the
    #: request's QoS identity (token-bucket rate limits and slot caps at
    #: admission), ``adapter`` the tenant's LoRA adapter to decode under
    #: (None = the shared base model). Both are host data: the captured
    #: lanes only ever see the adapter's arena page id.
    tenant: Optional[str] = None
    adapter: Optional[str] = None
    #: per-request PRNG seed for sampled decoding (temperature > 0):
    #: the engine seeds the request's ``torch.Generator`` with it, so a
    #: sampled run replays exactly — and matches one-shot ``generate``
    #: with a generator of the same seed. None derives a seed from the
    #: engine seed + request id (reproducible per engine).
    seed: Optional[int] = None


@dataclasses.dataclass
class Request:
    """One request's lifecycle: queued → prefill → decode → done (or
    rejected at submission); a preempted request goes decode →
    preempted → resuming → decode. Every phase transition appends
    ``(phase, ts_s, dur_s)`` to ``events`` (:meth:`mark`), and
    :meth:`timing` folds them into TTFT and the other phase times."""

    id: int
    prompt: np.ndarray                 # (P,) int32
    sampling: SamplingParams
    submit_s: float
    status: str = "queued"
    slot: Optional[int] = None
    tokens: list = dataclasses.field(default_factory=list)
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    error: Optional[str] = None
    cached_tokens: int = 0             # prompt tokens served by the
    #                                    prefix cache (skipped prefill)
    weight_version: int = 0            # weight generation the request
    #                                    was admitted (and decoded) under
    handoff: bool = False              # prefill-tier mode: the engine
    #                                    parks the request after its
    #                                    first token (status
    #                                    "prefilled", slot inactive but
    #                                    owned) instead of decoding on;
    #                                    the fleet evicts its KV to a
    #                                    decode-tier replica
    drafted: int = 0                   # draft tokens this request saw
    accepted: int = 0                  # drafts the verify lane accepted
    preemptions: int = 0               # times evicted mid-decode
    spilled_blocks: int = 0            # KV blocks copied to the host
    #                                    spill arena across preemptions
    resumed_blocks: int = 0            # KV blocks mapped back on resume
    adapter_ref: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)  # AdapterSpec pinned at
    #                                    admission (its ref is held until
    #                                    the request leaves the engine,
    #                                    across preemption)
    kv_adapter: int = 0                # adapter KV-compat uid this
    #                                    request's KV is written under (0 =
    #                                    base-compatible): tags its prefix
    #                                    inserts and spills, and filters
    #                                    its prefix matches
    spill: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)  # live SpillEntry while
    #                                    preempted/queued-for-resume: it
    #                                    routes admission through the
    #                                    resume path instead of prefill
    first_logits: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)  # engine-recorded, opt-in
    trace_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:12])
    traceparent: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)  # inbound wire context
    #                                    ("<trace_id>-<span_id>"): when
    #                                    set, trace_id above is overridden
    #                                    to match it, so every process
    #                                    stamps the originating id
    admit: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False)  # paged admission plan
    events: list = dataclasses.field(default_factory=list,
                                     repr=False, compare=False)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    def mark(self, phase: str, dur_s: float = 0.0,
             ts_s: Optional[float] = None) -> None:
        """Append one lifecycle event (``ts_s`` defaults to now; the
        clock is ``time.monotonic`` — the same one ``submit_s`` uses)."""
        self.events.append(
            (phase, time.monotonic() if ts_s is None else ts_s,
             float(dur_s)))

    def timing(self) -> dict:
        """Phase breakdown in milliseconds: queued (submit → admit),
        prefill (admit → first token), TTFT (submit → first token),
        decode (first token → finish), total, plus the prefill-chunk
        count, the prefix-cache hit, its drafted and accepted tokens,
        and what the scheduler did to the request under pressure
        (preemptions, spilled and resumed blocks, whether it resumed
        mid-decode), led by the request's ``trace_id``."""
        out = {"trace_id": self.trace_id}
        admit_s = next((t for p, t, _ in self.events if p == "admit"),
                       None)
        if admit_s is not None:
            out["queued_ms"] = round((admit_s - self.submit_s) * 1e3, 3)
        if self.first_token_s is not None and admit_s is not None:
            out["prefill_ms"] = round(
                (self.first_token_s - admit_s) * 1e3, 3)
            out["ttft_ms"] = round(
                (self.first_token_s - self.submit_s) * 1e3, 3)
        if self.finish_s is not None and self.first_token_s is not None:
            out["decode_ms"] = round(
                (self.finish_s - self.first_token_s) * 1e3, 3)
        if self.finish_s is not None:
            out["total_ms"] = round(
                (self.finish_s - self.submit_s) * 1e3, 3)
        out["prefill_chunks"] = sum(
            1 for p, _, _ in self.events if p == "prefill_chunk")
        out["cached_tokens"] = self.cached_tokens
        out["priority"] = self.sampling.priority
        out["drafted"] = self.drafted
        out["accepted"] = self.accepted
        out["preemptions"] = self.preemptions
        out["spilled_blocks"] = self.spilled_blocks
        out["resumed_blocks"] = self.resumed_blocks
        out["resumed"] = any(p == "resumed" for p, _, _ in self.events)
        return out

    def result(self) -> dict:
        return {"id": self.id, "status": self.status,
                "tokens": list(self.tokens), "error": self.error,
                "weight_version": self.weight_version,
                "timing": self.timing()}


class Scheduler:
    """Admission over a fixed slot pool and a block-paged arena.

    A request is admitted when a slot is free AND its worst case fits in
    NEW blocks — net of the prefix cache, so a full-prefix hit costs ~0
    blocks and admits even into a nearly-full pool. When blocks run short
    the scheduler first LRU-evicts unpinned cache leaves; if still short,
    the chosen head WAITS (head-of-line within its class — a later
    cheaper request never jumps it, which keeps ``generate_many`` outputs
    in submission order under churn). ``max_len`` is the per-slot budget
    (one slot's block table addresses ``max_len`` positions).

    Across classes (``SamplingParams.priority``) selection is
    deficit-weighted: every selection round each backlogged class earns
    credits proportional to its weight ``2^-priority``, and the richest
    class admits its OLDEST request and pays one credit. With a single class
    this is exact FCFS. A request carrying a KV spill (``req.spill``) is
    priced and admitted through the resume path — fresh blocks, no
    prefill, no prefix-cache interaction.
    """

    def __init__(self, slots: int, max_len: int, *, blocks, prefix_cache,
                 block_size: int):
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.queue: deque[Request] = deque()
        self.free: list[int] = list(range(self.slots))
        self.blocks = blocks              # BlockManager
        self.cache = prefix_cache         # PrefixCache
        self.block_size = int(block_size)
        self._credit: dict[int, float] = {}   # deficit counters by class
        self.evictions_total = 0          # prefix-cache blocks evicted
        self.preemptions_total = 0        # running requests preempted
        #: optional per-request admission gate (the engine's tenant QoS
        #: hook, ``serving/tenancy.py``): ``callable(req) -> bool``. False
        #: defers the request this round (rate-limited or slot-capped
        #: tenant, adapter arena full): the deficit selection skips it,
        #: so a throttled tenant's backlog never blocks other tenants and
        #: never burns its class's credits
        self.admission_gate = None

    # -- admission ----------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue ``req``; False = rejected (it can never fit a slot), with
        a :class:`PromptTooLongError` message in ``req.error``."""
        worst = len(req.prompt) + req.sampling.max_tokens
        if len(req.prompt) == 0:
            req.status, req.error = "rejected", "empty prompt"
        elif worst > self.max_len:
            err = PromptTooLongError(
                prompt_len=len(req.prompt),
                max_tokens=req.sampling.max_tokens,
                limit=self.max_len, source="serving slot",
                hint="trim the prompt or max_tokens, or raise max_len")
            req.status, req.error = "rejected", str(err)
        if req.status == "rejected":
            req.done.set()
            return False
        req.mark("queued")
        self.queue.append(req)
        return True

    @property
    def depth(self) -> int:
        return len(self.queue)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self.free) / self.slots

    def requeue_preempted(self, req: Request) -> None:
        """Put an evicted request back at the HEAD of the queue (it was
        already admitted once — it resumes before its class peers; the
        deficit selection still decides WHEN its class runs again)."""
        req.status = "preempted"
        self.queue.appendleft(req)

    # -- class selection ----------------------------------------------------
    def _eligible(self) -> list:
        """The queue minus the requests the admission gate defers: the
        population the deficit selection runs over this round."""
        if self.admission_gate is None:
            return list(self.queue)
        return [r for r in self.queue if self.admission_gate(r)]

    def _select_class(self, queue) -> tuple[Optional[int], Optional[dict]]:
        """Deficit-weighted pick among classes present in ``queue``
        (pure — commits nothing). Every backlogged class earns its
        weight per round until one can afford an admission (credit
        >= 1); richest wins, urgency breaks ties. Returns
        ``(class, credits-after-accrual)``."""
        present = {r.sampling.priority for r in queue}
        if not present:
            return None, None
        eff = {c: self._credit.get(c, 0.0) for c in present}
        while max(eff.values()) < 1.0:
            for c in eff:
                eff[c] += 2.0 ** (-max(int(c), 0))
        win = min(present, key=lambda c: (-eff[c], c))
        return win, eff

    def peek_candidate(self) -> Optional[Request]:
        """The request :meth:`next_admission` would try next (oldest of
        the deficit-selected class), committing no credit — the engine's
        preemption planner asks this whether a blocked urgent request
        justifies evicting a running batch one. A request the admission
        gate defers is never the candidate."""
        eligible = self._eligible()
        win, _ = self._select_class(eligible)
        if win is None:
            return None
        return next(r for r in eligible if r.sampling.priority == win)

    def blocks_needed(self, req: Request) -> int:
        """Worst-case NEW blocks ``req`` needs (gross of prefix sharing
        — the resume plan's price). A handoff request decodes elsewhere:
        the prefill tier writes its prompt and first token only, so it is
        priced P + 1, not P + max_tokens."""
        tail = 1 if req.handoff else req.sampling.max_tokens
        return -(-(len(req.prompt) + tail) // self.block_size)

    def preemption_victim(self, candidate: Request,
                          running) -> Optional[int]:
        """Pick the slot to evict for ``candidate``: among running
        requests with STRICTLY lower priority (higher class number), the
        lowest-priority one, least-progressed first (fewest decoded
        tokens = fewest spilled bytes = least wasted work if it never
        resumes). ``running`` is ``[(slot, Request), ...]``; None = no
        eligible victim (equal-or-higher-priority work never preempts,
        so uniform-priority traffic keeps the run-to-completion
        guarantee)."""
        pc = candidate.sampling.priority
        victims = [(s, r) for s, r in running
                   if r.sampling.priority > pc]
        if not victims:
            return None
        slot, _ = max(victims, key=lambda sr: (
            sr[1].sampling.priority, -len(sr[1].tokens), sr[0]))
        return slot

    def next_admission(self) -> Optional[tuple[Request, int]]:
        """Pop the deficit-selected class's oldest request into a free
        slot, or None (no queue, no slot, or not enough free blocks even
        after cache eviction: the chosen head waits).

        The admission plan is attached as ``req.admit``:
        ``{"table": [block ids], "first_uncached": int,
        "cow": (src, dst) | None}`` — blocks already allocated/shared,
        so the engine only maps them into its block tables. A request
        carrying a KV spill gets ``{"table": ..., "resume": True, ...}``
        instead: all-fresh blocks the engine refills from the host
        arena (no prefill)."""
        if not self.queue or not self.free:
            return None
        eligible = self._eligible()
        win, eff = self._select_class(eligible)
        if win is None:
            return None
        req = next(r for r in eligible if r.sampling.priority == win)
        plan = self._resume_plan(req) if req.spill is not None \
            else self._page_plan(req)
        if plan is None:
            return None
        # commit the deficit round only on a real admission (a blocked
        # head must not burn its class's credits while it waits)
        self._credit = eff
        self._credit[win] -= 1.0
        self.queue.remove(req)
        slot = self.free.pop(0)
        req.slot = slot
        req.status = "resuming" if req.spill is not None else "prefill"
        req.admit = plan
        req.mark("admit")
        return req, slot

    def _resume_plan(self, req: Request) -> Optional[dict]:
        """Price a spill-resume: the full worst case in FRESH blocks (no
        prefix sharing — the spilled bytes are this request's own
        history and flow back from the host arena), evicting cache
        leaves if the free list is short. None = cannot fit yet."""
        total = self.blocks_needed(req)
        if total > self.blocks.free_blocks:
            self.evictions_total += self.cache.evict(
                total - self.blocks.free_blocks)
        if total > self.blocks.free_blocks:
            return None
        fresh = [self.blocks.alloc() for _ in range(total)]
        req.cached_tokens = 0
        return {"table": fresh, "first_uncached": 0, "cow": None,
                "resume": True}

    def _page_plan(self, req: Request) -> Optional[dict]:
        """Price ``req`` in blocks net of the prefix cache, evicting
        LRU cache leaves if the free list is short; None = cannot fit
        yet. On success every table block is live (shared or freshly
        allocated) and charged to this request."""
        bs = self.block_size
        P = len(req.prompt)
        # a handoff request parks after its first token: reserving
        # max_tokens of decode room would only throttle the prefill tier
        tail = 1 if req.handoff else req.sampling.max_tokens
        total = -(-(P + tail) // bs)                      # worst case
        shared, partial = self.cache.match(req.prompt.tolist(),
                                           adapter=req.kv_adapter)
        shared = shared[:total]
        matched = len(shared) * bs + (partial[1] if partial else 0)
        # a FULL-prompt hit still recomputes the last token (its logits
        # seed decoding); the rewrite of position P-1 into a possibly
        # shared block is benign — same tokens, same values
        first_uncached = min(matched, P - 1)
        if partial is not None and first_uncached <= len(shared) * bs:
            partial = None                 # tail match buys nothing
            first_uncached = min(len(shared) * bs, P - 1)
        n_new = total - len(shared)        # incl. the CoW destination
        # pin the matched path BEFORE evicting: evict() reclaims any
        # refcount-1 trie leaf, and peeling a cached chain tail-first
        # can reach the very blocks we just matched — unpinned, they
        # would be freed (and possibly re-allocated) out from under
        # this request's table
        pins = list(shared)
        if partial is not None:
            pins.append(partial[0])
        for b in pins:
            self.blocks.share(b)
        if n_new > self.blocks.free_blocks:
            self.evictions_total += self.cache.evict(
                n_new - self.blocks.free_blocks)
        if n_new > self.blocks.free_blocks:
            for b in pins:                 # unwind; the trie ref remains
                self.blocks.release(b)
            return None
        fresh = [self.blocks.alloc() for _ in range(n_new)]
        if partial is not None:
            # the src pin only guarded eviction: the table never maps
            # the src (the engine copies it into fresh[0] this step)
            self.blocks.release(partial[0])
        table = shared + fresh
        cow = (partial[0], fresh[0]) if partial is not None else None
        req.cached_tokens = first_uncached
        return {"table": table, "first_uncached": first_uncached,
                "cow": cow}

    def release(self, slot: int, table) -> None:
        """Return a slot and every block its table maps (shared blocks
        just drop a holder; blocks the prefix cache adopted at insert
        stay cached)."""
        self.free.append(slot)
        for b in table:
            if b:
                self.blocks.release(int(b))
