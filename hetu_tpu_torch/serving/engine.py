"""Continuous-batching inference engine over the block-paged KV arena
(counterpart of ``hetu_tpu/serving/engine.py``).

One engine iteration (:meth:`ServingEngine.step`) is, in order:

1. admission: queued requests take free slots when their worst case fits
   in free blocks net of the radix prefix cache (a cached prefix is
   mapped into the slot's table; a partial tail block is copied — CoW);
2. the decode lane: one token for every active slot, each at its own
   position, through its block table (``ParallelAttention.decode``'s
   paged mode — the paged-attention kernel on the card);
3. the packed prefill lane: a ``prefill_chunk``-token budget filled FCFS
   from every admitting request, run as ONE ``(1, C)`` row — intra-pack
   flash attention with segment isolation, LSE-combined with each token's
   arena history (the flash and paged kernels on the card); requests
   whose prompt completes sample their first token.

``cache_dtype=torch.int8`` keeps the arena as int8 codes with fp32
scales per (position, kv head): rows quantize as they are written and
both lanes read the arena through the paged kernel's int8 lane.
Precision follows the thread-local policy (``core.autocast``) in force
where :meth:`step` runs, as ``hetu_tpu``'s engine follows its own.

This is the ``spec_depth=0`` case of ``hetu_tpu``'s fused step; its
``lax.cond``s are Python ``if``s on flags the host already knows, and the
arena is written in place where JAX donated it. ``lane_iters`` counts the
iterations that ran each lane (each runs every layer's attention once).
TTFT and TPOT come from ``Request.timing``.

Not ported yet, and not accepted as arguments: speculation,
tenancy/LoRA, the CP long-prompt lane, preemption/spill, replication,
streaming, ``swap_params``, W8A8 (off, as ``hetu_tpu``'s default), the
SLO engine, the watchdog and the telemetry registry.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from hetu_tpu_torch import resolve_device
from hetu_tpu_torch.models import generation
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.serving.kv_pool import BlockManager, KVPool
from hetu_tpu_torch.serving.prefix_cache import PrefixCache
from hetu_tpu_torch.serving.sampling import sample_slots
from hetu_tpu_torch.serving.scheduler import (
    Request, SamplingParams, Scheduler,
)


class ServingEngine:
    """Slot-pooled continuous-batching engine over one model.

    ``device=None`` means ``cuda`` (raises without a card unless
    ``device="cpu"``); the model must live on that device. Offline use:
    :meth:`generate_many`; online: :meth:`submit`, then :meth:`step`
    until the request is done (or :meth:`run_until_drained`).
    ``cache_dtype`` is the arena's (default: the model's dtype).
    ``record_first_logits`` keeps the fp32 logits each request's first
    token was sampled from on ``Request.first_logits``; it exists only
    for oracle checks that hold the engine against a reference."""

    def __init__(self, model, *, slots: int, max_len: int = 256,
                 prefill_chunk: int = 16, block_size: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 device=None, record_first_logits: bool = False):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, the engine was "
                             f"asked for {self.device}")
        if block_size is None:
            block_size = 16 if max_len % 16 == 0 else max_len
        if self.device.type == "cuda":
            # compile the kernels now, all at once, not inside the first
            # step (where the build would land in the first request's TTFT)
            _build.build()
        self.model = model
        self.pool = KVPool(model, slots, max_len, block_size, cache_dtype)
        self.record_first_logits = bool(record_first_logits)
        self.prefill_chunk = int(prefill_chunk)
        self.blocks = BlockManager(self.pool.n_blocks)
        self.prefix_cache = PrefixCache(self.pool.block_size, self.blocks)
        self.scheduler = Scheduler(
            self.pool.slots, self.pool.max_len, blocks=self.blocks,
            prefix_cache=self.prefix_cache,
            block_size=self.pool.block_size)
        self.seed = int(seed)

        S, W = self.pool.slots, self.pool.table_width
        self._pos = np.zeros(S, np.int64)        # next KV write index
        self._last_tok = np.zeros(S, np.int64)   # sampled, not yet fed
        self._active = np.zeros(S, bool)         # decoding slots
        self._temp = np.zeros(S, np.float32)
        self._topk = np.zeros(S, np.int64)
        self._topp = np.zeros(S, np.float32)
        self._bt = np.zeros((S, W), np.int32)    # per-slot block tables
        self._slot_req: list[Optional[Request]] = [None] * S
        # one generator per sampled request, seeded at admission
        self._gen: list[Optional[torch.Generator]] = [None] * S
        self._prefilling: list[dict] = []        # FCFS in-flight prefills
        self._next_id = 0
        self._lock = threading.RLock()
        #: engine iterations that ran each lane
        self.lane_iters = {"decode": 0, "prefill": 0}

    # -- requests -----------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None) -> Request:
        """Queue one request; returns the live :class:`Request` (status
        ``"rejected"`` with ``error`` set when it can never fit a slot)."""
        sampling = sampling or SamplingParams()
        with self._lock:
            req = Request(id=self._next_id,
                          prompt=np.asarray(prompt, np.int32).ravel(),
                          sampling=sampling, submit_s=time.monotonic())
            self._next_id += 1
            self.scheduler.submit(req)
        return req

    def result(self, req: Request,
               timeout: Optional[float] = None) -> Optional[dict]:
        """Wait for ``req`` to finish; None on timeout."""
        if not req.done.wait(timeout):
            return None
        return req.result()

    def has_work(self) -> bool:
        with self._lock:
            return bool(self.scheduler.queue) or bool(self._active.any()) \
                or bool(self._prefilling)

    # -- one iteration ------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration; False when there was nothing to do."""
        with self._lock, torch.no_grad():
            return self._step_locked()

    def _admit_locked(self) -> list[tuple[int, int]]:
        """Admit every admissible queued request: map its prefix-cache
        plan into the slot's block table and queue its prefill. Returns
        this iteration's CoW (src, dst) block pairs."""
        cows: list[tuple[int, int]] = []
        while True:
            adm = self.scheduler.next_admission()
            if adm is None:
                return cows
            req, slot = adm
            sp = req.sampling
            self._temp[slot] = sp.temperature
            self._topk[slot] = sp.top_k
            self._topp[slot] = sp.top_p
            self._gen[slot] = None
            if sp.temperature > 0:
                seed = sp.seed if sp.seed is not None else self.seed + req.id
                self._gen[slot] = torch.Generator(
                    device=self.device).manual_seed(int(seed))
            self._slot_req[slot] = req
            plan = req.admit
            self._bt[slot, :] = 0
            self._bt[slot, :len(plan["table"])] = plan["table"]
            if plan["cow"] is not None:
                cows.append(plan["cow"])
            self._prefilling.append({"req": req, "slot": slot,
                                     "off": plan["first_uncached"]})

    def _build_pack(self) -> dict:
        """Fill the C-token prefill budget FCFS over in-flight prefills
        (the oldest request first, the rest share what remains). Per-token
        operands: slot (the token's row of the engine's block tables; pads
        name slot 0 and read nothing), position, segment id (= the slot:
        one contiguous run per request, so pack order is position order
        within it; -1 on pads) and ``hist`` (the run's start offset: arena
        rows below it — earlier chunks, prefix hits — are the history
        part, which the paged kernel reads once per run)."""
        C = self.prefill_chunk
        pf = {"tokens": np.zeros(C, np.int64), "pos": np.zeros(C, np.int64),
              "slot": np.zeros(C, np.int32), "valid": np.zeros(C, bool),
              "seg": np.full(C, -1, np.int32), "hist": np.zeros(C, np.int32),
              "fin_row": [], "fin": [], "fills": [], "used": 0}
        used = 0
        for ent in self._prefilling:
            if used >= C:
                break
            req, off = ent["req"], ent["off"]
            n = int(min(C - used, len(req.prompt) - off))
            sl = slice(used, used + n)
            pf["tokens"][sl] = req.prompt[off:off + n]
            pf["pos"][sl] = np.arange(off, off + n)
            pf["slot"][sl] = ent["slot"]
            pf["valid"][sl] = True
            pf["seg"][sl] = ent["slot"]
            pf["hist"][sl] = off
            if off + n >= len(req.prompt):
                pf["fin_row"].append(used + n - 1)
                pf["fin"].append(ent)
            pf["fills"].append((ent, n))
            used += n
        pf["used"] = used
        return pf

    def _step_locked(self) -> bool:
        t0 = time.monotonic()
        cows = self._admit_locked()
        active = np.nonzero(self._active)[0]
        if not self._prefilling and active.size == 0 and not cows:
            return False
        pf = self._build_pack()
        model, dev = self.model, self.device
        caches = self.pool.caches

        # copy-on-write tails of partial prefix hits land before any write
        # (every arena array: k and v, and the int8 arena's scales)
        for src, dst in cows:
            for c in caches:
                c[:, dst].copy_(c[:, src])
        bt = torch.from_numpy(self._bt).to(dev)

        dec_toks = None
        if active.size:
            logits = generation.decode(
                model, torch.from_numpy(self._last_tok[:, None]).to(dev),
                torch.from_numpy(self._pos[:, None]).to(dev), caches,
                slot_mask=torch.from_numpy(self._active).to(dev),
                block_tables=bt)
            temp = np.where(self._active, self._temp, 0.0)
            dec_toks = sample_slots(logits[:, -1], temp, self._topk,
                                    self._topp, self._gen)
            self.lane_iters["decode"] += 1

        first_toks = None
        if pf["used"]:
            def up(a):
                return torch.from_numpy(a).to(dev)
            pos = up(pf["pos"])[None]
            h = model.embed(up(pf["tokens"])[None], positions=pos)
            h = model.blocks.decode(
                h, caches, positions=pos, block_tables=bt,
                pack={"row_slot": up(pf["slot"]),
                      "segment_ids": up(pf["seg"])[None],
                      "hist": up(pf["hist"]), "valid": up(pf["valid"])})
            if pf["fin"]:
                # first tokens only for the requests whose prompt ends in
                # this pack: the head runs on their last rows alone
                rows = up(np.asarray(pf["fin_row"], np.int64))
                lg = model.logits(model.hidden_norm(h[0].index_select(0,
                                                                      rows)))
                fs = [ent["slot"] for ent in pf["fin"]]
                first_toks = sample_slots(lg, self._temp[fs], self._topk[fs],
                                          self._topp[fs],
                                          [self._gen[s] for s in fs])
            self.lane_iters["prefill"] += 1

        now = time.monotonic()
        for r in active:
            self._on_token(int(r), int(dec_toks[r]), now)
        for ent, n in pf["fills"]:
            ent["off"] += n
            ent["req"].mark("prefill_chunk", dur_s=now - t0, ts_s=t0)
        for i, ent in enumerate(pf["fin"]):
            req, slot = ent["req"], ent["slot"]
            self._pos[slot] = len(req.prompt)
            self._active[slot] = True
            req.status = "decode"
            req.first_token_s = now
            req.mark("first_token", ts_s=now)
            # the finished prompt's whole blocks enter the radix cache
            self.prefix_cache.insert(req.prompt.tolist(), self._bt[slot])
            if self.record_first_logits:
                req.first_logits = lg[i]
            self._on_token(slot, int(first_toks[i]), now)
            self._prefilling.remove(ent)
        return True

    def _on_token(self, slot: int, tok: int, now: float) -> None:
        """Record one sampled token for ``slot``: append, advance the
        cursor (it moves once the token is FED), finish on EOS/budget."""
        req = self._slot_req[slot]
        req.tokens.append(tok)
        self._last_tok[slot] = tok
        if req.status == "decode" and len(req.tokens) > 1:
            self._pos[slot] += 1
        sp = req.sampling
        if (sp.eos_id is not None and tok == sp.eos_id) \
                or len(req.tokens) >= sp.max_tokens:
            self._finish(slot, now)

    def _finish(self, slot: int, now: float) -> None:
        req = self._slot_req[slot]
        req.status = "done"
        req.finish_s = now
        req.mark("finish", ts_s=now)
        self._active[slot] = False
        # an idle slot still rides the decode lane (output discarded):
        # at position 0 its attention reads one page, not its last
        # request's whole history
        self._pos[slot] = 0
        self._slot_req[slot] = None
        self._gen[slot] = None
        # drop this slot's hold on every block it mapped; blocks the
        # prefix cache adopted stay resident (trie refs), the rest free
        self.scheduler.release(slot, table=self._bt[slot])
        self._bt[slot, :] = 0
        req.done.set()

    # -- run loops ----------------------------------------------------------
    def run_until_drained(self, max_steps: int = 1_000_000) -> int:
        """Drive :meth:`step` until queue and slots are empty; returns the
        number of iterations run."""
        n = 0
        while self.has_work():
            if n >= max_steps:
                raise RuntimeError(f"serving engine not drained after "
                                   f"{max_steps} iterations")
            self.step()
            n += 1
        return n

    def generate_many(
            self, prompts: Sequence[Sequence[int]],
            sampling: Union[SamplingParams, Sequence[SamplingParams],
                            None] = None) -> list[list[int]]:
        """Submit every prompt, run to drain, return per-request tokens in
        submission order. Arrival order and slot assignment do not change
        any request's tokens."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling or SamplingParams()] * len(prompts)
        reqs = [self.submit(p, sp) for p, sp in zip(prompts, sampling)]
        bad = [r for r in reqs if r.status == "rejected"]
        if bad:
            with self._lock:
                for r in reqs:
                    if r.status == "queued":
                        self.scheduler.queue.remove(r)
                        r.status = "cancelled"
                        r.error = "batch aborted: sibling rejected"
                        r.done.set()
            raise ValueError(
                f"{len(bad)} request(s) rejected at admission: "
                + "; ".join(f"#{r.id}: {r.error}" for r in bad[:3]))
        self.run_until_drained()
        return [list(r.tokens) for r in reqs]
