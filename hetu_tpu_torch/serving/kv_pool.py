"""Block-paged KV cache: one fixed-shape arena on the device, indexed
through block tables (counterpart of ``hetu_tpu/serving/kv_pool.py``).

- the arena is ``(layers, n_blocks, block_size, kv_heads, head_dim)`` per
  K and V, allocated once; a request maps onto a per-slot BLOCK TABLE
  (``max_len/block_size`` wide, padded with the null block 0);
- blocks are refcounted (:class:`BlockManager`) so the radix prefix cache
  can map one physical block into many slots' tables;
- the fp32/bf16/int8 layouts are ``generation.init_kv_caches``'s: the
  int8 arena is four arrays (k codes, k scales, v codes, v scales) and
  its blocks are shared bit for bit like fp blocks;
- :meth:`KVPool.sized_for` sizes the arena from an HBM budget through the
  byte ledger (``engine/memory.py``), the same arithmetic as
  ``hetu_tpu``'s, and ``n_blocks=`` sets it directly (an oversubscribed
  arena: more slots than worst-case requests);
- resumable preemption parks a request's blocks in host memory
  (:class:`SpillEntry` in a :class:`HostSpillArena`, its bytes in a
  :class:`SpillStore` allocated once) and maps them back into fresh
  blocks on resume.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from hetu_tpu_torch.engine.memory import size_kv_pool
from hetu_tpu_torch.models.generation import init_kv_caches

#: block table entries point here when a position is unallocated; the
#: null block is never handed out and never written by a live slot, so
#: its rows stay zeros (masked by every live row's causal offset anyway)
NULL_BLOCK = 0


def cache_dtype_name(dtype) -> str:
    """Canonical ledger name for a cache dtype (fp32 | bf16 | int8)."""
    if dtype == torch.int8:
        return "int8"
    if dtype == torch.bfloat16:
        return "bf16"
    return "fp32"


class BlockManager:
    """Host-side free list + refcounts over the paged arena. A block's
    refcount is its number of holders: slots whose table maps it, plus
    the prefix-cache trie when a node caches it. Blocks are never zeroed
    on reuse (a reused block is written before it is attended)."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least one non-null block")
        self.n_blocks = int(n_blocks)
        self.free: deque[int] = deque(range(1, self.n_blocks))
        self.refs = np.zeros(self.n_blocks, np.int32)

    def alloc(self) -> Optional[int]:
        """Pop a free block (refcount 1), or None when the pool is dry."""
        if not self.free:
            return None
        b = self.free.popleft()
        self.refs[b] = 1
        return b

    def share(self, block: int) -> None:
        """Add a holder to an already-live block (prefix hit / trie)."""
        if block == NULL_BLOCK:
            raise ValueError("cannot share the null block")
        if self.refs[block] <= 0:
            raise ValueError(f"share of dead block {block}")
        self.refs[block] += 1

    def release(self, block: int) -> None:
        """Drop one holder; the block frees when the last one leaves."""
        if block == NULL_BLOCK:
            return
        self.refs[block] -= 1
        if self.refs[block] < 0:
            raise ValueError(f"double release of block {block}")
        if self.refs[block] == 0:
            self.free.append(block)

    @property
    def free_blocks(self) -> int:
        return len(self.free)

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - 1 - len(self.free)


class KVPool:
    """The paged arena plus its shape metadata. ``slots`` is the engine's
    concurrency (width of the control vectors and block tables); the
    arena holds ``n_blocks`` blocks, by default the null block plus
    ``slots`` worst-case requests, in ``cache_dtype`` (default: the
    model's dtype; ``torch.int8`` for the quantized arena). An explicit
    ``n_blocks`` below that oversubscribes the slots: short requests
    reserve only their own blocks, and admission's free-block gate keeps
    it sound. It must hold one worst-case request."""

    def __init__(self, model, slots: int, max_len: int, block_size: int,
                 cache_dtype: Optional[torch.dtype] = None,
                 n_blocks: Optional[int] = None):
        if max_len > model.cfg.max_positions:
            raise ValueError(
                f"pool max_len {max_len} exceeds the model's "
                f"max_positions {model.cfg.max_positions}")
        if max_len % block_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of block_size "
                f"{block_size}")
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.block_size = int(block_size)
        self.table_width = self.max_len // self.block_size
        self.n_blocks = int(n_blocks) if n_blocks else (
            1 + self.slots * self.table_width)
        if self.n_blocks <= self.table_width:
            raise ValueError(
                f"n_blocks {self.n_blocks} cannot hold even one "
                f"worst-case request ({self.table_width} blocks "
                f"+ the null block)")
        self.cache_dtype = cache_dtype or model.dtype
        #: weight generation of the KV the arena holds: the engine's
        #: ``swap_params`` bumps it with its own
        self.weight_version = 0
        # the generation layout with (batch, max_len) := (n_blocks,
        # block_size); layer l's arena caches[i][l] is contiguous
        self.caches = init_kv_caches(model, self.n_blocks, self.block_size,
                                     self.cache_dtype)

    @classmethod
    def sized_for(cls, model, *, hbm_budget_bytes: float, max_len: int,
                  cache_dtype: Optional[torch.dtype] = None,
                  block_size: Optional[int] = None) -> "KVPool":
        """The largest pool the HBM budget allows: whole worst-case slots
        (``engine.memory.size_kv_pool``, tp 1), so admission can never
        strand a request that passed the budget gate. ``block_size``
        defaults to one block a slot."""
        slots = size_kv_pool(
            model.cfg, hbm_budget_bytes=hbm_budget_bytes, max_len=max_len,
            cache_dtype=cache_dtype_name(cache_dtype or model.dtype))
        return cls(model, slots, max_len, block_size or max_len,
                   cache_dtype)

    @property
    def quantized(self) -> bool:
        return len(self.caches) == 4

    def nbytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self.caches)


# -- resumable preemption: the host spill arena ------------------------------


@dataclasses.dataclass
class SpillEntry:
    """One preempted request's KV, parked in host memory.

    ``data`` holds the request's first ``n_blocks`` table blocks per
    arena leaf (CPU tensors ``(layers, n_blocks, block_size, ...)``,
    pinned when spilled from the card; four leaves for the int8 arena).
    Valid rows are ``0..pos-1``; the tail block's trailing rows ride
    along. Resume maps the data back into freshly allocated arena
    blocks — zero prefill work — provided the target pool speaks the
    same layout and the same ``weight_version`` (KV encodes the forward
    of the weights that wrote it). ``gen_state`` is the sampled
    request's ``torch.Generator`` state at spill time, so its draws
    resume exactly where they stopped (None when greedy)."""

    req_id: int
    data: tuple                      # per-leaf CPU tensors (L, nb, bs, ..)
    n_blocks: int
    block_size: int
    pos: int                         # next KV write index at spill time
    last_tok: int                    # sampled, not yet fed
    tokens: list                     # emitted so far (replayed on a
    #                                  cross-engine resume's Request)
    weight_version: int
    traceparent: Optional[str] = None  # originating trace context: a
    #                                  resume on another engine adopts
    #                                  it, so both engines' spans share
    #                                  one trace_id
    gen_state: Optional[torch.Tensor] = None
    adapter: int = 0                 # adapter KV-compat uid the forward
    #                                  ran under (0 = base; see
    #                                  serving/tenancy.py): resuming a
    #                                  tenant's KV under another (or a
    #                                  reloaded) adapter would splice two
    #                                  adapters' activations

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.data)

    def compatible_with(self, pool: KVPool, weight_version: int,
                        adapter: int = 0) -> bool:
        """Can this spill resume into ``pool`` at ``weight_version`` under
        adapter KV-compat uid ``adapter``?"""
        if self.weight_version != int(weight_version) \
                or self.adapter != int(adapter) \
                or self.block_size != pool.block_size:
            return False
        if len(self.data) != len(pool.caches):
            return False
        return all(a.shape[0] == c.shape[0]
                   and tuple(a.shape[2:]) == tuple(c.shape[2:])
                   and a.dtype == c.dtype
                   for a, c in zip(self.data, pool.caches))


class HostSpillArena:
    """Bounded host-memory parking lot for preempted requests' KV.

    Capacity is counted in ARENA BLOCKS (the unit the device pool
    allocates and ``engine.memory.size_spill_arena`` prices from a host
    byte budget), so the preemption planner gates an eviction with the
    arithmetic the resume is charged. ``max_blocks=None`` = unbounded."""

    def __init__(self, max_blocks: Optional[int] = None):
        self.max_blocks = int(max_blocks) if max_blocks else None
        self._entries: dict[int, SpillEntry] = {}
        self.blocks_held = 0
        self.spilled_total = 0           # host ledgers
        self.resumed_total = 0

    def can_fit(self, n_blocks: int) -> bool:
        return self.max_blocks is None \
            or self.blocks_held + int(n_blocks) <= self.max_blocks

    def put(self, entry: SpillEntry) -> None:
        if not self.can_fit(entry.n_blocks):
            raise ValueError(
                f"spill arena full: {self.blocks_held} + "
                f"{entry.n_blocks} blocks exceed max_blocks="
                f"{self.max_blocks}")
        if entry.req_id in self._entries:
            raise ValueError(f"request {entry.req_id} already spilled")
        self._entries[entry.req_id] = entry
        self.blocks_held += entry.n_blocks
        self.spilled_total += entry.n_blocks

    def pop(self, req_id: int, *, resumed: bool = True
            ) -> Optional[SpillEntry]:
        """Remove an entry: ``resumed=True`` counts it in the resume
        ledger (a real map-back); ``resumed=False`` is a detach (the
        request left for another engine, whose resume counts it)."""
        entry = self._entries.pop(req_id, None)
        if entry is not None:
            self.blocks_held -= entry.n_blocks
            if resumed:
                self.resumed_total += entry.n_blocks
        return entry

    def get(self, req_id: int) -> Optional[SpillEntry]:
        return self._entries.get(req_id)

    def __contains__(self, req_id: int) -> bool:
        return req_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)


class SpillStore:
    """Reusable host buffers for spilled blocks: one flat buffer per arena
    leaf, ``max_blocks`` blocks long, allocated once (pinned when
    ``pin``), so a spill's device-to-host copy lands in memory that is
    already pinned and the host budget bounds the bytes pinned for it.

    An entry takes ``nb`` consecutive blocks (first fit) and sees them as
    contiguous tensors in the arena's ``(layers, nb, block_size, ...)``
    layout; :meth:`release` gives them back. ``take`` returns None when
    no run of ``nb`` free blocks exists (the caller allocates its own)."""

    def __init__(self, caches, max_blocks: int, pin: bool):
        self.max_blocks = int(max_blocks)
        # per leaf: its buffer and one block's shape across the layers
        self._leaves = [
            (torch.empty(self.max_blocks * c[:, 0].numel(), dtype=c.dtype,
                         pin_memory=pin), c.shape[0], tuple(c.shape[2:]))
            for c in caches]
        self._free = [(0, self.max_blocks)]   # (start, length), sorted

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b, _, _ in self._leaves)

    def take(self, nb: int) -> Optional[tuple]:
        for i, (start, n) in enumerate(self._free):
            if n >= nb:
                self._free[i:i + 1] = [(start + nb, n - nb)] if n > nb \
                    else []
                return tuple(self._view(leaf, start, nb)
                             for leaf in self._leaves)
        return None

    def _view(self, leaf, start: int, nb: int) -> torch.Tensor:
        buf, layers, rest = leaf
        per = buf.numel() // self.max_blocks
        return buf[start * per:(start + nb) * per].view(layers, nb, *rest)

    def owns(self, data: tuple) -> bool:
        return data[0].untyped_storage().data_ptr() \
            == self._leaves[0][0].untyped_storage().data_ptr()

    def release(self, data: tuple) -> None:
        """Give back the blocks behind ``data`` (a :meth:`take` result)."""
        per = self._leaves[0][0].numel() // self.max_blocks
        run = (data[0].storage_offset() // per, data[0].shape[1])
        merged = []
        for start, n in sorted(self._free + [run]):
            if merged and merged[-1][0] + merged[-1][1] == start:
                merged[-1] = (merged[-1][0], merged[-1][1] + n)
            else:
                merged.append((start, n))
        self._free = merged
