"""Block-paged KV cache: one fixed-shape arena on the device, indexed
through block tables (counterpart of ``hetu_tpu/serving/kv_pool.py``).

- the arena is ``(layers, n_blocks, block_size, kv_heads, head_dim)`` per
  K and V, allocated once; a request maps onto a per-slot BLOCK TABLE
  (``max_len/block_size`` wide, padded with the null block 0);
- blocks are refcounted (:class:`BlockManager`) so the radix prefix cache
  can map one physical block into many slots' tables;
- the fp32/bf16/int8 layouts are ``generation.init_kv_caches``'s: the
  int8 arena is four arrays (k codes, k scales, v codes, v scales) and
  its blocks are shared bit for bit like fp blocks.

The host spill arena and budget-derived sizing (``sized_for``) are not
ported yet.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from hetu_tpu_torch.models.generation import init_kv_caches

#: block table entries point here when a position is unallocated; the
#: null block is never handed out and never written by a live slot, so
#: its rows stay zeros (masked by every live row's causal offset anyway)
NULL_BLOCK = 0


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


class KVPool:
    """The paged arena plus its shape metadata. ``slots`` is the engine's
    concurrency (width of the control vectors and block tables); the
    arena holds ``n_blocks`` = the null block plus ``slots`` worst-case
    requests, in ``cache_dtype`` (default: the model's dtype;
    ``torch.int8`` for the quantized arena)."""

    def __init__(self, model, slots: int, max_len: int, block_size: int,
                 cache_dtype: Optional[torch.dtype] = None):
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
        self.n_blocks = 1 + self.slots * self.table_width
        self.cache_dtype = cache_dtype or model.dtype
        # the generation layout with (batch, max_len) := (n_blocks,
        # block_size); layer l's arena caches[i][l] is contiguous
        self.caches = init_kv_caches(model, self.n_blocks, self.block_size,
                                     self.cache_dtype)

    @property
    def quantized(self) -> bool:
        return len(self.caches) == 4

    def nbytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self.caches)
