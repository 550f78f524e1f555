"""Radix-tree prefix cache over the paged KV pool.

RadixAttention (SGLang) observation: serving traffic is massively
prefix-shared — system prompts, few-shot preambles, multi-turn
histories — and KV for position ``p`` depends only on tokens
``0..p``, so any request whose prompt extends a cached prefix can MAP
the cached blocks instead of re-prefilling them. This module is the
host-side index that makes that lookup O(prompt):

- a trie whose nodes each own ONE whole block (``block_size`` token
  ids as the edge label, the arena block id as the payload);
- :meth:`match` walks the prompt: every fully-matching block is shared
  into the new request's table (refcount++ via the
  :class:`~hetu_tpu_torch.serving.kv_pool.BlockManager`), and a PARTIAL
  match inside the next block returns a copy-on-write source — the
  engine copies that block device-side and the request's prefill
  starts at the first uncached token;
- :meth:`insert` runs when a request finishes prefilling: its prompt's
  whole blocks become trie nodes (the trie takes a ref, so the blocks
  outlive the request);
- when the free list runs dry, :meth:`evict` LRU-reclaims LEAF nodes
  whose block nobody else holds (refcount == 1) — interior nodes wait
  until their subtree drains, so a cached prefix never dangles;
- every node carries the adapter uid its KV was written under
  (``serving/tenancy.py``): a match never crosses adapters, and
  :meth:`flush_adapter` drops a replaced or evicted adapter's spans;
- every node also carries the weight generation its KV was computed
  under: a weight swap (``ServingEngine.swap_params``) moves the cache
  to the new generation with :meth:`set_version`, which flushes the
  stale nodes, and :meth:`match` never returns a stale one.

Everything here is pure host bookkeeping: block ids reach the device
only as entries of the engine's block tables.
"""

from __future__ import annotations

import heapq
from typing import Optional, Sequence

from hetu_tpu_torch.serving.kv_pool import NULL_BLOCK, BlockManager


class _Node:
    """One cached whole block: edge label ``tokens`` (block_size ids),
    payload ``block`` (arena id), LRU stamp ``last_use``, the weight
    generation ``version`` its KV was computed under, and the
    ``adapter`` uid the forward that wrote its KV ran under (0 = base: an
    attention-targeting LoRA adapter writes DIFFERENT K/V for the same
    tokens, so its spans only ever match requests of the same adapter
    load; see ``serving/tenancy.py``)."""

    __slots__ = ("tokens", "block", "parent", "children", "last_use",
                 "version", "adapter")

    def __init__(self, tokens: tuple, block: int,
                 parent: Optional["_Node"], last_use: int,
                 version: int = 0, adapter: int = 0):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: list[_Node] = []
        self.last_use = last_use
        self.version = version
        self.adapter = adapter


def _common_prefix_len(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixCache:
    """Token-id trie mapping whole prompt blocks to arena block ids."""

    def __init__(self, block_size: int, blocks: BlockManager):
        self.block_size = int(block_size)
        self.blocks = blocks
        self._root = _Node((), NULL_BLOCK, None, 0)
        self._clock = 0
        #: weight generation the cached KV was computed under. A weight
        #: swap bumps it via :meth:`set_version`, which flushes every
        #: stale node, and :meth:`match` ALSO refuses stale nodes (a
        #: missed flush degrades to a cache miss, never to tokens
        #: prefilled under old weights)
        self.weight_version = 0
        self.flushes = 0

    # -- lookup -------------------------------------------------------------
    def match(self, tokens: Sequence[int], adapter: int = 0) -> tuple[
            list[int], Optional[tuple[int, int]]]:
        """Longest cached prefix of ``tokens``.

        Returns ``(shared, partial)``: ``shared`` is the list of arena
        block ids whose whole ``block_size``-token runs match (in
        order), ``partial`` is ``(src_block, n_rows)`` when the match
        continues ``n_rows`` tokens into one more cached block (the
        engine copies it — CoW — because the request will write its own
        rows there). Takes NO refs — the caller shares what it actually
        maps. Touches LRU stamps along the path.

        ``adapter`` is the requesting stream's KV-compat uid: only nodes
        written under the SAME adapter load match (0 = base)."""
        bs = self.block_size
        adapter = int(adapter)
        self._clock += 1
        shared: list[int] = []
        node = self._root
        i = 0
        while len(tokens) - i >= 1:
            key = tuple(tokens[i:i + bs])
            child = None
            if len(key) == bs:
                child = next(
                    (c for c in node.children if c.tokens == key
                     and c.version == self.weight_version
                     and c.adapter == adapter), None)
            if child is not None:
                child.last_use = self._clock
                shared.append(child.block)
                node = child
                i += bs
                continue
            # partial tail: the child sharing the longest token prefix
            # (stale-version nodes hold KV of old weights and a foreign
            # adapter's nodes its activations: never matchable, whole or
            # partial)
            best, best_len = None, 0
            for c in node.children:
                if c.version != self.weight_version \
                        or c.adapter != adapter:
                    continue
                n = _common_prefix_len(c.tokens, key)
                if n > best_len:
                    best, best_len = c, n
            if best is not None:
                best.last_use = self._clock
                return shared, (best.block, best_len)
            break
        return shared, None

    # -- insertion ----------------------------------------------------------
    def insert(self, tokens: Sequence[int], table: Sequence[int],
               adapter: int = 0) -> int:
        """Cache ``tokens``' whole blocks, backed by the arena blocks in
        ``table`` (the request's block table, position-ordered). New
        nodes take a ref on their block so it survives the request's
        release; blocks already cached (the shared ones) are left
        alone. ``adapter`` tags the nodes with the KV-compat uid the
        forward ran under (0 = base). Returns the number of new nodes."""
        bs = self.block_size
        adapter = int(adapter)
        self._clock += 1
        node = self._root
        added = 0
        for j in range(len(tokens) // bs):
            key = tuple(tokens[j * bs:(j + 1) * bs])
            child = next(
                (c for c in node.children if c.tokens == key
                 and c.version == self.weight_version
                 and c.adapter == adapter), None)
            if child is None:
                blk = int(table[j])
                if blk == NULL_BLOCK:
                    break
                child = _Node(key, blk, node, self._clock,
                              self.weight_version, adapter)
                node.children.append(child)
                self.blocks.share(blk)      # the trie now holds it too
                added += 1
            child.last_use = self._clock
            node = child
        return added

    # -- eviction -----------------------------------------------------------
    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks by dropping the LRU leaf nodes nobody
        else holds (block refcount == 1 — trie-only). Returns how many
        were actually freed; 0 means every cached block is pinned by a
        live request."""
        freed = 0
        # one DFS seeds a last_use min-heap of the current leaves;
        # parents are promoted lazily as their last child goes. Pinned
        # leaves (refcount > 1) are discarded at pop — refcounts can't
        # drop under us (the engine lock holds and we only release
        # victims), so a discarded pin never becomes evictable here
        heap: list[tuple[int, int, _Node]] = []
        stack = list(self._root.children)
        while stack:
            c = stack.pop()
            if c.children:
                stack.extend(c.children)
            else:
                heapq.heappush(heap, (c.last_use, id(c), c))
        while freed < n and heap:
            _, _, victim = heapq.heappop(heap)
            if victim.children or self.blocks.refs[victim.block] != 1:
                continue
            parent = victim.parent
            parent.children.remove(victim)
            self.blocks.release(victim.block)
            freed += 1
            if parent is not self._root and not parent.children:
                heapq.heappush(heap, (parent.last_use, id(parent),
                                      parent))
        return freed

    # -- weight-version lifecycle -------------------------------------------
    def set_version(self, version: int) -> int:
        """Adopt a new weight generation and flush every node cached
        under an older one (their KV encodes the old weights' forward).
        Returns the number of blocks released. No-op at the current
        version."""
        version = int(version)
        if version == self.weight_version:
            return 0
        self.weight_version = version
        return self.flush_stale()

    def flush_stale(self) -> int:
        """Drop every node whose ``version`` is not the current one,
        releasing the trie's ref on each block (a block a live slot still
        maps stays resident for that holder). A stale node takes its
        whole subtree with it: a child's KV attends into its parent's
        positions, so a fresh child under a stale parent is unreachable
        anyway (match walks from the root)."""
        freed = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            keep: list[_Node] = []
            for c in node.children:
                if c.version == self.weight_version:
                    keep.append(c)
                    stack.append(c)
                    continue
                sub = [c]
                while sub:
                    v = sub.pop()
                    sub.extend(v.children)
                    self.blocks.release(v.block)
                    freed += 1
            node.children = keep
        self.flushes += freed
        return freed

    # -- adapter lifecycle --------------------------------------------------
    def flush_adapter(self, adapter: int) -> int:
        """Drop every node written under adapter uid ``adapter`` (an
        evicted or replaced adapter's spans: already unmatchable — a new
        load gets a fresh uid — but still pinning blocks; this returns
        them eagerly instead of waiting on LRU pressure). Whole subtrees
        go together: insert walks same-adapter chains, so a node's
        descendants share its tag. Never flushes base (0). Returns the
        number of blocks released."""
        adapter = int(adapter)
        if adapter == 0:
            return 0
        freed = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            keep: list[_Node] = []
            for c in node.children:
                if c.adapter != adapter:
                    keep.append(c)
                    stack.append(c)
                    continue
                sub = [c]
                while sub:
                    v = sub.pop()
                    sub.extend(v.children)
                    self.blocks.release(v.block)
                    freed += 1
            node.children = keep
        self.flushes += freed
        return freed

    # -- introspection ------------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        n, stack = 0, list(self._root.children)
        while stack:
            c = stack.pop()
            n += 1
            stack.extend(c.children)
        return n
