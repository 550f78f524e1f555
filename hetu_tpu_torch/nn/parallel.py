"""Transformer layers at tp=1 (counterpart of ``hetu_tpu/nn/parallel.py``):
the training forward and the decode path.

Linear weights are stored in ``F.linear``'s ``(out, in)`` layout —
``hetu_tpu`` stores ``(in, out)``; ``models.convert.params_from_jax``
transposes. ``StackedBlocks`` is a ``ModuleList`` of per-layer blocks
(``blocks.{i}.…`` keys) in place of ``hetu_tpu``'s scan over a stacked
leading layer axis.

KV caches are updated IN PLACE (``index_copy_``) where the JAX code
returned a new, donated buffer. A cache is ``(k, v)`` or, for the int8
cache, ``(k codes, k scales, v codes, v scales)`` with one fp32 scale per
(position, kv head): new rows quantize on write
(``ops/quantization.py``). Attention over the paged arena goes through
:func:`~hetu_tpu_torch.ops.paged.paged_attention` (its int8 lane for the
int8 arena) and, in the packed-prefill mode,
:func:`~hetu_tpu_torch.ops.attention.attention_with_lse`
— the hand-written kernels on CUDA tensors, their plain versions on CPU
tensors. The dense cache (one-shot ``generate``) stays plain PyTorch, as
``hetu_tpu`` computes it in plain jnp, so ``generate`` is an oracle
independent of both kernels.

The training forward runs attention through
:func:`~hetu_tpu_torch.ops.attention.flash_attention` (the flash forward
and backward kernels on CUDA), and ``StackedBlocks.forward`` applies
``remat`` per layer with ``torch.utils.checkpoint`` (:func:`remat_policy`).
Linear layers cast x, W and b to the policy's compute dtype
(``core/dtypes.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn,
)

from hetu_tpu_torch.core.dtypes import Policy, autocast, current_policy
from hetu_tpu_torch.nn.layers import Embedding
from hetu_tpu_torch.ops.activations import gelu, swiglu
from hetu_tpu_torch.ops.attention import attention_reference, \
    attention_with_lse, flash_attention
from hetu_tpu_torch.ops.dropout import split_seed
from hetu_tpu_torch.ops.paged import combine_attention_lse, paged_attention
from hetu_tpu_torch.ops.quantization import (
    dequantize_int8, int8_w8a8_matmul, int8_w8a8_matmul_prequant,
    quantize_int8,
)
from hetu_tpu_torch.ops.rotary import apply_rotary, rope_tables


class ColumnParallelLinear(nn.Module):
    """Linear ``y = x W^T + b`` (``ColumnParallelLinear`` at tp=1), with
    x, W and b cast to the policy's compute dtype. In a 16-bit dtype the
    bias is added after the product is rounded, as ``jnp.matmul(x, w) +
    b`` does; in fp32 one fused ``addmm`` gives the same value."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, device=None, dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = current_policy().compute_dtype
        x, w = x.to(dt), self.weight.to(dt)
        if self.bias is None:
            return F.linear(x, w)
        if dt == torch.float32:
            return F.linear(x, w, self.bias.to(dt))
        return F.linear(x, w) + self.bias.to(dt)


class RowParallelLinear(ColumnParallelLinear):
    """``RowParallelLinear`` at tp=1: the same Linear (no partial sums to
    reduce on one device)."""


class VocabParallelEmbedding(Embedding):
    """``VocabParallelEmbedding`` at tp=1: a plain lookup."""


def lora_select(ids: torch.Tensor, n_pages: int, r: int, dtype):
    """The page masks of :func:`lora_apply`, the same for every projection
    and layer of one forward: ``sel`` (tokens, P r) is 1 on the r adapter
    rows of each token's own page and 0 elsewhere; ``live`` (b, s, 1) is
    True on tokens off the base page."""
    own = ids.reshape(-1, 1) == torch.arange(n_pages, device=ids.device)
    sel = own[:, :, None].expand(-1, n_pages, r).reshape(-1, n_pages * r)
    return sel.to(dtype), (ids != 0)[..., None]


def lora_apply(lora, name: str, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """The multi-tenant adapter delta of projection ``name`` added to its
    base output ``y`` (``hetu_tpu/nn/parallel.py:212-238``, batched-gather
    LoRA, "BGMV").

    ``lora`` is ``{"sel": …, "live": …, "pages": {name: {"A": (P, in,
    r), "B": (P, r, out)}}}``: :func:`lora_select`'s masks of the tokens'
    pages, made once a forward, and ONE layer's slice of the engine's
    adapter arena, the LoRA scaling folded into B
    (:meth:`StackedBlocks.decode` builds it for each layer). Page 0 is
    the base model's zero page: its tokens take ``y``
    back through a masked select (not ``y + 0.0``, which would turn a
    -0.0 into +0.0), so they stay bitwise base. ``lora`` None, or a
    projection the arena lacks, returns ``y`` with no op at all.

    ``hetu_tpu`` gathers each token's factors, ``A[ids]`` (tokens, in, r)
    and ``B[ids]`` (tokens, r, out), and contracts them in fp32. The port
    computes the same function without per-token copies of the factors,
    in two products: ``x A`` for all P pages at once, ``(tokens, P r)``
    (one matrix when A's pages are stored in-major, as the engine's arena
    stores them), kept only on each token's own page (``sel``), then one
    product with the pages' B stacked as ``(P r, out)``. Page ids stay
    data and every shape is static, so the engine's captured lanes never
    re-capture as adapters load, swap or mix."""
    if not lora or name not in lora["pages"]:
        return y
    ab = lora["pages"][name]
    a, b = ab["A"], ab["B"]                          # (P, in, r), (P, r, out)
    n_pages, d_in, r = a.shape
    sel, live = lora["sel"], lora["live"]
    xa = torch.mm(x.reshape(-1, d_in).to(a.dtype),
                  a.transpose(0, 1).reshape(d_in, n_pages * r))
    d = torch.mm(xa * sel, b.reshape(n_pages * r, -1)).view(y.shape)
    return torch.where(live, y + d.to(y.dtype), y)


class ParallelMLP(nn.Module):
    """GPT-2 MLP ``fc_out(gelu(fc_in(x)))`` (``gated=False``), or the
    Llama SwiGLU form ``fc_out(silu(gate_proj(x)) * up_proj(x))``
    (``gated=True``, ``hetu_tpu/nn/parallel.py:248-268``), each
    projection with its :func:`lora_apply` delta when ``lora`` is given
    (``:318-330``), and the W8A8 decode lane (``w8a8=True``, ``:332-370``):
    both FFN products contract int8 activations (per token) with int8
    weights (per output channel) in int32
    (``ops.quantization.int8_w8a8_matmul_prequant``). Biases, the
    activation and the adapter deltas stay in the compute dtype."""

    def __init__(self, features: int, hidden: int, *, bias: bool = True,
                 gated: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        self.gated = gated
        kw = dict(bias=bias, device=device, dtype=dtype)
        if gated:
            self.gate_proj = ColumnParallelLinear(features, hidden, **kw)
            self.up_proj = ColumnParallelLinear(features, hidden, **kw)
        else:
            self.fc_in = ColumnParallelLinear(features, hidden, **kw)
        self.fc_out = RowParallelLinear(hidden, features, **kw)

    def _names(self) -> tuple:
        return (("gate_proj", "up_proj") if self.gated else ("fc_in",)) \
            + ("fc_out",)

    @torch.no_grad()
    def prequantize(self, into: Optional[dict] = None) -> dict:
        """Quantize this MLP's weight matrices into the W8A8 lane's
        ``{name: {"q": int8 (out, in), "scale": fp32 (out, 1)}}`` tree:
        per output channel over ``in``, the contraction axis, as
        ``hetu_tpu`` quantizes its ``(in, out)`` weights over axis 0 (the
        codes are its codes, transposed). ``q.t()`` is the ``(in, out)``
        operand, column-major as ``torch._int_mm`` runs fastest on the
        card. ``into`` (an earlier tree of this MLP) re-quantizes the
        current weights in place, into the same tensors, so a captured
        lane that reads them by address serves the new weights."""
        tree = {} if into is None else into
        for name in self._names():
            q, scale = quantize_int8(getattr(self, name).weight, axis=-1)
            if into is None:
                tree[name] = {"q": q, "scale": scale}
            else:
                tree[name]["q"].copy_(q)
                tree[name]["scale"].copy_(scale)
        return tree

    def _w8a8_lane(self, x, wq=None, lora=None):
        """Both FFN products in int8 against ``wq`` (a :meth:`prequantize`
        tree), or against weights quantized in this call when ``wq`` is
        None; ``hetu_tpu``'s ``_w8a8_lane`` step for step. The bias
        follows the int8 product; the in-projections' deltas read ``x``
        (in the compute dtype), ``fc_out``'s reads the activated ``h``."""
        dt = current_policy().compute_dtype
        x = x.to(dt)

        def mm(v, name):
            if wq is not None:
                return int8_w8a8_matmul_prequant(
                    v, wq[name]["q"].t(), wq[name]["scale"], dtype=dt)
            return int8_w8a8_matmul(v, getattr(self, name).weight.to(dt).t(),
                                    dtype=dt)

        def lin(name):
            y = mm(x, name)
            bias = getattr(self, name).bias
            if bias is not None:
                y = y + bias.to(dt)
            return lora_apply(lora, name, x, y)

        if self.gated:
            h = swiglu(lin("gate_proj"), lin("up_proj"))
        else:
            h = gelu(lin("fc_in"))
        y = mm(h, "fc_out")
        if self.fc_out.bias is not None:
            y = y + self.fc_out.bias.to(dt)
        return lora_apply(lora, "fc_out", h, y)

    def forward(self, x: torch.Tensor, lora=None, *, w8a8: bool = False,
                w8a8_wq: Optional[dict] = None) -> torch.Tensor:
        """The fp lane, or with ``w8a8`` the W8A8 lane (against
        ``w8a8_wq``, a :meth:`prequantize` tree, when given)."""
        if w8a8:
            return self._w8a8_lane(x, wq=w8a8_wq, lora=lora)
        if self.gated:
            h = swiglu(lora_apply(lora, "gate_proj", x, self.gate_proj(x)),
                       lora_apply(lora, "up_proj", x, self.up_proj(x)))
        else:
            h = gelu(lora_apply(lora, "fc_in", x, self.fc_in(x)))
        return lora_apply(lora, "fc_out", h, self.fc_out(h))


def _scatter_rows(buf: torch.Tensor, rows: torch.Tensor, new: torch.Tensor,
                  keep: torch.Tensor) -> None:
    """Write ``new[i]`` at flat arena row ``rows[i]`` where ``keep[i]``,
    in place. Dropped entries rewrite arena row 0 with its own value (row
    0 belongs to the null block, which no live slot ever writes), so the
    scatter needs no host sync to filter them — the counterpart of JAX's
    out-of-bounds ``mode="drop"``."""
    flat = buf.view((-1,) + tuple(buf.shape[2:]))
    rows = torch.where(keep, rows, torch.zeros_like(rows))
    new = torch.where(keep.view((-1,) + (1,) * (new.dim() - 1)),
                      new.to(buf.dtype), flat[0])
    flat.index_copy_(0, rows, new)


def _cache_writes(kv_cache, k, v):
    """``(buffer, new rows)`` of one cache write: k and v, or for the int8
    cache their codes and scales, quantized per (position, kv head)."""
    if len(kv_cache) == 2:
        return list(zip(kv_cache, (k, v)))
    return list(zip(kv_cache, (*quantize_int8(k), *quantize_int8(v))))


def _arena(kv_cache) -> tuple:
    """``(k, v, scales)`` for :func:`paged_attention`: the int8 cache
    passes its codes and ``k_scale``/``v_scale``."""
    if len(kv_cache) == 2:
        return kv_cache[0], kv_cache[1], {}
    kq, ks, vq, vs = kv_cache
    return kq, vq, {"k_scale": ks, "v_scale": vs}


class ParallelAttention(nn.Module):
    """Causal multi-head attention with GQA and optional RoPE: the
    training forward and the decode path. With ``use_rope`` (Llama), q
    and k rotate at each token's own position before attention and
    before the cache write (``hetu_tpu/nn/parallel.py:602-606``,
    :751-754); without it (GPT-2), positions are learned and added in
    the embedding."""

    def __init__(self, embed_dim: int, num_heads: int, *,
                 num_kv_heads: Optional[int] = None,
                 head_dim: Optional[int] = None, bias: bool = True,
                 use_rope: bool = False, rope_theta: float = 10000.0,
                 max_positions: int = 4096, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        self.head_dim = head_dim or embed_dim // num_heads
        kw = dict(bias=bias, device=device, dtype=dtype)
        self.q_proj = ColumnParallelLinear(
            embed_dim, num_heads * self.head_dim, **kw)
        self.k_proj = ColumnParallelLinear(
            embed_dim, self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = ColumnParallelLinear(
            embed_dim, self.num_kv_heads * self.head_dim, **kw)
        self.out_proj = RowParallelLinear(
            num_heads * self.head_dim, embed_dim, **kw)
        self.use_rope = use_rope
        self.rope_theta = float(rope_theta)
        self.max_positions = int(max_positions)

    def _qkv(self, x, positions=None, lora=None):
        """q, k, v ``(b, s, heads, d)``, each with its :func:`lora_apply`
        delta when ``lora`` is given; with RoPE, q and k rotated at
        ``positions`` (b, s) (default ``arange(s)``) after it."""
        b, s, _ = x.shape
        q = lora_apply(lora, "q_proj", x, self.q_proj(x)).view(
            b, s, self.num_heads, self.head_dim)
        k = lora_apply(lora, "k_proj", x, self.k_proj(x)).view(
            b, s, self.num_kv_heads, self.head_dim)
        v = lora_apply(lora, "v_proj", x, self.v_proj(x)).view(
            b, s, self.num_kv_heads, self.head_dim)
        if self.use_rope:
            cos, sin = rope_tables(self.head_dim, self.max_positions,
                                   self.rope_theta, x.device)
            q = apply_rotary(q, cos, sin, positions)
            k = apply_rotary(k, cos, sin, positions)
        return q, k, v

    def forward(self, x, *, positions=None, segment_ids=None,
                dropout_rate: float = 0.0,
                dropout_seed: Optional[int] = None):
        """Training forward (``hetu_tpu/nn/parallel.py:441-510`` at tp=1,
        no cp): projections (RoPE at ``positions``), flash attention
        (dropout on the probabilities when ``dropout_seed`` is given),
        output projection."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x, positions)
        out = flash_attention(q, k, v, causal=True, segment_ids=segment_ids,
                              dropout_rate=dropout_rate, seed=dropout_seed)
        return self.out_proj(out.reshape(b, s, -1))

    def decode(self, x, kv_cache, *, positions, slot_mask=None,
               block_tables=None, pack=None, row_mask=None, lora=None):
        """Incremental decoding against a KV cache, updated in place.

        - dense (``block_tables`` None): ``kv_cache`` is ``(k_buf, v_buf)``
          of shape ``(b, max_len, hkv, d)``; every row writes its ``s``
          new entries at ``positions[0]`` (one shared index) and attends
          with the plain oracle (an int8 cache dequantizes to q's dtype
          first, as ``hetu_tpu`` does). With ``slot_mask`` (b,) (all
          True: it only selects this path) each row writes at its own
          ``positions[r, 0]`` and attends under its own causal offset (``hetu_tpu/nn/parallel.py:589-592, 629-637``: ragged
          ``generate``);
        - paged (``block_tables`` (b, W) and ``slot_mask`` (b,) bool):
          the caches are arenas ``(n_blocks, block_size, hkv, d)``; row
          ``r`` writes at its own ``positions[r, 0]`` through its table
          (rows with ``slot_mask`` False write nothing; the caller
          discards their output) and attends through the paged kernel
          (its int8 lane for the int8 arena); ``row_mask`` (b, s) bool
          refines ``slot_mask`` within a row's ``s`` positions
          (``hetu_tpu/nn/parallel.py:547-553, 613-620``): only its True
          cells write their KV. The verify lane needs it: a slot verifying
          fewer drafts than the lane's width must not write its trailing
          rows, whose positions may lie past the blocks its table owns
          (their block index is clamped to the table's last entry, which
          may be a live block);
        - packed prefill (``pack``): see :meth:`_decode_packed`.

        ``kv_cache`` may be the int8 4-tuple in every mode. ``lora`` (one
        layer's adapter pages and each token's page, see
        :func:`lora_apply`) adds the adapter deltas to q, k and v before
        RoPE and the cache write, and to ``out_proj`` (``hetu_tpu/nn/
        parallel.py:593-601, 704``). Returns the attention block's output
        ``(b, s, embed)``."""
        if row_mask is not None and (pack is not None
                                     or block_tables is None):
            raise ValueError("row_mask requires block_tables (the dense "
                             "cache writes contiguous rows)")
        if pack is not None:
            return self._decode_packed(x, kv_cache, positions=positions,
                                       block_tables=block_tables, pack=pack,
                                       lora=lora)
        b, s, _ = x.shape
        q, k, v = self._qkv(x, positions, lora)
        writes = _cache_writes(kv_cache, k, v)
        if block_tables is None:
            if slot_mask is None:
                cols = positions[0]                          # (s,)
                for buf, new in writes:
                    buf.index_copy_(1, cols, new.to(buf.dtype))
                q_offset = cols[0]
            else:
                # per-row writes into the flattened (b * max_len) rows
                q_offset = positions[:, 0]                   # (b,)
                max_len = kv_cache[0].shape[1]
                rows = (torch.arange(b, device=x.device)[:, None] * max_len
                        + positions[:, :1].long()
                        + torch.arange(s, device=x.device)[None, :])
                rows = rows.reshape(-1)
                for buf, new in writes:
                    flat = buf.view((-1,) + tuple(buf.shape[2:]))
                    flat.index_copy_(0, rows, new.reshape(
                        (b * s,) + tuple(new.shape[2:])).to(buf.dtype))
            k_buf, v_buf, scales = _arena(kv_cache)
            if scales:
                k_buf = dequantize_int8(k_buf, scales["k_scale"], q.dtype)
                v_buf = dequantize_int8(v_buf, scales["v_scale"], q.dtype)
            out = attention_reference(q, k_buf, v_buf, causal=True,
                                      q_offset=q_offset, kv_offset=0)
        else:
            if slot_mask is None:
                raise ValueError("block_tables requires slot_mask "
                                 "(per-row paged decode)")
            blk, W = kv_cache[0].shape[1], block_tables.shape[1]
            index = positions[:, 0].to(torch.int32)          # (b,)
            pos_rows = positions[:, :1].long() + torch.arange(
                s, device=x.device)[None, :]                 # (b, s)
            blk_ids = torch.gather(block_tables.long(), 1,
                                   (pos_rows // blk).clamp(0, W - 1))
            rows = (blk_ids * blk + pos_rows % blk).reshape(-1)
            if row_mask is None:
                keep = slot_mask[:, None].expand(b, s).reshape(-1)
            else:
                keep = (slot_mask[:, None] & row_mask).reshape(-1)
            for buf, new in writes:
                _scatter_rows(buf, rows, new.reshape(b * s, *new.shape[2:]),
                              keep)
            k_buf, v_buf, scales = _arena(kv_cache)
            out = paged_attention(q, k_buf, v_buf, block_tables, index,
                                  **scales)
        out = out.reshape(b, s, -1)
        return lora_apply(lora, "out_proj", out, self.out_proj(out))

    def _decode_packed(self, x, kv_cache, *, positions, block_tables, pack,
                       lora=None):
        """Packed-prefill mode: ``x`` is ONE ``(1, C, embed)`` row of C
        tokens from many requests, with the engine's per-slot
        ``block_tables`` (S, W), ``positions`` (1, C) and ``pack`` keys
        ``row_slot`` (C,) int32 (each token's slot: its table row),
        ``segment_ids`` (1, C) int32 (-1 on pads), ``hist`` (C,) (each
        token's chunk-start offset) and ``valid`` (C,) bool.

        Each token's attention splits into two disjoint parts that
        LSE-combine exactly: the intra-pack part (flash forward with
        segment isolation and causal masking — within one request's
        contiguous run, pack order is position order) and the
        arena-history part (paged attention over its slot's table,
        positions ``<= hist - 1``: earlier chunks and prefix-cache hits),
        which ``hetu_tpu`` computes over per-token copies of the tables
        (``hetu_tpu/nn/parallel.py:794-806``) and the port through
        ``row_slot``, so the kernel reads a run's history once for the
        whole run. KV writes are per-token scatters through the tables
        (pads drop). With the int8 arena the intra-pack part attends the
        pack's own ROUND-TRIPPED k/v, dequantized to q's dtype, as the
        per-token lane would read them back
        (``hetu_tpu/nn/parallel.py:776-779``), and the history part runs
        the paged kernel's int8 lane."""
        b, C, _ = x.shape
        q, k, v = self._qkv(x, positions, lora)
        blk, W = kv_cache[0].shape[1], block_tables.shape[1]
        pos = positions[0].long()                            # (C,)
        blk_ids = block_tables.long()[pack["row_slot"].long(),
                                      (pos // blk).clamp(0, W - 1)]
        rows = blk_ids * blk + pos % blk
        writes = _cache_writes(kv_cache, k, v)
        for buf, new in writes:
            _scatter_rows(buf, rows, new[0], pack["valid"])
        k_buf, v_buf, scales = _arena(kv_cache)
        if scales:
            (_, kq), (_, ks), (_, vq), (_, vs) = writes
            k = dequantize_int8(kq, ks, q.dtype)
            v = dequantize_int8(vq, vs, q.dtype)

        intra, lse_i = attention_with_lse(
            q, k, v, causal=True, segment_ids=pack["segment_ids"])
        hist_off = (pack["hist"] - 1).to(torch.int32)        # kpos <= hist-1
        hist, lse_h = paged_attention(q[0].unsqueeze(1).contiguous(), k_buf,
                                      v_buf, block_tables, hist_off,
                                      row_slot=pack["row_slot"],
                                      return_lse=True, **scales)
        hist = hist[:, 0][None]                              # (1, C, hq, d)
        lse_h = lse_h[:, :, 0].t()[None]                     # (1, hq, C)
        out = combine_attention_lse(intra, lse_i, hist, lse_h).reshape(
            b, C, -1)
        return lora_apply(lora, "out_proj", out, self.out_proj(out))


#: ops whose outputs selective remat keeps: the matmuls of the Linear
#: layers (no batch dims: ``dots_with_no_batch_dims_saveable``) and the
#: flash forward kernel, whose ``out``/``lse`` feed its backward
def _saved_ops():
    from hetu_tpu_torch.ops import flash  # noqa: F401  (registers the op)
    return {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.hetu_tpu_torch.flash_fwd.default}


def _selective_policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(name: str) -> Optional[Callable]:
    """Map a Strategy remat name to a ``torch.utils.checkpoint``
    ``context_fn`` (``hetu_tpu/nn/parallel.py:819``): ``"none"`` → None
    (no checkpoint), ``"full"`` → keep only the layer input,
    ``"selective"`` → keep the Linear matmul outputs and the flash
    forward's ``out``/``lse`` and recompute the rest (norms, GELU,
    bias adds, casts, layout copies), so the backward runs only the flash
    backward kernels. ``"offload"`` (host offload of remat'd activations)
    is not ported: JAX degrades it to full remat off TPU, and on the card
    it needs static pinned host buffers inside the captured step, which
    come with the memory work of hot strategy switching."""
    if name == "none":
        return None
    if name == "full":
        return noop_context_fn
    if name == "selective":
        return functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_selective_policy, _saved_ops()))
    if name == "offload":
        raise NotImplementedError(
            "remat='offload' (host offload of remat'd activations) is not "
            "ported: it needs static pinned host buffers inside the "
            "captured step and comes with the memory work of hot strategy "
            "switching")
    raise ValueError(f"remat must be none|full|selective|offload, got "
                     f"{name!r}")


def _run_block(block, policy: Policy, x, positions, segment_ids, seed):
    # the policy captured at forward time: a CUDA backward recomputes on
    # the autograd engine's own thread, which has none set
    with autocast(policy):
        return block(x, positions=positions, segment_ids=segment_ids,
                     dropout_seed=seed)


class StackedBlocks(nn.ModuleList):
    """N identical blocks (``blocks.{i}`` in the state dict). ``forward``
    runs them in order with per-layer remat; decode hands layer ``l`` its
    slice of the stacked caches."""

    def __init__(self, make_block: Callable[[], nn.Module],
                 num_layers: int):
        super().__init__([make_block() for _ in range(num_layers)])

    @property
    def num_layers(self) -> int:
        return len(self)

    @property
    def block(self) -> nn.Module:
        return self[0]

    @property
    def returns_aux(self) -> bool:
        """True when each block returns ``(x, aux)`` (an MoE block)."""
        return bool(getattr(self[0], "returns_aux", False))

    def forward(self, x, *, remat: str = "none",
                remat_mask: Optional[Sequence[bool]] = None,
                unroll: bool = False, positions=None, segment_ids=None,
                dropout_seed: Optional[int] = None):
        """``hetu_tpu/nn/parallel.py:898-990``: every layer in order, each
        under ``remat`` (see :func:`remat_policy`). ``remat_mask`` gives
        per-layer flags; its True layers take ``remat``'s policy, or
        ``"full"`` when ``remat`` is ``"none"``. ``unroll`` is accepted
        for the JAX signature and changes nothing (there is no scan).
        ``positions`` and ``segment_ids`` (b, s) reach every block, as the
        JAX scan passes them on (a packed batch restarts positions at each
        document: RoPE reads them, GPT-2's blocks ignore them);
        ``dropout_seed`` is split into one seed per layer. Blocks that
        return an auxiliary loss (:attr:`returns_aux`) make this return
        ``(x, aux)``, aux summed over the layers in fp32 from zero
        (``hetu_tpu/nn/parallel.py:941-988``), under every remat."""
        del unroll
        n = len(self)
        if remat_mask is not None:
            if len(remat_mask) != n:
                raise ValueError(f"remat_mask has {len(remat_mask)} entries "
                                 f"for {n} layers")
            flags = [bool(f) for f in remat_mask]
            name = remat if remat != "none" else "full"
        else:
            flags = [remat != "none"] * n
            name = remat
        context_fn = remat_policy(name) if any(flags) else None
        seeds = [None] * n if dropout_seed is None \
            else split_seed(dropout_seed, n)
        policy = current_policy()
        aux = torch.zeros((), dtype=torch.float32, device=x.device) \
            if self.returns_aux else None
        for blk, flag, seed in zip(self, flags, seeds):
            if flag:
                out = checkpoint(_run_block, blk, policy, x, positions,
                                 segment_ids, seed, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=context_fn)
            else:
                out = blk(x, positions=positions, segment_ids=segment_ids,
                          dropout_seed=seed)
            if aux is None:
                x = out
            else:
                x, a = out
                aux = aux + a
        return x if aux is None else (x, aux)

    def decode(self, x, caches, *, lora=None,
               w8a8_mask: Optional[Sequence[bool]] = None,
               w8a8_wq: Optional[Sequence[Optional[dict]]] = None,
               **kwargs):
        """``caches``: ``(k, v)`` or the int8 ``(k, k scales, v, v
        scales)``, each ``(layers, …)``; updated in place. ``lora`` is the
        engine's adapter arena, ``{"ids": (b, s) pages, "pages": {proj:
        {"A": (L, P, in, r), "B": (L, P, r, out)}}}``: layer ``l`` gets
        its ``(P, …)`` slice of every projection's pages
        (``hetu_tpu/nn/parallel.py:1105-1142``).

        ``w8a8_mask`` (one bool a layer) sends layer ``l``'s FFN through
        its W8A8 lane where it is True, against ``w8a8_wq[l]`` (that
        layer's ``prequantize`` tree) when ``w8a8_wq`` is given. JAX
        carries the mask as data through ``lax.cond``; here each flag is
        a Python bool, so a captured lane holds the chosen branch of each
        layer and no data-dependent branch. A layer whose flag is False,
        and every layer when ``w8a8_mask`` is None, gets no argument and
        no op it did not get before."""
        if w8a8_mask is not None and len(w8a8_mask) != len(self):
            raise ValueError(f"w8a8_mask has {len(w8a8_mask)} entries for "
                             f"{len(self)} layers")
        if lora:
            a = next(iter(lora["pages"].values()))["A"]
            sel, live = lora_select(lora["ids"], a.shape[1], a.shape[3],
                                    a.dtype)
        for layer, blk in enumerate(self):
            kw = kwargs
            if lora:
                kw = dict(kw, lora={"sel": sel, "live": live, "pages": {
                    name: {"A": ab["A"][layer], "B": ab["B"][layer]}
                    for name, ab in lora["pages"].items()}})
            if w8a8_mask is not None and w8a8_mask[layer]:
                kw = dict(kw, w8a8=True, w8a8_wq=None if w8a8_wq is None
                          else w8a8_wq[layer])
            x = blk.decode(x, tuple(c[layer] for c in caches), **kw)
        return x
