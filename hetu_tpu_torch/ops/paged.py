"""Paged decode attention through block tables — the wrapper of
``csrc/paged_attention.cu``, its plain PyTorch version, and the
LSE-combine of two attention partials.

Counterpart of ``hetu_tpu/ops/paged_pallas.py``: ``paged_attention``
takes the layouts of ``paged_attention_pallas`` (:167, around
``_paged_kernel`` :86), the int8 arena lane (``k_scale``/``v_scale``)
included, plus ``row_slot``: q slot ``s`` reads table row
``row_slot[s]`` (the packed prefill's run-shared form). On a CUDA
tensor it launches the hand-written kernel, in the lane
:func:`paged_lane` picks, or raises; on a CPU tensor it runs
:func:`paged_attention_reference`. There is no fallback from one to the
other. The kernel is the dispatcher op ``hetu_tpu_torch::paged_attention``
(int8 lane included), with a fake for tracing (``torch.compile``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops.attention import (
    NEG_INF, attention_reference, gather_block_rows,
)
from hetu_tpu_torch.ops.quantization import dequantize_int8

NAME = "paged_attention"
INT8 = "paged_attention_int8"
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
    + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p]
_INT8_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 \
    + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p]

#: the kernel's lanes, in the numbering of ``csrc/paged_attention.cu``
LANES = ("split_kv", "tile_tc", "tile")
#: head dims of the split_kv lane and of the tile lane's tensor cores
LANE_HEAD_DIMS = (64, 128)
#: the most q rows per slot and kv head (R * g) the split_kv lane takes
SPLIT_MAX_ROWS = 4
#: keys per split of the split_kv lane
SPLIT_KEYS = 128


def paged_lane(dtype: torch.dtype, head_dim: int, rows_per_slot: int,
               run_shared: bool) -> str:
    """The lane a CUDA call of the paged kernel (#1) takes, decided
    before the launch from q's dtype, head_dim, the rows of one slot per
    kv head (``R * hq / hkv``) and whether the call passes ``row_slot``:

    - ``"split_kv"`` (decode): no ``row_slot``, at most
      :data:`SPLIT_MAX_ROWS` rows per slot, head_dim 64 or 128 — one
      warp per (slot, q row, split of :data:`SPLIT_KEYS` keys), the
      splits LSE-combined in order;
    - ``"tile_tc"``: bf16 q at head_dim 64 or 128 otherwise — 64-row
      tiles on the tensor cores, each run of rows that shares a table
      row reading its pages once;
    - ``"tile"``: the rest (fp32 q, other head dims) — the same runs in
      4-row tiles on the CUDA cores."""
    if head_dim in LANE_HEAD_DIMS and not run_shared \
            and rows_per_slot <= SPLIT_MAX_ROWS:
        return "split_kv"
    if dtype == torch.bfloat16 and head_dim in LANE_HEAD_DIMS:
        return "tile_tc"
    return "tile"


def paged_attention_reference(q, k, v, block_tables, q_offset, *,
                              k_scale=None, v_scale=None,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """The plain version: gather each slot's table view, then the dense
    causal oracle with per-slot offsets.

    Rounding follows the TPU kernel (``paged_pallas.py``). The scaled q
    is rounded to q's dtype before the fp32 product, as the kernel folds
    the scale into q (:215). The int8 lane follows the kernel, not
    ``hetu_tpu``'s gather twin: the gathered codes dequantize in fp32
    (:123-127). A bf16 arena's p, zeroed under the mask, is rounded to
    v's dtype before p v (:148), relative to the running max over the
    table's pages as the kernel's online softmax has it; the sum l stays
    fp32 and unrounded. An fp32 call is the dense oracle's formula
    unchanged."""
    if k_scale is None and q.dtype == v.dtype == torch.float32:
        out, lse = attention_reference(q, k, v, causal=True,
                                       q_offset=q_offset, kv_offset=0,
                                       scale=scale,
                                       block_tables=block_tables,
                                       return_lse=True)
    else:
        scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
        qs = (q.float() * scale).to(q.dtype)
        if k_scale is None:
            out, lse = _rounded_p_reference(
                qs, gather_block_rows(k, block_tables),
                gather_block_rows(v, block_tables), q_offset, k.shape[1])
        else:
            k = dequantize_int8(gather_block_rows(k, block_tables),
                                gather_block_rows(k_scale, block_tables))
            v = dequantize_int8(gather_block_rows(v, block_tables),
                                gather_block_rows(v_scale, block_tables))
            out, lse = attention_reference(qs, k, v, causal=True,
                                           q_offset=q_offset, kv_offset=0,
                                           scale=1.0, return_lse=True)
    # contiguous, as the kernel's outputs are
    out, lse = out.contiguous(), lse.contiguous()
    return (out, lse) if return_lse else out


def _rounded_p_reference(qs, k, v, q_offset, page):
    """Causal attention of the pre-scaled ``qs`` (S, R, hq, d) over the
    gathered (S, W * page, hkv, d) ``k``/``v`` (the bf16 arena lane), p
    rounded to v's dtype before p v as the TPU kernel's online softmax
    rounds it: relative to the running max over the table's pages
    (``paged_pallas.py:141-148``), then rescaled to the row max."""
    S, R, hq, _ = qs.shape
    L, g = k.shape[1], hq // k.shape[2]
    dev = qs.device
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(),
                          k.float().repeat_interleave(g, dim=2))
    qpos = q_offset.long()[:, None] + torch.arange(R, device=dev)[None, :]
    mask = (torch.arange(L, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]                  # (S, 1, R, L)
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=dev))
    lse = torch.logsumexp(logits, dim=-1)                   # (S, hq, R)
    m_run = torch.cummax(logits.unflatten(-1, (-1, page)).amax(-1),
                         dim=-1).values.repeat_interleave(page, dim=-1)
    p = torch.where(mask, torch.exp(logits - m_run), 0.0)
    w = torch.exp(m_run - m_run[..., -1:])       # each page's rescale
    l = (p * w).sum(-1).movedim(1, 2)[..., None]            # (S, R, hq, 1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float() * w,
                      v.float().repeat_interleave(g, dim=2))
    out = (pv / torch.where(l == 0, 1.0, l)).to(qs.dtype)
    return out, lse


def paged_attention(q, k, v, block_tables, q_offset, *,
                    k_scale=None, v_scale=None, row_slot=None,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """Causal attention through block tables.

    - ``q``: ``(S, R, hq, d)`` fp32 or bf16; row ``i`` of slot ``s``
      attends absolute positions ``<= q_offset[s] + i`` (a negative
      offset: nothing);
    - ``k``/``v``: the arena ``(n_blocks, block_size, hkv, d)``, fp32 or
      bf16 like q — or int8 codes when ``k_scale``/``v_scale`` (fp32
      ``(n_blocks, block_size, hkv, 1)``) are given, dequantized per
      element in fp32;
    - ``block_tables``: ``(S, W)`` int32, one table row per slot; or,
      with ``row_slot`` (``(S,)`` int32), any ``(n, W)`` whose row
      ``row_slot[s]`` slot ``s`` reads: the function is that of the
      per-slot tables ``block_tables[row_slot]``, and the kernel reads a
      run of slots that name one row once for the whole run (on the
      card, like the tables' page numbers, ``row_slot`` is not
      bounds-checked: reading it would wait for the device);
    - ``q_offset``: ``(S,)`` int32.

    Returns ``out`` ``(S, R, hq, d)`` in q's dtype, plus the fp32 lse
    ``(S, hq, R)`` when ``return_lse``. On the card the lane is
    :func:`paged_lane`'s; every lane counts one launch per call, the
    int8 arena's as ``paged_attention_int8``, the fp arenas' as
    ``paged_attention``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: pass both k_scale and v_scale "
                         "(the int8 lane) or neither")
    scale = float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    out, lse = paged_attention_op(q, k, v, block_tables, q_offset, k_scale,
                                  v_scale, row_slot, scale)
    return (out, lse) if return_lse else out


@torch.library.custom_op("hetu_tpu_torch::paged_attention", mutates_args=())
def paged_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       block_tables: torch.Tensor, q_offset: torch.Tensor,
                       k_scale: Optional[torch.Tensor],
                       v_scale: Optional[torch.Tensor],
                       row_slot: Optional[torch.Tensor], scale: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`paged_attention` as a dispatcher op: ``(out, lse)``."""
    return _paged_attention(q, k, v, block_tables, q_offset, k_scale,
                            v_scale, row_slot, scale)


@paged_attention_op.register_fake
def _paged_attention_fake(q, k, v, block_tables, q_offset, k_scale, v_scale,
                          row_slot, scale):
    S, R, hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((S, hq, R), dtype=torch.float32)


def _paged_attention(q, k, v, block_tables, q_offset, k_scale, v_scale,
                     row_slot, scale):
    if q.device.type == "cpu":
        if row_slot is not None:
            block_tables = block_tables.index_select(0, row_slot)
        return paged_attention_reference(q, k, v, block_tables, q_offset,
                                         k_scale=k_scale, v_scale=v_scale,
                                         scale=scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    S, R, hq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"paged_attention: arena {tuple(k.shape)}/"
                         f"{tuple(v.shape)} does not match q "
                         f"{tuple(q.shape)}")
    bs, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if d % 32 or d > 256:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 32 "
                         f"up to 256")
    if S > 65535:
        raise ValueError(f"paged_attention: {S} slots, at most 65535")
    quant = k_scale is not None
    arena_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != arena_dtype or v.dtype != arena_dtype:
        raise TypeError(f"paged_attention takes fp32 or bf16 q with an "
                        f"arena of q's dtype, or an int8 arena with "
                        f"scales; got {q.dtype}/{k.dtype}/{v.dtype}")
    tensors = [("q", q), ("k", k), ("v", v), ("block_tables", block_tables),
               ("q_offset", q_offset)]
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 \
                    or t.shape != k.shape[:3] + (1,):
                raise ValueError(f"{name} must be fp32 "
                                 f"{tuple(k.shape[:3]) + (1,)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            tensors.append((name, t))
    if block_tables.dim() != 2 or block_tables.dtype != torch.int32 \
            or (row_slot is None and block_tables.shape[0] != S):
        raise ValueError(f"block_tables must be int32 ({S}, W) (or (n, W) "
                         f"with row_slot), got {block_tables.dtype} "
                         f"{tuple(block_tables.shape)}")
    for name, t in (("q_offset", q_offset), ("row_slot", row_slot)):
        if t is not None and (t.shape != (S,) or t.dtype != torch.int32):
            raise ValueError(f"{name} must be int32 ({S},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if row_slot is not None:
        tensors.append(("row_slot", row_slot))
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a "
                             f"contiguous tensor on {q.device}")
    lane = paged_lane(q.dtype, d, R * (hq // hkv), row_slot is not None)
    if lane != "tile":
        # the split_kv and tile_tc lanes copy rows 16 bytes at a time
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"paged_attention: {name} is not 16-byte "
                                 f"aligned")
    W = block_tables.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((S, hq, R), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    n_split = -(-W * bs // SPLIT_KEYS)
    o_part = lse_part = None
    if lane == "split_kv" and n_split > 1:
        # each split's normalised out and lse, combined by the same call
        o_part = torch.empty((S * R * hq, n_split, d), dtype=torch.float32,
                             device=q.device)
        lse_part = torch.empty((S * R * hq, n_split), dtype=torch.float32,
                               device=q.device)
    def ptr(t):
        return None if t is None else _build.ptr(t)

    rest = (ptr(block_tables), ptr(row_slot), ptr(q_offset), ptr(out),
            ptr(lse), ptr(o_part), ptr(lse_part), S, R, hq, hkv, d, bs, W,
            SPLIT_KEYS, n_split, LANES.index(lane), float(scale),
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    if quant:
        lib, fn = _build.kernel(NAME, "hetu_paged_attention_int8",
                                _INT8_ARGTYPES)
        err = fn(ptr(q), ptr(k), ptr(v), ptr(k_scale), ptr(v_scale), *rest)
    else:
        lib, fn = _build.kernel(NAME, "hetu_paged_attention", _ARGTYPES)
        err = fn(ptr(q), ptr(k), ptr(v), *rest)
    _build.check(lib, err, f"paged_attention launch ({lane} lane)")
    _build.count_launch(INT8 if quant else NAME)
    return out, lse


def combine_attention_lse(o1, lse1, o2, lse2):
    """Merge two attention partials over DISJOINT key sets: ``o`` is
    ``(b, q, h, d)``, ``lse`` ``(b, h, q)``. A part with no live keys
    carries ``lse = NEG_INF`` and weighs 0; two empty parts give exact 0
    (the flash-decoding split-KV reduction)."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    den = w1 + w2
    den = torch.where(den == 0.0, torch.ones_like(den), den)

    def rowwise(w):                      # (b, h, q) → (b, q, h, 1)
        return w.movedim(1, 2)[..., None]

    out = (o1.float() * rowwise(w1 / den) + o2.float() * rowwise(w2 / den))
    return out.to(o1.dtype)


__all__ = ["LANES", "NEG_INF", "SPLIT_KEYS", "combine_attention_lse",
           "paged_attention", "paged_attention_op",
           "paged_attention_reference", "paged_lane"]
