"""Paged decode attention through block tables — the wrapper of
``csrc/paged_attention.cu``, its plain PyTorch version, and the
LSE-combine of two attention partials.

Counterpart of ``hetu_tpu/ops/paged_pallas.py``: ``paged_attention``
takes the layouts of ``paged_attention_pallas`` (:167, around
``_paged_kernel`` :86), the int8 arena lane (``k_scale``/``v_scale``)
included. On a CUDA tensor it launches the hand-written kernel or
raises; on a CPU tensor it runs :func:`paged_attention_reference`. There
is no fallback from one to the other.
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
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float] \
    + [ctypes.c_int] + [ctypes.c_void_p]
_INT8_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
    + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p]


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
        return attention_reference(q, k, v, causal=True, q_offset=q_offset,
                                   kv_offset=0, scale=scale,
                                   block_tables=block_tables,
                                   return_lse=return_lse)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if k_scale is None:
        return _rounded_p_reference(
            (q.float() * scale).to(q.dtype),
            gather_block_rows(k, block_tables),
            gather_block_rows(v, block_tables), q_offset, k.shape[1],
            return_lse)
    k = dequantize_int8(gather_block_rows(k, block_tables),
                        gather_block_rows(k_scale, block_tables))
    v = dequantize_int8(gather_block_rows(v, block_tables),
                        gather_block_rows(v_scale, block_tables))
    return attention_reference((q.float() * scale).to(q.dtype), k, v,
                               causal=True, q_offset=q_offset, kv_offset=0,
                               scale=1.0, return_lse=return_lse)


def _rounded_p_reference(qs, k, v, q_offset, page, return_lse):
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
    return (out, lse) if return_lse else out


def paged_attention(q, k, v, block_tables, q_offset, *,
                    k_scale=None, v_scale=None,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """Causal attention through per-slot block tables.

    - ``q``: ``(S, R, hq, d)`` fp32 or bf16; row ``i`` of slot ``s``
      attends absolute positions ``<= q_offset[s] + i`` (a negative
      offset: nothing);
    - ``k``/``v``: the arena ``(n_blocks, block_size, hkv, d)``, fp32 or
      bf16 like q — or int8 codes when ``k_scale``/``v_scale`` (fp32
      ``(n_blocks, block_size, hkv, 1)``) are given, dequantized per
      element as the kernel stages them;
    - ``block_tables``: ``(S, W)`` int32; ``q_offset``: ``(S,)`` int32.

    Returns ``out`` ``(S, R, hq, d)`` in q's dtype, plus the fp32 lse
    ``(S, hq, R)`` when ``return_lse``. The int8 lane counts its
    launches as ``paged_attention_int8``, the fp lanes as
    ``paged_attention``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: pass both k_scale and v_scale "
                         "(the int8 lane) or neither")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k, v, block_tables, q_offset,
                                         k_scale=k_scale, v_scale=v_scale,
                                         scale=scale, return_lse=return_lse)
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
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or block_tables.dtype != torch.int32:
        raise ValueError(f"block_tables must be int32 ({S}, W), got "
                         f"{block_tables.dtype} {tuple(block_tables.shape)}")
    if q_offset.shape != (S,) or q_offset.dtype != torch.int32:
        raise ValueError(f"q_offset must be int32 ({S},), got "
                         f"{q_offset.dtype} {tuple(q_offset.shape)}")
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a "
                             f"contiguous tensor on {q.device}")
    W = block_tables.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((S, hq, R), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dims = (S, R, hq, hkv, d, bs, W, float(scale),
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    rest = (_build.ptr(block_tables), _build.ptr(q_offset), _build.ptr(out),
            _build.ptr(lse))
    if quant:
        lib, fn = _build.kernel(NAME, "hetu_paged_attention_int8",
                                _INT8_ARGTYPES)
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(k_scale), _build.ptr(v_scale), *rest, *dims)
    else:
        lib, fn = _build.kernel(NAME, "hetu_paged_attention", _ARGTYPES)
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), *rest, *dims)
    _build.check(lib, err, "paged_attention launch")
    _build.count_launch(INT8 if quant else NAME)
    return (out, lse) if return_lse else out


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


__all__ = ["NEG_INF", "combine_attention_lse", "paged_attention",
           "paged_attention_reference"]
