"""Paged decode attention through block tables — the wrapper of
``csrc/paged_attention.cu``, its plain PyTorch version, and the
LSE-combine of two attention partials.

Counterpart of ``hetu_tpu/ops/paged_pallas.py``: ``paged_attention``
takes the layouts of ``paged_attention_pallas`` (:167, around
``_paged_kernel`` :86). On a CUDA tensor it launches the hand-written
kernel or raises; on a CPU tensor it runs
:func:`paged_attention_reference`. There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops.attention import NEG_INF, attention_reference

NAME = "paged_attention"
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float] \
    + [ctypes.c_int] + [ctypes.c_void_p]


def paged_attention_reference(q, k, v, block_tables, q_offset, *,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """The plain version: gather each slot's table view, then the dense
    causal oracle with per-slot offsets."""
    return attention_reference(q, k, v, causal=True, q_offset=q_offset,
                               kv_offset=0, scale=scale,
                               block_tables=block_tables,
                               return_lse=return_lse)


def paged_attention(q, k, v, block_tables, q_offset, *,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """Causal attention through per-slot block tables.

    - ``q``: ``(S, R, hq, d)``; row ``i`` of slot ``s`` attends absolute
      positions ``<= q_offset[s] + i`` (a negative offset: nothing);
    - ``k``/``v``: the arena ``(n_blocks, block_size, hkv, d)``, fp32 or
      bf16 like q;
    - ``block_tables``: ``(S, W)`` int32; ``q_offset``: ``(S,)`` int32.

    Returns ``out`` ``(S, R, hq, d)`` in q's dtype, plus the fp32 lse
    ``(S, hq, R)`` when ``return_lse``."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k, v, block_tables, q_offset,
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
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"paged_attention takes an fp32 or bf16 arena of "
                        f"q's dtype, got {q.dtype}/{k.dtype}/{v.dtype} "
                        f"(the int8 lane is not ported)")
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or block_tables.dtype != torch.int32:
        raise ValueError(f"block_tables must be int32 ({S}, W), got "
                         f"{block_tables.dtype} {tuple(block_tables.shape)}")
    if q_offset.shape != (S,) or q_offset.dtype != torch.int32:
        raise ValueError(f"q_offset must be int32 ({S},), got "
                         f"{q_offset.dtype} {tuple(q_offset.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v),
                    ("block_tables", block_tables), ("q_offset", q_offset)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a "
                             f"contiguous tensor on {q.device}")
    W = block_tables.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((S, hq, R), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    lib, fn = _build.kernel(NAME, "hetu_paged_attention", _ARGTYPES)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
             _build.ptr(block_tables), _build.ptr(q_offset),
             _build.ptr(out), _build.ptr(lse), S, R, hq, hkv, d, bs, W,
             float(scale), int(q.dtype == torch.bfloat16),
             _build.stream_ptr(q.device))
    _build.check(lib, err, "paged_attention launch")
    _build.count_launch(NAME)
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
