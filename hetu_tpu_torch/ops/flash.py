"""Flash attention forward with LSE — the wrapper of
``csrc/flash_fwd.cu`` and its plain PyTorch version.

Counterpart of ``hetu_tpu/ops/flash_pallas.py`` ``_flash_fwd`` (:257)
around ``_fwd_kernel`` (:184), in the same ``(b, h, s, d)`` layouts. On a
CUDA tensor :func:`flash_attention_fwd` launches the hand-written kernel
or raises; on a CPU tensor it runs :func:`flash_attention_fwd_reference`.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops.attention import attention_reference

NAME = "flash_fwd"
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def flash_attention_fwd_reference(q, k, v, q_seg, kv_seg, *, causal: bool,
                                  scale: float, q_offset: int = 0,
                                  kv_offset: int = 0):
    """The plain version: ``attention_reference(return_lse=True)`` in the
    kernel's layouts — q (b, hq, sq, d), k/v (b, hkv, sk, d), seg ids
    (b, s) or None; returns out (b, hq, sq, d) and lse (b, hq, sq)."""
    out, lse = attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, segment_ids=q_seg, kv_segment_ids=kv_seg,
        scale=scale, return_lse=True, q_offset=q_offset,
        kv_offset=kv_offset)
    return out.transpose(1, 2), lse


def flash_attention_fwd(q, k, v, q_seg: Optional[torch.Tensor],
                        kv_seg: Optional[torch.Tensor], *, causal: bool,
                        scale: float, q_offset: int = 0, kv_offset: int = 0,
                        dropout_rate: float = 0.0):
    """Flash forward: out (b, hq, sq, d) in q's dtype and fp32 lse
    (b, hq, sq). ``q_offset``/``kv_offset`` are static absolute offsets
    of the causal mask. Dropout is not ported: a rate > 0 raises."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attention_fwd: the dropout lane of the TPU kernel is "
            "not ported yet")
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(
            q, k, v, q_seg, kv_seg, causal=causal, scale=scale,
            q_offset=q_offset, kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    b, hq, sq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if d % 32 or d > 256:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 32 "
                         f"up to 256")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes fp32 or bf16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be a "
                             f"contiguous tensor on {q.device}")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both q_seg and kv_seg, or neither")
    if q_seg is not None:
        for name, t, n in (("q_seg", q_seg, sq), ("kv_seg", kv_seg, sk)):
            if t.shape != (b, n) or t.dtype != torch.int32 \
                    or t.device != q.device or not t.is_contiguous():
                raise ValueError(f"flash_attention_fwd: {name} must be a "
                                 f"contiguous int32 ({b}, {n}) tensor on "
                                 f"{q.device}")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib, fn = _build.kernel(NAME, "hetu_flash_fwd", _ARGTYPES)
    null = ctypes.c_void_p(None)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
             _build.ptr(q_seg) if q_seg is not None else null,
             _build.ptr(kv_seg) if kv_seg is not None else null,
             _build.ptr(out), _build.ptr(lse), b, hq, hkv, sq, sk, d,
             float(scale), int(bool(causal)), int(q_offset), int(kv_offset),
             int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(lib, err, "flash_attention_fwd launch")
    _build.count_launch(NAME)
    return out, lse
