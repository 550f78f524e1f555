"""Symmetric int8 quantization (counterpart of
``hetu_tpu/ops/quantization.py:19-30``): plain PyTorch, bit for bit
JAX's arithmetic — the fp32 amax, ``scale = amax / 127`` (1.0 where the
amax is 0), ``x`` *divided* by the scale, ``torch.round`` (half to even,
like ``jnp.round``), then the clip to ±127. The int8 KV arena stores
these codes with one fp32 scale per (position, kv head).

The int4 and W8A8 functions are not ported yet.
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor, axis: int = -1):
    """Symmetric per-channel int8 over ``axis``. Returns ``(q int8,
    scale fp32)`` with ``scale`` keeping ``axis`` at size 1."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in fp32, then cast to ``dtype``. A zero scale (a
    never-written arena row) gives exact zeros."""
    return (q.float() * scale).to(dtype)


__all__ = ["dequantize_int8", "quantize_int8"]
