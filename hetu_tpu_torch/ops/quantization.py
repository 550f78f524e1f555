"""Symmetric int8 and int4 quantization and the int8 matmuls
(counterpart of ``hetu_tpu/ops/quantization.py``): plain PyTorch, bit
for bit JAX's arithmetic — the fp32 amax, ``scale = amax / 127`` (``/
7`` for int4; 1.0 where the amax is 0), ``x`` *divided* by the scale,
``torch.round`` (half to even, like ``jnp.round``), then the clip to ±127
(±7). The int8 KV arena stores these codes with one fp32 scale per
(position, kv head).

The matmuls keep ``hetu_tpu``'s operand layout: the weight is ``(in,
out)`` and its scales run per output channel, ``(1, out)``. The port's
Linear layers store ``(out, in)`` and pass transposed views
(``nn.parallel.ParallelMLP.prequantize``).

- ``int8_matmul`` (W8A16): the weight dequantized to the compute dtype,
  then an ordinary product.
- ``int8_w8a8_matmul`` / ``int8_w8a8_matmul_prequant`` (W8A8, the
  decode FFN's quantized-compute lane): the activations quantize per
  token, the int8×int8 contraction accumulates in int32
  (:func:`int8_mm`: exact, so the output equals JAX's bit for bit for
  equal inputs), and one rank-1 rescale ``acc * x_scale * w_scale``, in
  that order, gives the output. JAX contracts with ``lax.dot_general``
  outside any Pallas kernel; the port's contraction is ``torch._int_mm``
  (cuBLASLt's int8 tensor-core GEMM on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: ``torch._int_mm`` on CUDA refuses 16 rows or fewer (PyTorch 2.11,
#: CUDA 12.8), and at 17 rows runs about 1.4x slower than at 24; a
#: product of fewer rows pads to this many (zero rows, sliced off)
INT_MM_MIN_ROWS = 24


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


def quantize_int4(x: torch.Tensor, axis: int = -1):
    """Symmetric per-channel int4 over ``axis``, two codes packed into
    each int8 along ``axis`` (even positions in the low nibble), which
    must have even length (else ValueError). Returns ``(packed int8,
    scale fp32, orig_len)``."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 7.0)
    q = torch.clamp(torch.round(xf / scale), -7, 7).to(torch.int8)
    q = torch.movedim(q, axis, -1)
    n = q.shape[-1]
    if n % 2:
        raise ValueError("int4 packing needs an even quantized axis")
    lo = q[..., 0::2] & 0x0F
    hi = (q[..., 1::2] & 0x0F) << 4
    packed = torch.movedim(lo | hi, -1, axis)
    return packed, scale, n


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    orig_len: int, axis: int = -1,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unpack :func:`quantize_int4`'s nibbles (sign-extending each 4-bit
    two's complement code) and rescale in fp32, then cast to ``dtype``."""
    p = torch.movedim(packed, axis, -1).to(torch.uint8)
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    q = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], orig_len)
    q = torch.movedim(q, -1, axis)
    return (q.float() * scale).to(dtype)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b (K, N) int8`` accumulated in int32: exact.
    Fewer than :data:`INT_MM_MIN_ROWS` rows are padded with zero rows on
    every device (on the card ``torch._int_mm`` refuses them), so the CPU
    runs the shapes the card runs. ``b`` is fastest column-major on the
    card (an ``(N, K)`` tensor's ``.t()``: 3-9x faster than row-major at
    Llama-7B's FFN shapes)."""
    m = a.shape[0]
    if m < INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(a, b)[:m]


def int8_matmul(x: torch.Tensor, q_weight: torch.Tensor,
                scale: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W8A16: ``x @ dequantize_int8(q_weight, scale)`` in ``dtype``
    (default ``x``'s), ``q_weight`` ``(in, out)``."""
    dtype = dtype or x.dtype
    w = dequantize_int8(q_weight, scale, dtype)
    return torch.matmul(x.to(dtype), w)


def int8_w8a8_matmul(x: torch.Tensor, w: torch.Tensor, *,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W8A8 against a weight quantized in this call: ``w`` ``(in, out)``
    per output channel over ``in``, then
    :func:`int8_w8a8_matmul_prequant`."""
    wq, ws = quantize_int8(w, axis=0)
    return int8_w8a8_matmul_prequant(x, wq, ws, dtype=dtype)


def int8_w8a8_matmul_prequant(x: torch.Tensor, wq: torch.Tensor,
                              ws: torch.Tensor, *,
                              dtype: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    """W8A8 against an already-quantized weight: ``wq`` ``(in, out)``
    int8 and ``ws`` its fp32 per-output-channel scales (``(1, out)``, or
    any shape of ``out`` elements). ``x`` ``(..., in)`` quantizes per
    token; the int32 product rescales as ``acc * x_scale * w_scale``.
    Output in ``dtype`` (default ``x``'s)."""
    xq, xs = quantize_int8(x, axis=-1)
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq).view(
        *x.shape[:-1], wq.shape[1])
    out = acc.float() * xs * ws.reshape((1,) * (acc.dim() - 1) + (-1,))
    return out.to(dtype or x.dtype)


__all__ = ["INT_MM_MIN_ROWS", "dequantize_int4", "dequantize_int8",
           "int8_matmul", "int8_mm", "int8_w8a8_matmul",
           "int8_w8a8_matmul_prequant", "quantize_int4", "quantize_int8"]
