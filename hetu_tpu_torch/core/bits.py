"""Integer bit mixing on torch tensors (counterpart of
``hetu_tpu/core/bits.py``).

PyTorch on the CPU has no ``>>`` for uint32, so 32-bit words are held in
int64 tensors with values in ``[0, 2**32)``. Products are split into
16-bit halves so that no intermediate leaves int64's range: the result
is the uint32 product modulo 2**32, bit for bit.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a
    32-bit constant ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32: full-avalanche 32-bit mixer (uint32 values in
    int64 in, the same out)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)
