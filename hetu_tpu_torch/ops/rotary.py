"""Rotary position embeddings (counterpart of
``hetu_tpu/ops/rotary.py:16-47``): fp32 cos/sin tables and the
split-half (Llama/NeoX) rotation at explicit per-token positions."""

from __future__ import annotations

import functools
from typing import Optional

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     dtype: torch.dtype = torch.float32, device=None):
    """cos/sin tables of shape ``(max_len, head_dim // 2)``, computed in
    fp32 as JAX computes them, then cast to ``dtype``."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


@functools.lru_cache(maxsize=None)
def rope_tables(head_dim: int, max_len: int, theta: float,
                device: torch.device):
    """fp32 :func:`rope_frequencies`, built once per shape and device and
    shared by every layer that asks."""
    return rope_frequencies(head_dim, max_len, theta, device=device)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate ``x`` ``(..., seq, heads, head_dim)`` by the angles of its
    tokens: ``positions`` ``(..., seq)`` (default ``arange(seq)``) index
    the ``(max_len, head_dim // 2)`` tables. The halves rotate in fp32
    and the result is cast back to ``x``'s dtype."""
    if positions is None:
        cos_t = cos[:x.shape[-3], None, :]
        sin_t = sin[:x.shape[-3], None, :]
    else:
        positions = positions.long()
        cos_t = cos[positions][..., None, :]
        sin_t = sin[positions][..., None, :]
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out1 = xf1 * cos_t - xf2 * sin_t
    out2 = xf2 * cos_t + xf1 * sin_t
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


__all__ = ["apply_rotary", "rope_frequencies", "rope_tables"]
