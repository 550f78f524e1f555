"""Gradient clipping by global norm (counterpart of
``hetu_tpu/optim/clipping.py``), on lists of tensors; nothing leaves the
device."""

from __future__ import annotations

from typing import Iterable

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tensors: Iterable[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """Scale ``tensors`` in place by ``min(1, max_norm / (norm + 1e-6))``;
    returns the norm before clipping."""
    tensors = list(tensors)
    norm = global_norm(tensors)
    factor = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    for t in tensors:
        t.mul_(factor.to(t.dtype))
    return norm
