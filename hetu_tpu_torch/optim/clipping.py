"""Gradient clipping by global norm (counterpart of
``hetu_tpu/optim/clipping.py``): the norm of a list of tensors, and the
clip as a gradient transform for :func:`~hetu_tpu_torch.optim.chain`;
nothing leaves the device."""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass(frozen=True)
class ClipByGlobalNorm:
    """The transform of ``clip_by_global_norm(max_norm)`` (``:17``): every
    grad times ``min(1, max_norm / (norm + 1e-6))``, in fp32 (JAX's fp32
    factor promotes a bf16 grad). fp32 grads are scaled in place."""

    max_norm: float

    def __call__(self, grads: Sequence[torch.Tensor]) -> list:
        factor = (self.max_norm / (global_norm(grads) + 1e-6)).clamp(max=1.0)
        out = [g.float() for g in grads]
        torch._foreach_mul_(out, factor)
        return out


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    """A gradient transform for :func:`~hetu_tpu_torch.optim.chain`, as
    ``chain(clip_by_global_norm(1.0), adamw(...))`` builds it."""
    return ClipByGlobalNorm(float(max_norm))
