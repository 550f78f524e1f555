"""Dropout (counterpart of ``hetu_tpu/ops/dropout.py``) and the integer
seeds that drive it.

``hetu_tpu`` threads ``jax.random`` keys; the port threads plain integer
seeds. :func:`split_seed` derives independent child seeds on the host
(no device sync), a seed becomes a ``torch.Generator`` on the tensor's
device for :func:`dropout`, and the flash kernels take a seed directly
(their mask is a position hash, see ``ops/flash.py``). The train step
derives one seed per step, so a resumed run reproduces every mask.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive_seed(seed: int, i: int) -> int:
    """Child ``i`` of ``seed``: a 32-bit seed, independent of the
    siblings (splitmix64 over the pair)."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (i & _MASK64)) \
        & 0xFFFFFFFF


def split_seed(seed: int, n: int) -> list:
    """``n`` child seeds — the counterpart of ``jax.random.split``."""
    return [derive_seed(seed, i) for i in range(n)]


def generator_for(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None → None)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: survivors scaled by 1/(1-rate). ``rate <= 0`` or
    ``generator=None`` (eval, deterministic paths) is the identity."""
    if generator is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        raise ValueError(f"dropout rate must be < 1, got {rate}")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)
                       ).to(x.dtype)
