"""fp16 gradient scaler (counterpart of ``hetu_tpu/optim/scaler.py``):
the loss scale and its growth tracker are device tensors, and every
function here is device work with no host sync, so a scaled step can run
inside a captured graph. A skipped update is the caller's: gate it on
``finite`` with ``torch.where``, as JAX's caller does with ``jnp.where``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass
class ScalerState:
    scale: torch.Tensor             # fp32, shape ()
    growth_tracker: torch.Tensor    # int32, shape ()


def init_scaler(init_scale: float = 2.0 ** 16, device=None) -> ScalerState:
    return ScalerState(
        torch.tensor(init_scale, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def scale_loss(state: ScalerState, loss: torch.Tensor) -> torch.Tensor:
    return loss * state.scale


def unscale_and_check(state: ScalerState, grads: Sequence[torch.Tensor]):
    """``(grads in fp32 times 1 / scale, finite)``: ``finite`` a device
    bool, True iff every unscaled grad is finite."""
    inv = 1.0 / state.scale
    out = [g.float() * inv for g in grads]
    finite = torch.stack([torch.isfinite(g).all() for g in out]).all()
    return out, finite


def update_scaler(state: ScalerState, finite: torch.Tensor,
                  growth_factor: float = 2.0, backoff_factor: float = 0.5,
                  growth_interval: int = 2000) -> ScalerState:
    """After a finite step the tracker counts up, and the scale grows by
    ``growth_factor`` every ``growth_interval`` finite steps; a
    non-finite step backs the scale off and resets the tracker."""
    zero = torch.zeros_like(state.growth_tracker)
    tracker = torch.where(finite, state.growth_tracker + 1, zero)
    grow = tracker >= growth_interval
    scale = torch.where(
        finite, torch.where(grow, state.scale * growth_factor, state.scale),
        state.scale * backoff_factor)
    return ScalerState(scale, torch.where(grow, zero, tracker))


__all__ = ["ScalerState", "init_scaler", "scale_loss", "unscale_and_check",
           "update_scaler"]
