"""Optimizers (counterpart of ``hetu_tpu/optim/optimizers.py`` and
``base.py``).

``hetu_tpu`` chains pure gradient transforms. The port describes an
optimizer as an :class:`OptimizerSpec`: ``build(model)`` makes the
``torch.optim`` optimizer that computes the same update, and
``step(optimizer, count)`` sets the scheduled learning rate of update
``count`` (0 for the first) before applying it.

- ``adamw`` is ``scale_by_adam`` + ``add_decayed_weights`` + ``-lr``:
  ``p -= lr * (m^ / (sqrt(v^) + eps) + wd * p)``, which is
  ``torch.optim.AdamW``'s update.
- JAX decays a param when ``ndim >= 2`` (``optim/base.py:91``), and sees
  every block param with the stacked layer axis
  (``nn/parallel.py:877-892``): block biases and LayerNorm scales are
  decayed, ``ln_f`` is not. The port keeps one module per layer, so
  :func:`jax_decay_mask` reproduces that rule by name.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch
from torch import nn

from hetu_tpu_torch.optim.schedules import constant

ScalarOrSchedule = Union[float, Callable[[int], float]]


def jax_decay_mask(name: str, param: torch.Tensor) -> bool:
    """JAX's default decay rule (``ndim >= 2``) as it applies to stacked
    block params: every ``blocks.*`` param, and 2-D params elsewhere."""
    return name.startswith("blocks.") or param.dim() >= 2


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    cls: type
    lr: ScalarOrSchedule
    hyper: dict
    weight_decay: float = 0.0

    def schedule(self) -> Callable[[int], float]:
        return self.lr if callable(self.lr) else constant(self.lr)

    def build(self, model: nn.Module) -> torch.optim.Optimizer:
        """The torch optimizer over ``model``'s params: one group when
        nothing is decayed, else a decayed and a non-decayed group split
        by :func:`jax_decay_mask`."""
        lr0 = self.schedule()(0)
        if not self.weight_decay:
            return self.cls(model.parameters(), lr=lr0, **self.hyper)
        decay, keep = [], []
        for name, p in model.named_parameters():
            (decay if jax_decay_mask(name, p) else keep).append(p)
        groups = [{"params": decay, "weight_decay": self.weight_decay},
                  {"params": keep, "weight_decay": 0.0}]
        return self.cls(groups, lr=lr0, **self.hyper)

    def step(self, optimizer: torch.optim.Optimizer, count: int) -> None:
        """Apply update number ``count`` at its scheduled rate."""
        lr = self.schedule()(count)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()


def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> OptimizerSpec:
    return OptimizerSpec(torch.optim.AdamW, lr,
                         {"betas": (b1, b2), "eps": eps},
                         weight_decay=weight_decay)


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptimizerSpec:
    return OptimizerSpec(torch.optim.Adam, lr,
                         {"betas": (b1, b2), "eps": eps})


def sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
        nesterov: bool = False) -> OptimizerSpec:
    """JAX's ``trace`` (``v = m v + g``, nesterov ``g + m v``) is
    ``torch.optim.SGD`` with dampening 0."""
    return OptimizerSpec(torch.optim.SGD, lr,
                         {"momentum": momentum, "nesterov": nesterov})
