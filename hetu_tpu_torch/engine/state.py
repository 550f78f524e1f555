"""Train state (counterpart of ``hetu_tpu/engine/state.py``): the step
count, the model (which holds the params) and the ``torch.optim``
optimizer (which holds its moments). The JAX state is an immutable
pytree that the jitted step donates; the port's step updates this one in
place and returns it."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int                           # optimizer updates applied so far
    model: nn.Module
    optimizer: torch.optim.Optimizer
