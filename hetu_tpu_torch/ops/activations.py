"""Activation ops (counterpart of ``hetu_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """GELU; the tanh approximation by default, as ``jax.nn.gelu``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU combine ``silu(gate) * up``
    (``hetu_tpu/ops/activations.py:13``)."""
    return F.silu(gate) * up
