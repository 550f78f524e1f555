"""LR schedules (counterpart of ``hetu_tpu/optim/schedules.py``): a
schedule maps the update count (0 for the first update) to a learning
rate, computed in float32 as the JAX schedules are."""

from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant(lr: float):
    return lambda step: float(_f32(lr))


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        w = min(_f32(1.0), (_f32(step) + _f32(1)) / _f32(max(warmup_steps, 1)))
        return float(_f32(lr) * w)
    return f


def cosine_decay(lr: float, decay_steps: int, warmup_steps: int = 0,
                 min_lr: float = 0.0):
    def f(step):
        s = _f32(step)
        warm = min(_f32(1.0), (s + _f32(1)) / _f32(max(warmup_steps, 1))) \
            if warmup_steps > 0 else _f32(1.0)
        prog = np.clip((s - _f32(warmup_steps))
                       / _f32(max(decay_steps - warmup_steps, 1)),
                       _f32(0.0), _f32(1.0))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * prog))
        return float((_f32(min_lr) + (_f32(lr) - _f32(min_lr)) * cos) * warm)
    return f
