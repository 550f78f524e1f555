"""LR and weight-decay schedules (counterpart of
``hetu_tpu/optim/schedules.py``): a schedule maps the update count (0 for
the first update) to a value, computed in float32 as the JAX schedules
are. The host evaluates it before each update and stages the value
(``optim.optimizers.StagedOptimizer``)."""

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


def _warm(s, warmup_steps: int):
    return min(_f32(1.0), (s + _f32(1)) / _f32(max(warmup_steps, 1))) \
        if warmup_steps > 0 else _f32(1.0)


def _progress(s, decay_steps: int, warmup_steps: int):
    return np.clip((s - _f32(warmup_steps))
                   / _f32(max(decay_steps - warmup_steps, 1)),
                   _f32(0.0), _f32(1.0))


def cosine_decay(lr: float, decay_steps: int, warmup_steps: int = 0,
                 min_lr: float = 0.0):
    def f(step):
        s = _f32(step)
        warm = _warm(s, warmup_steps)
        prog = _progress(s, decay_steps, warmup_steps)
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * prog))
        return float((_f32(min_lr) + (_f32(lr) - _f32(min_lr)) * cos) * warm)
    return f


def linear_decay(lr: float, decay_steps: int, warmup_steps: int = 0,
                 min_lr: float = 0.0):
    """Warmup, then a straight line from ``lr`` to ``min_lr`` over
    ``decay_steps`` (``:84``)."""
    def f(step):
        s = _f32(step)
        warm = _warm(s, warmup_steps)
        prog = _progress(s, decay_steps, warmup_steps)
        return float((_f32(min_lr) + (_f32(lr) - _f32(min_lr))
                      * (_f32(1) - prog)) * warm)
    return f


def inverse_sqrt(lr: float, warmup_steps: int = 0, min_lr: float = 0.0,
                 decay_steps: int = 0):
    """Linear warmup to ``lr``, then ``lr·sqrt(warmup)/sqrt(step)``
    floored at ``min_lr`` (``:35``); past ``decay_steps > 0`` the
    schedule returns ``min_lr``."""
    def f(step):
        s = _f32(step) + _f32(1)
        w = _f32(max(warmup_steps, 1))
        if s <= w:
            out = _f32(lr) * min(_f32(1.0), s / w)
        else:
            out = max(_f32(min_lr), _f32(lr) * np.sqrt(w)
                      * (_f32(1) / np.sqrt(max(s, w))))
        if decay_steps > 0 and s > _f32(decay_steps):
            out = _f32(min_lr)
        return float(_f32(out))
    return f


def wd_increment(start_wd: float, end_wd: float, incr_steps: int,
                 style: str = "linear"):
    """Weight-decay increment schedule (``:56``): ``constant`` holds
    ``end_wd``; ``linear``/``cosine`` move from ``start_wd`` to
    ``end_wd`` over ``incr_steps`` updates, the first update already off
    ``start_wd``, then hold."""
    if style not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown wd increment style {style!r}")
    if style == "constant" and start_wd != end_wd:
        raise ValueError(
            f"constant wd style needs start_wd == end_wd, got "
            f"{start_wd} != {end_wd}")

    def f(step):
        if style == "constant":
            return float(_f32(end_wd))
        s = _f32(step) + _f32(1)
        frac = np.clip(s / _f32(max(incr_steps, 1)), _f32(0.0), _f32(1.0))
        if style == "cosine":
            frac = _f32(0.5) * (_f32(1.0) - np.cos(_f32(np.pi) * frac))
        return float(_f32(start_wd) + (_f32(end_wd) - _f32(start_wd)) * frac)
    return f
