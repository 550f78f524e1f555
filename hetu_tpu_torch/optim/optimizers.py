"""Optimizers (counterpart of ``hetu_tpu/optim/optimizers.py`` and
``base.py``).

``hetu_tpu`` chains pure gradient transforms. The port describes an
optimizer as an :class:`OptimizerSpec`: ``build(model)`` makes the
``torch.optim.Optimizer`` that computes the same update, and
``step(optimizer, count, grads)`` sets the scheduled learning rate of
update ``count`` (0 for the first) before applying it.

The update is JAX's, in JAX's order and precision, whatever the param
dtype: the state (Adam's moments, the momentum trace) is fp32 ("state
lives in fp32 regardless of param dtype", ``optimizers.py:11``), the
grad is upcast, and the whole update ``u`` is computed in fp32 and added
once, ``p + u.astype(p.dtype)`` (``base.py:41-44``). For a bf16 param
that is one rounding per step, where ``torch.optim.AdamW`` would keep
bf16 moments and round the decay and the step separately.

- ``adamw`` is ``scale_by_adam`` → ``add_decayed_weights`` → ``-lr``:
  ``u = -lr * (m^ / (sqrt(v^) + eps) + wd * p)``;
- ``adam`` the same without the decay;
- ``sgd`` is ``-lr * g``, with momentum JAX's ``trace``
  (``v = m v + g``, nesterov ``g + m v``).

JAX decays a param when ``ndim >= 2`` (``optim/base.py:91``), and sees
every block param with the stacked layer axis (``nn/parallel.py:877-892``):
block biases and LayerNorm scales are decayed, ``ln_f`` is not. The port
keeps one module per layer, so :func:`jax_decay_mask` reproduces that
rule by name.

``masked(inner, mask)`` freezes the params whose ``mask`` entry is False
(PEFT/LoRA: only the adapters train).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Union

import numpy as np
import torch
from torch import nn

from hetu_tpu_torch.optim.schedules import constant

ScalarOrSchedule = Union[float, Callable[[int], float]]


def jax_decay_mask(name: str, param: torch.Tensor) -> bool:
    """JAX's default decay rule (``ndim >= 2``) as it applies to stacked
    block params: every ``blocks.*`` param, and 2-D params elsewhere.
    A LoRA factor is decayed wherever it sits: ``lora_A``/``lora_B`` of a
    block are 4-D stacked in JAX, ``(layers, tasks, in, r)``, and 3-D
    ``(tasks, ·, ·)`` outside the blocks."""
    return name.startswith("blocks.") or param.dim() >= 2


def _with_grads(group: dict, grads: Mapping):
    """The group's params that ``grads`` holds, and their grads."""
    ps = [p for p in group["params"] if p in grads]
    return ps, [grads[p] for p in ps]


def _apply(ps: list, us: list) -> None:
    """``p + u.astype(p.dtype)``: each fp32 update rounded once."""
    torch._foreach_add_(ps, [u.to(p.dtype) for p, u in zip(ps, us)])


class Adam(torch.optim.Optimizer):
    """``scale_by_adam`` (→ ``add_decayed_weights`` where a group's
    ``weight_decay`` is nonzero) → ``scale_by_schedule(-lr)`` with fp32
    moments and a step count per param. Each step is a few multi-tensor
    (``torch._foreach_*``) kernels over a group, in JAX's order of
    operations."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, grads: Mapping):
        for group in self.param_groups:
            ps, gs = _with_grads(group, grads)
            if not ps:
                continue
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            s1, s2 = [], []
            for p in ps:
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                st["count"] += 1
                # the bias corrections in float32, as JAX computes them
                # from its int32 count
                c = np.float32(st["count"])
                s1.append(float(np.float32(1) / (np.float32(1)
                                                 - np.float32(b1) ** c)))
                s2.append(float(np.float32(1) / (np.float32(1)
                                                 - np.float32(b2) ** c)))
            mu = [self.state[p]["mu"] for p in ps]
            nu = [self.state[p]["nu"] for p in ps]
            g = [x.float() for x in gs]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1 - b2))
            den = torch._foreach_mul(nu, s2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            u = torch._foreach_mul(mu, s1)
            torch._foreach_div_(u, den)
            if wd:
                torch._foreach_add_(u, torch._foreach_mul(
                    [p.float() for p in ps], wd))
            torch._foreach_mul_(u, -lr)
            _apply(ps, u)


class SGD(torch.optim.Optimizer):
    """``trace(momentum, nesterov)`` (when ``momentum`` is nonzero) →
    ``scale_by_schedule(-lr)``, with an fp32 trace."""

    def __init__(self, params, lr: float, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, grads: Mapping):
        for group in self.param_groups:
            ps, gs = _with_grads(group, grads)
            if not ps:
                continue
            m = group["momentum"]
            u = [x.float() for x in gs]
            if m:
                for p in ps:
                    if not self.state[p]:
                        self.state[p]["trace"] = torch.zeros_like(
                            p, dtype=torch.float32)
                v = [self.state[p]["trace"] for p in ps]
                torch._foreach_mul_(v, m)
                torch._foreach_add_(v, u)
                u = torch._foreach_add(u, torch._foreach_mul(v, m)) \
                    if group["nesterov"] else v
            _apply(ps, torch._foreach_mul(u, -group["lr"]))


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """``decay_slot``: JAX's ``adamw`` chains ``add_decayed_weights``
    between the moments and the rate, an empty slot of its state tree,
    even at ``weight_decay`` 0 (``adam`` does not): its checkpoint names
    follow that tree (:meth:`jax_state_layout`)."""

    cls: type
    lr: ScalarOrSchedule
    hyper: dict
    weight_decay: float = 0.0
    decay_slot: bool = False

    def schedule(self) -> Callable[[int], float]:
        return self.lr if callable(self.lr) else constant(self.lr)

    def build(self, model: nn.Module) -> torch.optim.Optimizer:
        """The optimizer over ``model``'s trainable params (a frozen one,
        ``requires_grad`` False, holds no state): one group when nothing
        is decayed, else a decayed and a non-decayed group split by
        :func:`jax_decay_mask`. Its ``state_layout`` is the spec's
        :meth:`jax_state_layout` (what a checkpoint names its state by)."""
        lr0 = self.schedule()(0)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        if not self.weight_decay:
            opt = self.cls([p for _, p in named], lr=lr0, **self.hyper)
        else:
            decay, keep = [], []
            for name, p in named:
                (decay if jax_decay_mask(name, p) else keep).append(p)
            opt = self.cls([{"params": decay,
                             "weight_decay": self.weight_decay},
                            {"params": keep, "weight_decay": 0.0}],
                           lr=lr0, **self.hyper)
        opt.state_layout = self.jax_state_layout()
        return opt

    def jax_state_layout(self) -> dict:
        """Where the state of this optimizer sits in ``hetu_tpu``'s
        optimizer-state tree, by flattened path (its checkpoint names are
        ``opt.<path>``): Adam's ``(count, mu, nu)`` under ``"adam"`` and
        the rate schedule's update count under ``"count"``; SGD's
        momentum trace under ``"trace"``."""
        if self.cls is Adam:
            return {"adam": "0", "count": "2" if self.decay_slot else "1"}
        if self.hyper.get("momentum"):
            return {"trace": "0", "count": "1"}
        return {"count": "0"}

    def step(self, optimizer: torch.optim.Optimizer, count: int,
             grads: Mapping) -> None:
        """Apply update number ``count`` at its scheduled rate, from
        ``grads`` (``{param: grad}``)."""
        lr = self.schedule()(count)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step(grads)


@dataclasses.dataclass(frozen=True)
class Chain:
    """``chain(*transforms, optimizer)``: the gradient transforms run in
    order on the grads of every update, then the optimizer applies them
    (``hetu_tpu/optim/base.py:27``, where clipping precedes the update's
    own transforms). It builds and steps like its optimizer."""

    transforms: tuple
    optimizer: OptimizerSpec

    def build(self, model: nn.Module) -> torch.optim.Optimizer:
        opt = self.optimizer.build(model)
        opt.state_layout = self.jax_state_layout()
        return opt

    def jax_state_layout(self) -> dict:
        """The optimizer's layout under ``chain``'s tuple: each gradient
        transform before it holds an empty slot."""
        n = len(self.transforms)
        return {k: f"{n}.{v}"
                for k, v in self.optimizer.jax_state_layout().items()}

    def step(self, optimizer: torch.optim.Optimizer, count: int,
             grads: Mapping) -> None:
        params, gs = list(grads), list(grads.values())
        for t in self.transforms:
            gs = t(gs)
        self.optimizer.step(optimizer, count, dict(zip(params, gs)))


@dataclasses.dataclass(frozen=True)
class Masked:
    """``masked(inner, mask)`` (``hetu_tpu/optim/base.py:112``): only the
    params whose ``mask`` entry is True train.

    JAX computes every grad, zeroes the frozen leaves' grads before
    ``inner`` and their updates after it. The port freezes them instead:
    :meth:`build` sets ``requires_grad`` False on every param the mask
    leaves out, so the step computes no grad for it, the optimizer holds
    no state for it and the ``grads`` that :meth:`step` receives never
    name it. The two are equal: a zero grad adds nothing to a global
    norm, so a ``chain(clip_by_global_norm(...), ...)`` inside measures
    the trained params' norm alone, and a zeroed update (weight decay
    included) leaves a frozen param as it was."""

    inner: Union[OptimizerSpec, Chain]
    mask: Mapping[str, bool]

    def build(self, model: nn.Module) -> torch.optim.Optimizer:
        named = dict(model.named_parameters())
        missing = sorted(set(named) - set(self.mask))
        if missing:
            raise ValueError(f"masked: the mask does not name {missing[:3]}"
                             f" ({len(missing)} params)")
        for name, p in named.items():
            if not self.mask[name]:
                p.requires_grad_(False)
        return self.inner.build(model)

    def jax_state_layout(self) -> dict:
        """``masked`` keeps its inner optimizer's state tree."""
        return self.inner.jax_state_layout()

    def step(self, optimizer: torch.optim.Optimizer, count: int,
             grads: Mapping) -> None:
        self.inner.step(optimizer, count, grads)


def masked(inner: Union[OptimizerSpec, Chain],
           mask: Mapping[str, bool]) -> Masked:
    """Train only the params whose ``mask`` entry (``{name: bool}`` over
    every param, as ``peft.lora_trainable_mask`` gives it) is True:
    ``masked(chain(clip_by_global_norm(1.0), adamw(1e-4)), mask)``."""
    return Masked(inner, dict(mask))


def chain(*parts) -> Chain:
    """Gradient transforms (callables ``list[grad] -> list[grad]``, such
    as :func:`~hetu_tpu_torch.optim.clip_by_global_norm`), then the
    optimizer, last: ``chain(clip_by_global_norm(1.0), adamw(5e-4))``.
    JAX chains any transforms in any order; the port's optimizer is one
    whole update, so it must come last and only once."""
    *transforms, last = parts
    if not isinstance(last, OptimizerSpec):
        raise TypeError("chain: the last part must be an optimizer "
                        "(adamw, adam or sgd)")
    for t in transforms:
        if isinstance(t, (OptimizerSpec, Chain)) or not callable(t):
            raise TypeError(f"chain: {t!r} before the optimizer must be a "
                            f"gradient transform")
    return Chain(tuple(transforms), last)


def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> OptimizerSpec:
    return OptimizerSpec(Adam, lr, {"betas": (b1, b2), "eps": eps},
                         weight_decay=weight_decay, decay_slot=True)


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptimizerSpec:
    return OptimizerSpec(Adam, lr, {"betas": (b1, b2), "eps": eps})


def sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
        nesterov: bool = False) -> OptimizerSpec:
    return OptimizerSpec(SGD, lr, {"momentum": momentum,
                                   "nesterov": nesterov})
