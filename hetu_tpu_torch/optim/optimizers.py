"""Optimizers (counterpart of ``hetu_tpu/optim/optimizers.py`` and
``base.py``).

``hetu_tpu`` chains pure gradient transforms. The port describes an
optimizer as an :class:`OptimizerSpec`: ``build(model)`` makes the
``torch.optim.Optimizer`` that computes the same update, with its state;
``stage(optimizer, count)`` writes the scalars of update ``count`` (0
for the first) to the device, ``update(optimizer, grads)`` applies it,
and ``step`` does both.

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
  (``v = m v + g``, nesterov ``g + m v``);
- ``adam(amsgrad=True)`` divides by the running max of the corrected
  second moment; ``adagrad`` by ``sqrt`` of the summed squared grads;
  ``adafactor`` by factored second moments, RMS-clipped per leaf.

Every optimizer is a :class:`StagedOptimizer`: the host stages each
update's scalars (rate, bias corrections, scheduled decay) into a device
vector before the update runs, so a captured step replays each update
with its own values. ``weight_decay`` may be a schedule.

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

from hetu_tpu_torch.models.convert import jax_param_layout
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


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact)."""
    return float(np.float32(x))


class StagedOptimizer(torch.optim.Optimizer):
    """An optimizer whose per-update scalars (the scheduled rate, Adam's
    bias corrections, a scheduled decay) are device operands.

    The host computes them in float32 before each update, in
    :meth:`stage`, and writes them into :attr:`scalars` (one copy, no
    device sync); :meth:`step` reads them from there. So the update of a
    captured train step (``engine/train_step.py``) replays with the
    values staged for that step, and the eager step reads the same bits.
    The state (moments, counts) exists from construction and keeps its
    storage: a graph captures its addresses. ``SCALARS`` names the
    entries of :attr:`scalars`."""

    SCALARS: tuple = ("neg_lr",)

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        dev = self.param_groups[0]["params"][0].device
        self.scalars = torch.zeros(len(self.SCALARS), dtype=torch.float32,
                                   device=dev)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = self._init_state(p, group)

    def _init_state(self, p: torch.Tensor, group: dict) -> dict:
        return {}

    def _scalar(self, name: str) -> torch.Tensor:
        return self.scalars[self.SCALARS.index(name)]

    def _host_scalars(self, lr: float, wd: float) -> dict:
        return {"neg_lr": -_f32(lr)}

    def stage(self, lr: float, wd: float = 0.0) -> None:
        """Advance the host counts and write this update's scalars: the
        rate ``lr`` and the decay ``wd`` of the update, each float32."""
        vals = self._host_scalars(lr, wd)
        self.scalars.copy_(torch.tensor([vals[k] for k in self.SCALARS],
                                        dtype=torch.float32),
                           non_blocking=True)

    def _count(self) -> int:
        """Advance every param's update count (one count, as JAX keeps
        it); returns the new count."""
        counts = {st["count"] for st in self.state.values()}
        if len(counts) > 1:
            raise ValueError(f"the params' update counts differ "
                             f"({sorted(counts)})")
        count = counts.pop() + 1
        for st in self.state.values():
            st["count"] = count
        return count


class Adam(StagedOptimizer):
    """``scale_by_adam`` (→ ``add_decayed_weights`` where a group's
    ``weight_decay`` is nonzero) → ``scale_by_schedule(-lr)`` with fp32
    moments and a step count per param; ``amsgrad`` keeps the running
    max of the bias-corrected second moment (``optimizers.py:68``).
    Each step is a few multi-tensor (``torch._foreach_*``) kernels over a
    group, in JAX's order of operations."""

    SCALARS = ("neg_lr", "mu_hat", "nu_hat", "wd")

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      amsgrad=amsgrad))

    def _init_state(self, p, group):
        st = {"count": 0,
              "mu": torch.zeros_like(p, dtype=torch.float32),
              "nu": torch.zeros_like(p, dtype=torch.float32)}
        if group["amsgrad"]:
            st["max_nu"] = torch.zeros_like(p, dtype=torch.float32)
        return st

    def _host_scalars(self, lr, wd):
        b1, b2 = self.param_groups[0]["betas"]
        # the bias corrections in float32, as JAX computes them from its
        # int32 count
        c = np.float32(self._count())
        return {"neg_lr": -_f32(lr),
                "mu_hat": _f32(np.float32(1) / (np.float32(1)
                                                - np.float32(b1) ** c)),
                "nu_hat": _f32(np.float32(1) / (np.float32(1)
                                                - np.float32(b2) ** c)),
                "wd": _f32(wd)}

    @torch.no_grad()
    def step(self, grads: Mapping):
        s1, s2 = self._scalar("mu_hat"), self._scalar("nu_hat")
        for group in self.param_groups:
            ps, gs = _with_grads(group, grads)
            if not ps:
                continue
            b1, b2 = group["betas"]
            mu = [self.state[p]["mu"] for p in ps]
            nu = [self.state[p]["nu"] for p in ps]
            g = [x.float() for x in gs]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1 - b2))
            den = torch._foreach_mul(nu, s2)
            if group["amsgrad"]:
                mx = [self.state[p]["max_nu"] for p in ps]
                torch._foreach_maximum_(mx, den)
                den = torch._foreach_sqrt(mx)
            else:
                torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            u = torch._foreach_mul(mu, s1)
            torch._foreach_div_(u, den)
            if group["weight_decay"]:
                torch._foreach_add_(u, torch._foreach_mul(
                    [p.float() for p in ps], self._scalar("wd")))
            torch._foreach_mul_(u, self._scalar("neg_lr"))
            _apply(ps, u)


class SGD(StagedOptimizer):
    """``trace(momentum, nesterov)`` (when ``momentum`` is nonzero) →
    ``scale_by_schedule(-lr)``, with an fp32 trace."""

    def __init__(self, params, lr: float, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      nesterov=nesterov))

    def _init_state(self, p, group):
        if not group["momentum"]:
            return {}
        return {"trace": torch.zeros_like(p, dtype=torch.float32)}

    @torch.no_grad()
    def step(self, grads: Mapping):
        for group in self.param_groups:
            ps, gs = _with_grads(group, grads)
            if not ps:
                continue
            m = group["momentum"]
            u = [x.float() for x in gs]
            if m:
                v = [self.state[p]["trace"] for p in ps]
                torch._foreach_mul_(v, m)
                torch._foreach_add_(v, u)
                u = torch._foreach_add(u, torch._foreach_mul(v, m)) \
                    if group["nesterov"] else v
            _apply(ps, torch._foreach_mul(u, self._scalar("neg_lr")))


class Adagrad(StagedOptimizer):
    """``scale_by_adagrad(eps, initial_accumulator)`` →
    ``scale_by_schedule(-lr)`` (``optimizers.py:114``): the squared grads
    accumulate in fp32, the update is ``g / (sqrt(accum) + eps)``."""

    def __init__(self, params, lr: float, eps: float = 1e-10,
                 initial_accumulator: float = 0.0):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      initial_accumulator=initial_accumulator))

    def _init_state(self, p, group):
        return {"accum": torch.full_like(p, group["initial_accumulator"],
                                         dtype=torch.float32)}

    @torch.no_grad()
    def step(self, grads: Mapping):
        for group in self.param_groups:
            ps, gs = _with_grads(group, grads)
            if not ps:
                continue
            acc = [self.state[p]["accum"] for p in ps]
            g = [x.float() for x in gs]
            torch._foreach_add_(acc, torch._foreach_mul(g, g))
            den = torch._foreach_sqrt(acc)
            torch._foreach_add_(den, group["eps"])
            u = torch._foreach_div(g, den)
            torch._foreach_mul_(u, self._scalar("neg_lr"))
            _apply(ps, u)


def adafactor_factored(jax_shape, min_dim_size_to_factor: int) -> bool:
    """Whether ``scale_by_adafactor`` factors a leaf of ``hetu_tpu``'s
    shape ``jax_shape`` (``optimizers.py:160``)."""
    return len(jax_shape) >= 2 \
        and jax_shape[-1] >= min_dim_size_to_factor \
        and jax_shape[-2] >= min_dim_size_to_factor


class Adafactor(StagedOptimizer):
    """``scale_by_adafactor`` (→ ``add_decayed_weights`` where a group's
    ``weight_decay`` is nonzero) → ``scale_by_schedule(-lr)``
    (``optimizers.py:143``), on ``hetu_tpu``'s leaves.

    ``leaves`` lists, for each of ``hetu_tpu``'s param leaves, its
    ``(param, transposed)`` parts (a block leaf stacks one part per
    layer; a Linear weight is ``(out, in)`` here and ``(in, out)`` in
    ``hetu_tpu``): a leaf is factored by its own shape, each part keeps
    the row and column moments of ``hetu_tpu``'s orientation
    (``v_row`` (…, in) and ``v_col`` (…, out) of a Linear weight), and the
    RMS clip runs over the whole leaf, every layer at once, as JAX's
    does. The per-step decay ``beta2 = 1 - t^-decay_rate`` is staged in
    float32. Everything stays on the device."""

    SCALARS = ("neg_lr", "beta2", "one_minus_beta2", "wd")

    def __init__(self, params, lr: float, leaves, *,
                 min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
                 eps: float = 1e-30, clip_threshold: float = 1.0,
                 weight_decay: float = 0.0):
        self.leaves = [list(parts) for parts in leaves]
        self._orient = {p: t for parts in self.leaves for p, t in parts}
        self._factored = {}
        for parts in self.leaves:
            p0, t0 = parts[0]
            shape = tuple(p0.shape[::-1]) if t0 else tuple(p0.shape)
            if len(parts) > 1:
                shape = (len(parts),) + shape
            f = adafactor_factored(shape, min_dim_size_to_factor)
            if f and p0.dim() < 2:
                raise NotImplementedError(
                    f"adafactor: a stacked leaf {shape} factored over its "
                    f"layer axis")
            for p, _ in parts:
                self._factored[p] = f
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, eps=eps, clip_threshold=clip_threshold,
            weight_decay=weight_decay))

    def _axes(self, p) -> tuple:
        """The port's axes of ``hetu_tpu``'s row mean (over its last
        axis) and column mean (over its second to last)."""
        return (-2, -1) if self._orient[p] else (-1, -2)

    def _init_state(self, p, group):
        st = {"count": 0}
        if self._factored[p]:
            ar, ac = self._axes(p)
            rows = list(p.shape)
            del rows[ar]
            cols = list(p.shape)
            del cols[ac]
            st["v_row"] = p.new_zeros(rows, dtype=torch.float32)
            st["v_col"] = p.new_zeros(cols, dtype=torch.float32)
        else:
            st["v"] = torch.zeros_like(p, dtype=torch.float32)
        return st

    def _host_scalars(self, lr, wd):
        decay = self.param_groups[0]["decay_rate"]
        beta2 = np.float32(1) - np.float32(self._count()) \
            ** np.float32(-decay)
        return {"neg_lr": -_f32(lr), "beta2": _f32(beta2),
                "one_minus_beta2": _f32(np.float32(1) - beta2), "wd": _f32(wd)}

    def _scaled(self, p, g, group) -> torch.Tensor:
        """The leaf part's update before the RMS clip; updates its
        moments."""
        st, eps = self.state[p], group["eps"]
        b2, c2 = self._scalar("beta2"), self._scalar("one_minus_beta2")
        g = g.float()
        g2 = g * g + eps
        if self._factored[p]:
            ar, ac = self._axes(p)
            vr, vc = st["v_row"], st["v_col"]
            vr.mul_(b2).add_(c2 * g2.mean(dim=ar))
            vc.mul_(b2).add_(c2 * g2.mean(dim=ac))
            r = vr / vr.mean(dim=-1, keepdim=True).clamp(min=eps)
            return g * torch.rsqrt(r.unsqueeze(ar) * vc.unsqueeze(ac))
        v = st["v"]
        v.mul_(b2).add_(c2 * g2)
        return g * torch.rsqrt(v)

    @torch.no_grad()
    def step(self, grads: Mapping):
        group = self.param_groups[0]
        decayed = {p for grp in self.param_groups if grp["weight_decay"]
                   for p in grp["params"]}
        for parts in self.leaves:
            ps = [p for p, _ in parts if p in grads]
            if not ps:
                continue
            us = [self._scaled(p, grads[p], group) for p in ps]
            sq = torch.stack([(u * u).sum() for u in us]).sum()
            rms = torch.sqrt(sq / sum(u.numel() for u in us))
            clip = torch.clamp(rms / group["clip_threshold"], min=1.0)
            for p, u in zip(ps, us):
                u = u / clip
                if p in decayed:
                    u = u + self._scalar("wd") * p.float()
                p.add_((u * self._scalar("neg_lr")).to(p.dtype))


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer: its class, rate (a float or a schedule of the update
    count), hyper-parameters and decoupled weight decay (a float or a
    schedule, ``add_decayed_weights``, ``hetu_tpu/optim/base.py:68``).

    ``decay_slot``: JAX's ``adamw`` chains ``add_decayed_weights``
    between the moments and the rate, a slot of its state tree (empty, or
    the decay schedule's count), even at ``weight_decay`` 0 (``adam``
    does not): its checkpoint names follow that tree
    (:meth:`jax_state_layout`)."""

    cls: type
    lr: ScalarOrSchedule
    hyper: dict
    weight_decay: ScalarOrSchedule = 0.0
    decay_slot: bool = False

    def schedule(self) -> Callable[[int], float]:
        return self.lr if callable(self.lr) else constant(self.lr)

    def decay(self, count: int) -> float:
        """The weight decay of update ``count``, in float32."""
        wd = self.weight_decay
        return float(wd(count)) if callable(wd) else float(np.float32(wd))

    def build(self, model: nn.Module) -> torch.optim.Optimizer:
        """The optimizer over ``model``'s trainable params (a frozen one,
        ``requires_grad`` False, holds no state), with its state made
        now: one group when nothing is decayed, else a decayed and a
        non-decayed group split by :func:`jax_decay_mask`. Its
        ``state_layout`` is the spec's :meth:`jax_state_layout` (what a
        checkpoint names its state by)."""
        lr0 = self.schedule()(0)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        hyper = dict(self.hyper)
        if self.cls is Adafactor:
            by_name = dict(named)
            hyper["leaves"] = [
                [(by_name[n], t) for n, t in parts]
                for parts in jax_param_layout(by_name).values()]
        if not self.weight_decay:
            opt = self.cls([p for _, p in named], lr=lr0, **hyper)
        else:
            decay, keep = [], []
            for name, p in named:
                (decay if jax_decay_mask(name, p) else keep).append(p)
            # a group's weight_decay marks it decayed; the decay itself
            # is staged at each update (it may be a schedule)
            opt = self.cls([{"params": decay, "weight_decay": 1.0},
                            {"params": keep, "weight_decay": 0.0}],
                           lr=lr0, **hyper)
        opt.state_layout = self.jax_state_layout()
        return opt

    def jax_state_layout(self) -> dict:
        """Where the state of this optimizer sits in ``hetu_tpu``'s
        optimizer-state tree, by flattened path (its checkpoint names are
        ``opt.<path>``): the moments under their kind (``"adam"``'s
        ``(count, mu, nu)``, ``"amsgrad"``'s ``(count, mu, nu, max_nu)``,
        ``"adagrad"``'s ``accum``, ``"adafactor"``'s ``(count, v_row,
        v_col, v)``, SGD's momentum ``"trace"``), a scheduled decay's
        count under ``"wd_count"`` and the rate schedule's update count
        under ``"count"``."""
        slots, i = {}, 0
        kind = {Adam: "amsgrad" if self.hyper.get("amsgrad") else "adam",
                Adagrad: "adagrad", Adafactor: "adafactor"}.get(self.cls)
        if kind is None and self.hyper.get("momentum"):
            kind = "trace"
        if kind is not None:
            slots[kind], i = "0", 1
        if self.decay_slot or (self.cls is Adafactor and self.weight_decay):
            if callable(self.weight_decay):
                slots["wd_count"] = str(i)
            i += 1
        slots["count"] = str(i)
        return slots

    def stage(self, optimizer: StagedOptimizer, count: int) -> None:
        """Stage update number ``count`` (0 for the first): its scheduled
        rate and decay, and the optimizer's own scalars."""
        optimizer.stage(self.schedule()(count), self.decay(count))

    def update(self, optimizer: StagedOptimizer, grads: Mapping) -> None:
        """The staged update from ``grads`` (``{param: grad}``): device
        work only, what a captured step replays."""
        optimizer.step(grads)

    def step(self, optimizer: StagedOptimizer, count: int,
             grads: Mapping) -> None:
        """Apply update number ``count`` at its scheduled rate, from
        ``grads``: :meth:`stage`, then :meth:`update`."""
        self.stage(optimizer, count)
        self.update(optimizer, grads)


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

    def stage(self, optimizer: StagedOptimizer, count: int) -> None:
        self.optimizer.stage(optimizer, count)

    def update(self, optimizer: StagedOptimizer, grads: Mapping) -> None:
        """The staged update: the transforms, then the optimizer (device
        work only)."""
        params, gs = list(grads), list(grads.values())
        for t in self.transforms:
            gs = t(gs)
        optimizer.step(dict(zip(params, gs)))

    def step(self, optimizer: StagedOptimizer, count: int,
             grads: Mapping) -> None:
        self.stage(optimizer, count)
        self.update(optimizer, grads)


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

    def stage(self, optimizer: StagedOptimizer, count: int) -> None:
        self.inner.stage(optimizer, count)

    def update(self, optimizer: StagedOptimizer, grads: Mapping) -> None:
        self.inner.update(optimizer, grads)

    def step(self, optimizer: StagedOptimizer, count: int,
             grads: Mapping) -> None:
        self.stage(optimizer, count)
        self.update(optimizer, grads)


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
                        "(adamw, adam, sgd, adagrad or adafactor)")
    for t in transforms:
        if isinstance(t, (OptimizerSpec, Chain)) or not callable(t):
            raise TypeError(f"chain: {t!r} before the optimizer must be a "
                            f"gradient transform")
    return Chain(tuple(transforms), last)


def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8,
          weight_decay: ScalarOrSchedule = 0.01) -> OptimizerSpec:
    """``weight_decay`` may be a schedule of the update count
    (``schedules.wd_increment``)."""
    return OptimizerSpec(Adam, lr, {"betas": (b1, b2), "eps": eps},
                         weight_decay=weight_decay, decay_slot=True)


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, amsgrad: bool = False) -> OptimizerSpec:
    return OptimizerSpec(Adam, lr, {"betas": (b1, b2), "eps": eps,
                                    "amsgrad": amsgrad})


def sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
        nesterov: bool = False) -> OptimizerSpec:
    return OptimizerSpec(SGD, lr, {"momentum": momentum,
                                   "nesterov": nesterov})


def adagrad(lr: ScalarOrSchedule, eps: float = 1e-10,
            initial_accumulator: float = 0.0) -> OptimizerSpec:
    return OptimizerSpec(Adagrad, lr, {
        "eps": eps, "initial_accumulator": initial_accumulator})


def adafactor(lr: ScalarOrSchedule, *, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, clip_threshold: float = 1.0,
              weight_decay: ScalarOrSchedule = 0.0) -> OptimizerSpec:
    return OptimizerSpec(Adafactor, lr, {
        "min_dim_size_to_factor": min_dim_size_to_factor,
        "decay_rate": decay_rate, "clip_threshold": clip_threshold},
        weight_decay=weight_decay)
