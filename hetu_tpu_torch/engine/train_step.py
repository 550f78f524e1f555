"""The single-device training step (counterpart of
``hetu_tpu/engine/train_step.py``).

``make_plan`` validates a :class:`~hetu_tpu_torch.parallel.Strategy` for
one device and records its remat policy and the precision policy in
force (``core.dtypes.autocast``); ``init_state`` builds the optimizer;
``build_train_step`` returns ``step(state, batch) -> (state, {"loss",
"grad_norm"})``, which runs forward and backward under that precision
policy (attention through the flash kernels on CUDA), accumulates fp32
grads over ``num_microbatches`` and applies one optimizer update — as
the JAX step keeps the policy it was traced under. ``build_eval_step``
returns the loss without grads or dropout.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import torch
from torch import nn

from hetu_tpu_torch import resolve_device
from hetu_tpu_torch.core.dtypes import Policy, autocast, current_policy
from hetu_tpu_torch.engine.state import TrainState
from hetu_tpu_torch.nn.parallel import remat_policy
from hetu_tpu_torch.ops.dropout import derive_seed
from hetu_tpu_torch.optim.clipping import global_norm
from hetu_tpu_torch.optim.optimizers import OptimizerSpec
from hetu_tpu_torch.parallel.strategy import Strategy

#: the base of every per-step dropout seed (``jax.random.key(0x0d0)``)
DROPOUT_BASE_SEED = 0x0D0


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """What the step needs to know of the strategy on this device."""

    strategy: Strategy
    device: torch.device
    remat: str                      # the effective remat policy name
    policy: Policy                  # the precision policy of every step


# -- capture accounting ------------------------------------------------------
# The port's counterpart of JAX's trace counter: a step body that runs as
# a captured CUDA graph (``serving/step_graph.py``) is captured once and
# replayed after, so a counter bumped at each capture is an exact
# re-capture count, as JAX's is a re-trace count.
_TRACE_COUNTS: dict[str, int] = {}
_TRACE_LOCK = threading.Lock()


def record_trace(what: str) -> None:
    """Count one capture of the step body ``what`` (``serving_decode``,
    ``serving_prefill``). A replay never calls it."""
    with _TRACE_LOCK:
        _TRACE_COUNTS[what] = _TRACE_COUNTS.get(what, 0) + 1


def trace_counts() -> dict[str, int]:
    """``{step body: capture count}`` since process start (or the last
    :func:`reset_trace_counts`), across all threads."""
    with _TRACE_LOCK:
        return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    with _TRACE_LOCK:
        _TRACE_COUNTS.clear()


def effective_remat(strategy: Strategy) -> str:
    return "offload" if strategy.offload else strategy.remat


def make_plan(model: nn.Module, opt: OptimizerSpec, strategy: Strategy,
              device=None) -> TrainPlan:
    """Validate ``strategy`` for one device (``device=None`` means
    ``cuda``; the model must live there) and record its remat policy and
    the current precision policy. ``opt`` is taken for the JAX
    signature."""
    del opt
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"the model lives on {model_dev}, the plan on "
                         f"{dev}")
    remat = effective_remat(strategy)
    remat_policy(remat)                  # raises on a name not ported
    return TrainPlan(strategy, model_dev, remat, current_policy())


def init_state(model: nn.Module, opt: OptimizerSpec,
               plan: TrainPlan) -> TrainState:
    """Step 0 with a fresh optimizer over the model's params (the model
    already holds its initial weights, drawn from its seed). The model's
    floating params are cast in place to the plan policy's
    ``param_dtype``, as ``hetu_tpu`` inits them in it
    (``nn/module.py:114``)."""
    model.to(plan.policy.param_dtype)
    return TrainState(0, model, opt.build(model))


def step_dropout_seed(step: int) -> int:
    """Per-step dropout seed: the same step gives the same masks, so a
    resumed run reproduces the mask sequence (``:477``)."""
    return derive_seed(DROPOUT_BASE_SEED, step)


def model_dropout_active(model: nn.Module) -> bool:
    """True iff the model's config enables any dropout rate."""
    cfg = getattr(model, "cfg", None)
    return any(getattr(cfg, f, 0.0) > 0.0 for f in
               ("embd_pdrop", "resid_pdrop", "attn_pdrop"))


def default_loss_fn(model: nn.Module, strategy: Strategy) -> Callable:
    """``loss(batch, dropout_seed=None)`` for LM models with ``.loss``."""

    def loss_fn(batch, dropout_seed=None):
        return model.loss(batch["input_ids"], batch["labels"],
                          positions=batch.get("positions"),
                          segment_ids=batch.get("segment_ids"),
                          remat=effective_remat(strategy),
                          remat_mask=strategy.remat_mask,
                          unroll=strategy.unroll, dropout_seed=dropout_seed)

    return loss_fn


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True)
            for k, v in batch.items() if v is not None}


def build_eval_step(model: nn.Module, plan: TrainPlan) -> Callable:
    """``eval(batch) -> loss`` (``:900``): :func:`default_loss_fn` under
    the plan's precision policy, without grads and without dropout; the
    loss stays on the device."""
    base_loss = default_loss_fn(model, plan.strategy)

    @torch.no_grad()
    def step(batch: dict):
        with autocast(plan.policy):
            return base_loss(_on_device(batch, plan.device))

    return step


def build_train_step(model: nn.Module, opt: OptimizerSpec,
                     plan: TrainPlan) -> Callable:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})`` (``:685``)
    over :func:`default_loss_fn`.

    ``batch`` maps names to tensors with the batch on dim 0; they move to
    the plan's device. ``opt`` is an optimizer spec or a ``chain`` of
    gradient transforms and one (clipping runs inside ``opt.step``, after
    ``grad_norm`` is taken, as JAX takes it before ``opt.update``). The grads come back in the param dtype (zeros for
    a param the loss does not reach, as in JAX) and go to the optimizer
    as they are (``p.grad`` is left unset). With
    ``num_microbatches = n > 1`` the batch splits into n equal
    microbatches whose grads sum in fp32 and are divided by n
    (``:830-848``); the loss is their mean. The global norm is taken in
    fp32. A frozen param (``requires_grad`` False: one that
    ``optim.masked`` leaves out) gets no grad, and ``grad_norm`` is then
    the trained params' norm, where JAX's also counts the frozen grads it
    computes and discards. Forward and backward run under the plan's
    precision policy.
    Dropout seeds are threaded only when the config enables dropout. The
    metrics stay on the device."""
    base_loss = default_loss_fn(model, plan.strategy)
    thread_dropout = model_dropout_active(model)
    nm = plan.strategy.num_microbatches

    def step(state: TrainState, batch: dict):
        # read at each step: ``opt.build`` (``init_state``) freezes the
        # params a ``masked`` optimizer leaves out
        trainable = [p for p in model.parameters() if p.requires_grad]
        batch = _on_device(batch, plan.device)
        seed = step_dropout_seed(state.step) if thread_dropout else None
        total = torch.zeros((), dtype=torch.float32, device=plan.device)
        grads = None
        for i in range(nm):
            mb = batch if nm == 1 else {
                k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                for k, v in batch.items()}
            mb_seed = seed if seed is None or nm == 1 \
                else derive_seed(seed, i)
            with autocast(plan.policy):
                loss = base_loss(mb, dropout_seed=mb_seed)
                mb_grads = torch.autograd.grad(loss, trainable,
                                               materialize_grads=True)
            total = total + loss.detach().float()
            if nm == 1:
                grads = list(mb_grads)
            elif grads is None:
                grads = [g.float() for g in mb_grads]
            else:
                for a, g in zip(grads, mb_grads):
                    a.add_(g)
        if nm > 1:
            for g in grads:
                g.div_(nm)
        gnorm = global_norm(grads)
        opt.step(state.optimizer, state.step, dict(zip(trainable, grads)))
        state.step += 1
        return state, {"loss": total / nm, "grad_norm": gnorm}

    return step
