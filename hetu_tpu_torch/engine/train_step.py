"""The single-device training step, captured (counterpart of
``hetu_tpu/engine/train_step.py``).

``make_plan`` validates a :class:`~hetu_tpu_torch.parallel.Strategy` for
one device and records its remat policy and the precision policy in
force (``core.dtypes.autocast``); ``init_state`` builds the optimizer;
``build_train_step`` returns ``step(state, batch) -> (state, {"loss",
"grad_norm"})``, which runs forward and backward under that precision
policy (attention through the flash kernels on CUDA), accumulates fp32
grads over ``num_microbatches`` and applies one optimizer update — as
the JAX step keeps the policy it was traced under. ``build_eval_step``
returns the loss without grads or dropout; ``build_grad_accum_steps``
splits a step into gradient calls and one update.

Each step is captured, as JAX's is jitted: on CUDA the first call with a
batch signature runs the step on a side stream and captures it as a CUDA
graph (``engine/step_graph.py``); every later call with that signature
copies the batch into the graph's static buffers, stages the host's
per-step scalars (the rate, the bias corrections, a scheduled decay, the
dropout seeds) into device operands, and replays. On the CPU the same
object runs the body eagerly over the same buffers. :class:`StepCache`
memoises the entries, one per (model, optimizer, strategy, policy,
bucket), as JAX's does its compiled ones.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import time
import warnings
from typing import Callable, Optional

import torch
from torch import nn

from hetu_tpu_torch import resolve_device, telemetry
from hetu_tpu_torch.core.dtypes import Policy, autocast, current_policy
from hetu_tpu_torch.engine.state import TrainState
from hetu_tpu_torch.engine.step_graph import StepGraph
from hetu_tpu_torch.nn.moe import expert_plane, make_expert_plane
from hetu_tpu_torch.nn.parallel import remat_policy
from hetu_tpu_torch.ops.dropout import SeedTable, derive_seed
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


def _thread_dropout(model: nn.Module, loss_fn: Optional[Callable],
                    base_loss: Callable, where: str = "") -> bool:
    """JAX's dropout contract (``:735-741``, ``:995-1006``): seeds are
    threaded only when the model's dropout is active and the loss takes
    ``dropout_seed`` (by name or through ``**kwargs``); a custom loss that
    cannot take one gets a warning, and dropout stays off."""
    params = inspect.signature(base_loss).parameters
    explicit = "dropout_seed" in params
    var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                 for p in params.values())
    active = model_dropout_active(model)
    if active and loss_fn is not None:
        if not (explicit or var_kw):
            warnings.warn(
                f"model config enables dropout but the custom loss_fn has "
                f"no dropout_seed parameter — dropout will be OFF{where}; "
                f"accept a dropout_seed kwarg (and pass it to model.loss) "
                f"to enable it", stacklevel=3)
        elif var_kw and not explicit:
            warnings.warn(
                "dropout_seed will be passed to the custom loss_fn via "
                "**kwargs — make sure it forwards the seed to model.loss, "
                "or dropout silently stays off", stacklevel=3)
    return active and (explicit or var_kw)


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True)
            for k, v in batch.items() if v is not None}


def _batch_key(batch: dict) -> tuple:
    """Shape/dtype signature of a batch dict (tensors, numpy arrays —
    anything with ``.shape``/``.dtype``)."""
    def sig(v):
        if not hasattr(v, "shape") or not hasattr(v, "dtype"):
            import numpy as np
            v = np.asarray(v)
        return tuple(v.shape), str(v.dtype)

    return tuple(sorted((k,) + sig(v) for k, v in batch.items()
                        if v is not None))


# -- the captured entry ------------------------------------------------------

class GraphPool:
    """One CUDA graph memory pool shared by the captured entries that use
    it: a Trainer's bucket and eval entries, a split-phase pair. Their
    graphs never replay concurrently, and none keeps a tensor in the
    pool past its capture (static outputs are made outside it), so a
    later capture reuses what an earlier one freed: N graphs cost about
    the largest, not the sum. The memory goes back to the allocator once
    no graph holds the pool."""

    def __init__(self):
        self._handle = None

    def handle(self, device: torch.device):
        """The pool's handle on ``cuda`` (None on the CPU)."""
        if self._handle is None and device.type == "cuda":
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class CapturedStep:
    """One step body, captured once per batch signature (``_batch_key``),
    as a jitted JAX function keeps one executable per shape.

    ``run(bufs)`` is the body over a signature's static batch buffers; it
    returns a tuple of tensors. :meth:`call` copies the batch into the
    buffers and replays (the first call of a signature runs the body and
    captures it: ``record_trace(name)``). The host stages the step's
    scalars before :meth:`call`. ``bind`` names the objects whose storage
    the graphs read (the params, the optimizer): when one of them is
    replaced (a fresh optimizer, a reallocated param), every graph is
    dropped and the next call re-captures, so a stale graph never replays
    old addresses.

    Every graph of the entry captures into one :class:`GraphPool` (its
    own, or ``pool``, one shared with other entries), so N signatures
    cost about the largest pool, not the sum. That is sound because
    nothing that outlives a replay lives in the pool: each signature's
    static outputs are buffers made by its warm-up run, before its
    capture (the params, the optimizer state and the batch buffers were
    made before too). :meth:`release` drops the graphs (the pool's memory
    goes back once no graph holds it); the next call captures again."""

    def __init__(self, name: str, plan: TrainPlan,
                 run: Callable[[dict], tuple], *, seeds: bool = True,
                 pool: Optional[GraphPool] = None):
        self.name = name
        self.plan = plan
        self._run = run
        self.seeds = SeedTable(plan.device) if seeds else None
        self.graphs: dict = {}           # signature -> (StepGraph, bufs)
        #: signature -> whether its body wrote the expert plane when it
        #: was captured (a replay writes what its capture wrote)
        self.armed: dict = {}
        self._bound = None
        self.pool = pool if pool is not None else GraphPool()

    def bind(self, *objs) -> None:
        key = tuple(o.data_ptr() if isinstance(o, torch.Tensor) else id(o)
                    for o in objs)
        if key != self._bound:
            self.release()
            self._bound = key

    def release(self) -> None:
        """Drop every graph (the pool's memory goes back to the
        allocator once no graph holds it)."""
        self.graphs.clear()
        self.armed.clear()

    def call(self, batch: dict) -> tuple:
        sig = _batch_key(batch)
        entry = self.graphs.get(sig)
        if entry is not None:
            graph, bufs = entry
            for k, v in batch.items():
                bufs[k].copy_(v, non_blocking=True)
            with autocast(self.plan.policy):
                return graph.replay()
        bufs = {k: v.clone() for k, v in batch.items()}
        outs: list = []

        def body() -> tuple:
            res = self._run(bufs)
            if not outs:                 # the warm-up run: outside the pool
                outs.extend(torch.empty_like(r) for r in res)
            for o, r in zip(outs, res):
                o.copy_(r)
            return tuple(outs)

        with autocast(self.plan.policy):
            graph = StepGraph(self.name, body, device=self.plan.device,
                              seeds=self.seeds,
                              pool=self.pool.handle(self.plan.device))
        self.graphs[sig] = (graph, bufs)
        return graph.first

    def run_eager(self, batch: dict) -> tuple:
        """The body on ``batch`` itself, with no graph: the reference a
        replay is held to, bit for bit (the host stages the step's
        scalars first, as for :meth:`call`)."""
        with torch.no_grad(), autocast(self.plan.policy):
            return tuple(self._run(batch))

    def arm(self, plane, batch: dict) -> None:
        """Stage ``plane`` (an ``nn.moe.ExpertPlane`` or None) for the
        next :meth:`call`: a call that runs the body (the CPU, or a new
        signature's capture) arms it when telemetry is on; a replay is
        armed as its own signature's capture was."""
        if plane is None:
            return
        sig = _batch_key(batch)
        if self.plan.device.type != "cuda" or sig not in self.graphs:
            plane.armed = self.armed[sig] = telemetry.enabled()
        else:
            plane.armed = self.armed[sig]
        plane.stage()

    @property
    def captures(self) -> int:
        return sum(g.captures for g, _ in self.graphs.values())

    @property
    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g, _ in self.graphs.values())


class TrainStep:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``, what
    :func:`build_train_step` returns: the captured step. The metrics are
    the graph's static outputs, overwritten by the next replay (a caller
    that keeps one clones it). :meth:`body` is the same step run
    eagerly, for checks."""

    def __init__(self, model: nn.Module, opt, plan: TrainPlan,
                 base_loss: Callable, thread_dropout: bool,
                 expert_steps: int = 1, pool: Optional[GraphPool] = None):
        self.model, self.opt, self.plan = model, opt, plan
        self._loss = base_loss
        self.thread_dropout = thread_dropout
        self._optimizer = None
        self.entry = CapturedStep("train_step", plan, self._run, pool=pool)
        #: the MoE layers' expert-plane ring (None for a dense model)
        self.plane = make_expert_plane(model, steps=expert_steps,
                                       backward=True)

    def _run(self, batch: dict) -> tuple:
        plane = self.plane if self.plane is not None \
            and self.plane.armed else None
        with expert_plane(plane):
            return self._run_body(batch)

    def _run_body(self, batch: dict) -> tuple:
        plan, nm = self.plan, self.plan.strategy.num_microbatches
        # read at each capture: ``opt.build`` (``init_state``) freezes the
        # params a ``masked`` optimizer leaves out
        trainable = [p for p in self.model.parameters() if p.requires_grad]
        seed = self.entry.seeds.seed() if self.thread_dropout else None
        total = torch.zeros((), dtype=torch.float32, device=plan.device)
        grads = None
        for i in range(nm):
            mb = batch if nm == 1 else {
                k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                for k, v in batch.items()}
            mb_seed = seed if seed is None or nm == 1 \
                else derive_seed(seed, i)
            with torch.enable_grad(), autocast(plan.policy):
                loss = (self._loss(mb, dropout_seed=mb_seed)
                        if self.thread_dropout else self._loss(mb))
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
        self.opt.update(self._optimizer, dict(zip(trainable, grads)))
        return total / nm, gnorm

    def _stage(self, state: TrainState, batch: dict) -> dict:
        self._optimizer = state.optimizer
        self.entry.bind(state.optimizer,
                        *[p for p in self.model.parameters()])
        self.opt.stage(state.optimizer, state.step)
        if self.thread_dropout:
            self.entry.seeds.stage(step_dropout_seed(state.step))
        return _on_device(batch, self.plan.device)

    def __call__(self, state: TrainState, batch: dict):
        batch = self._stage(state, batch)
        self.entry.arm(self.plane, batch)
        loss, gnorm = self.entry.call(batch)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    def body(self, state: TrainState, batch: dict):
        """The step run eagerly (no graph), with the same staging."""
        loss, gnorm = self.entry.run_eager(self._stage(state, batch))
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}


class EvalStep:
    """``eval(batch) -> loss``, what :func:`build_eval_step` returns: the
    captured forward (``record_trace("eval_step")``); the loss is the
    graph's static output. :meth:`body` runs it eagerly."""

    def __init__(self, plan: TrainPlan, base_loss: Callable, model=None,
                 pool: Optional[GraphPool] = None):
        self.plan = plan
        self._loss = base_loss
        self.entry = CapturedStep("eval_step", plan, self._run, seeds=False,
                                  pool=pool)
        #: the MoE layers' expert-plane ring: one step, drained after
        #: each read of the loss
        self.plane = None if model is None \
            else make_expert_plane(model, steps=1, backward=False)

    def _run(self, batch: dict) -> tuple:
        plane = self.plane if self.plane is not None \
            and self.plane.armed else None
        with expert_plane(plane):
            return (self._loss(batch),)

    def __call__(self, batch: dict):
        batch = _on_device(batch, self.plan.device)
        self.entry.arm(self.plane, batch)
        return self.entry.call(batch)[0]

    def body(self, batch: dict):
        return self.entry.run_eager(_on_device(batch, self.plan.device))[0]


def build_eval_step(model: nn.Module, plan: TrainPlan, *,
                    loss_fn: Optional[Callable] = None,
                    pool: Optional[GraphPool] = None) -> EvalStep:
    """``eval(batch) -> loss`` (``:900``): ``loss_fn(batch)`` (default
    :func:`default_loss_fn`) under the plan's precision policy, without
    grads and without dropout, captured (into ``pool`` when given); the
    loss stays on the device."""
    return EvalStep(plan, loss_fn or default_loss_fn(model, plan.strategy),
                    model, pool=pool)


def build_train_step(model: nn.Module, opt: OptimizerSpec,
                     plan: TrainPlan, *,
                     loss_fn: Optional[Callable] = None,
                     expert_steps: int = 1,
                     pool: Optional[GraphPool] = None) -> TrainStep:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})`` (``:685``)
    over ``loss_fn(batch[, dropout_seed=])`` (default
    :func:`default_loss_fn`), captured.

    ``batch`` maps names to tensors with the batch on dim 0; they move to
    the plan's device. ``opt`` is an optimizer spec or a ``chain`` of
    gradient transforms and one (clipping runs inside the update, after
    ``grad_norm`` is taken, as JAX takes it before ``opt.update``). The
    grads come back in the param dtype (zeros for a param the loss does
    not reach, as in JAX) and go to the optimizer as they are (``p.grad``
    is left unset). With ``num_microbatches = n > 1`` the batch splits
    into n equal microbatches whose grads sum in fp32 and are divided by
    n (``:830-848``); the loss is their mean. The global norm is taken in
    fp32. A frozen param (``requires_grad`` False: one that
    ``optim.masked`` leaves out) gets no grad, and ``grad_norm`` is then
    the trained params' norm, where JAX's also counts the frozen grads it
    computes and discards. Forward and backward run under the plan's
    precision policy. Dropout seeds are threaded when the config enables
    dropout and the loss takes ``dropout_seed`` (JAX's contract, with its
    warnings for a custom loss). The metrics stay on the device. An MoE
    model's step captured with telemetry on writes its expert-plane stats
    into ``step.plane``, a ring of ``expert_steps`` steps that the host
    drains (``step.plane.drain()``) where it reads the device. ``pool``
    (a :class:`GraphPool`) shares the step's graph pool with other
    entries."""
    base_loss = loss_fn or default_loss_fn(model, plan.strategy)
    return TrainStep(model, opt, plan, base_loss,
                     _thread_dropout(model, loss_fn, base_loss),
                     expert_steps=expert_steps, pool=pool)


# -- split-phase accumulation ------------------------------------------------

class GradAccumulator:
    """The fp32, param-shaped grad accumulator of
    :func:`build_grad_accum_steps` (what ``init_acc`` returns): views of
    the entry's own buffers, so the captured steps read fixed addresses.
    ``consumed`` is set when a donating ``apply_step`` takes it."""

    def __init__(self, grads: list):
        self.grads = grads
        self.consumed = False


def build_grad_accum_steps(model: nn.Module, opt: OptimizerSpec,
                           plan: TrainPlan, *,
                           loss_fn: Optional[Callable] = None,
                           donate_acc: bool = True,
                           delay_grad_sync: bool = False):
    """Split-phase training (``:912``): ``(init_acc, grad_step,
    apply_step)``.

    - ``acc = init_acc()``: the zeroed fp32 accumulator (the entry's own
      buffers, zero-filled);
    - ``acc, loss = grad_step(state, acc, batch, accum_index=i)``: one
      forward/backward, its grads added into ``acc``. Dropout seeds fold
      (step, i) as JAX's keys do; ``i`` is a staged operand, so every
      index replays one graph;
    - ``state, metrics = apply_step(state, acc, n_accum)``: the mean over
      ``n_accum`` (a staged operand), its global norm and one optimizer
      update.

    ``grad_step`` and ``apply_step`` are captured entries
    (``record_trace("grad_step")``, ``"apply_step"``). With
    ``donate_acc=True`` ``apply_step`` consumes ``acc`` and a later
    ``init_acc(like=acc)`` raises, as JAX's deleted buffer does; with
    ``donate_acc=False`` ``init_acc(like=acc)`` zero-fills it again and
    allocates nothing. ``delay_grad_sync=True`` changes nothing on one
    device (JAX's is off with one group) and is refused with ``fsdp``, as
    JAX's is."""
    strategy = plan.strategy
    if strategy.pp > 1:
        raise NotImplementedError(
            "split-phase accumulation with pp > 1: use "
            "num_microbatches inside the pipeline step instead")
    if delay_grad_sync and strategy.fsdp:
        raise ValueError(
            "delay_grad_sync=True is incompatible with fsdp: params are "
            "dp-sharded, so group-local gradients would require the "
            "param all-gather the delay is meant to avoid")
    base_loss = loss_fn or default_loss_fn(model, strategy)
    thread_dropout = _thread_dropout(
        model, loss_fn, base_loss, where=" in build_grad_accum_steps")
    n_accum_t = torch.ones((), dtype=torch.float32, device=plan.device)
    # the trained params (read at the first init_acc, after ``opt.build``
    # froze what a ``masked`` optimizer leaves out) and their accumulator
    cur: dict = {}

    def grad_run(batch):
        seed = grad_entry.seeds.seed() if thread_dropout else None
        with torch.enable_grad(), autocast(plan.policy):
            loss = (base_loss(batch, dropout_seed=seed) if thread_dropout
                    else base_loss(batch))
            grads = torch.autograd.grad(loss, cur["params"],
                                        materialize_grads=True)
        for a, g in zip(cur["acc"], grads):
            a.add_(g)
        return (loss.detach(),)

    def apply_run(_batch):
        grads = torch._foreach_div(cur["acc"], n_accum_t)
        gnorm = global_norm(grads)
        opt.update(cur["optimizer"], dict(zip(cur["params"], grads)))
        return (gnorm,)

    pool = GraphPool()                   # the two phases never overlap
    grad_entry = CapturedStep("grad_step", plan, grad_run, pool=pool)
    apply_entry = CapturedStep("apply_step", plan, apply_run, seeds=False,
                               pool=pool)

    def init_acc(like: Optional[GradAccumulator] = None) -> GradAccumulator:
        if like is not None:
            if like.consumed:
                raise RuntimeError(
                    "init_acc(like=acc): the accumulator was donated to "
                    "apply_step (donate_acc=True) and deleted")
            torch._foreach_zero_(like.grads)
            return like
        if "acc" not in cur:
            cur["params"] = [p for p in model.parameters()
                             if p.requires_grad]
            cur["acc"] = [torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                          for p in cur["params"]]
        torch._foreach_zero_(cur["acc"])
        return GradAccumulator(cur["acc"])

    def _check(acc: GradAccumulator):
        if acc.consumed:
            raise RuntimeError("the accumulator was donated to apply_step "
                               "(donate_acc=True) and deleted")

    def grad_step(state: TrainState, acc: GradAccumulator, batch: dict,
                  accum_index: int = 0):
        _check(acc)
        grad_entry.bind(*cur["params"])
        if thread_dropout:
            grad_entry.seeds.stage(derive_seed(step_dropout_seed(state.step),
                                               accum_index))
        loss, = grad_entry.call(_on_device(batch, plan.device))
        return acc, loss

    def apply_step(state: TrainState, acc: GradAccumulator, n_accum: int):
        _check(acc)
        cur["optimizer"] = state.optimizer
        apply_entry.bind(state.optimizer, *cur["params"])
        opt.stage(state.optimizer, state.step)
        n_accum_t.copy_(torch.tensor(float(n_accum), dtype=torch.float32),
                        non_blocking=True)
        gnorm, = apply_entry.call({})
        state.step += 1
        if donate_acc:
            acc.consumed = True
        return state, {"grad_norm": gnorm}

    grad_step.entry, apply_step.entry = grad_entry, apply_entry
    return init_acc, grad_step, apply_step


# -- step cache --------------------------------------------------------------

class CachedStep:
    """One compiled strategy (``:236``): the plan, the captured step and
    its eval. Calling the entry runs the step. ``compile_seconds`` is
    the time its build took (the graphs capture at their first call)."""

    __slots__ = ("plan", "step_fn", "eval_fn", "compile_seconds", "_refs")

    def __init__(self, plan, step_fn, eval_fn=None, *,
                 compile_seconds: float = 0.0, refs: tuple = ()):
        self.plan = plan
        self.step_fn = step_fn
        self.eval_fn = eval_fn
        self.compile_seconds = compile_seconds
        # strong refs (model, opt): entries are keyed by object identity,
        # pinning the objects guarantees an id() is never reused while
        # its cache entry is alive
        self._refs = refs

    def __call__(self, state, batch):
        return self.step_fn(state, batch)

    def release(self) -> None:
        """Drop the graphs (and their pools) of the step and the eval."""
        for fn in (self.step_fn, self.eval_fn):
            entry = getattr(fn, "entry", None)
            if entry is not None:
                entry.release()


def _release(entry) -> None:
    """Release a cache entry's graphs (anything else a caller cached
    has none)."""
    release = getattr(entry, "release", None)
    if release is not None:
        release()


class StepCache:
    """Memo of :class:`CachedStep` entries keyed by (model, optimizer,
    Strategy, attn_impl, donate, policy, devices, bucket) (``:291``): a
    bounded LRU, thread-safe, with single-flight builds (two callers
    racing to one key build it once). :meth:`clear` bumps a generation:
    a build in flight across a clear is handed to its caller but never
    re-enters the pool. An entry that leaves the cache (evicted,
    :meth:`discard`, :meth:`clear`) releases its graphs and their pools;
    a caller still holding it captures again at its next call."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._entries: dict = {}          # insertion-ordered => LRU
        self._building: dict = {}         # key -> threading.Event
        self._gen = 0
        self._lock = threading.RLock()

    @staticmethod
    def key_for(model, opt, strategy, *, attn_impl: str = "auto",
                donate: bool = True, policy_key: str = "",
                devices=None, bucket: int = 0) -> tuple:
        """``bucket``: the seq-len bucket this entry serves (0 = the
        unbucketed entry)."""
        dev_key = None if devices is None else \
            tuple(getattr(d, "id", d) for d in devices)
        return (id(model), id(opt), strategy, attn_impl, donate,
                policy_key, dev_key, int(bucket))

    def _count(self, hit: bool) -> None:
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        if telemetry.enabled():
            telemetry.get_registry().counter(
                "step_cache_hits_total" if hit
                else "step_cache_misses_total",
                "StepCache lookups that found / missed a compiled "
                "entry").inc()

    def lookup(self, key) -> Optional[CachedStep]:
        """Peek without building (does not count a miss)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:                    # refresh LRU order
                self._entries.pop(key)
                self._entries[key] = entry
            return entry

    def get_or_build(self, key, builder: Callable[[], CachedStep]
                     ) -> CachedStep:
        """The cached entry for ``key``, built once (even under
        concurrent callers) by ``builder`` on a miss."""
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.pop(key)
                    self._entries[key] = entry
                    self._count(hit=True)
                    return entry
                ev = self._building.get(key)
                if ev is None:
                    ev = self._building[key] = threading.Event()
                    gen = self._gen
                    break
            ev.wait()        # another thread is building this key
        try:
            entry = builder()
        except BaseException:
            with self._lock:
                self._building.pop(key, None)
            ev.set()
            raise
        with self._lock:
            if self._gen == gen:
                self._entries[key] = entry
                while len(self._entries) > self.capacity:
                    _release(self._entries.pop(next(iter(self._entries))))
                    self.evictions += 1
            self._count(hit=False)
            self._building.pop(key, None)
        ev.set()
        return entry

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "hit_rate": self.hits / total if total else 0.0}

    def clear(self) -> None:
        with self._lock:
            for entry in self._entries.values():
                _release(entry)
            self._entries.clear()
            self._gen += 1   # in-flight builds must not re-insert

    def discard(self, key) -> None:
        """Drop ``key``'s entry, if cached, and release its graphs."""
        with self._lock:
            entry = self._entries.pop(key, None)
        _release(entry)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries


_STEP_CACHE = StepCache()


def get_step_cache() -> StepCache:
    """The process-default :class:`StepCache` (shared by Trainers unless
    one is injected)."""
    return _STEP_CACHE


def compile_strategy(model: nn.Module, opt: OptimizerSpec,
                     strategy: Strategy, *, device=None,
                     loss_fn: Optional[Callable] = None,
                     build_eval: bool = True,
                     expert_steps: int = 1,
                     pool: Optional[GraphPool] = None) -> CachedStep:
    """Plan and build the captured step (and eval) for one strategy
    (``:423``) under the precision policy in force; the graphs capture
    at their first call. Callers wanting memoisation go through
    :meth:`StepCache.get_or_build`. ``expert_steps``: the step's
    expert-plane ring (an MoE model's steps between two drains);
    ``pool``: the graph pool the step and the eval capture into (one of
    their own by default)."""
    t0 = time.perf_counter()
    with telemetry.span("build_plan_and_step",
                        strategy=strategy.to_json()):
        plan = make_plan(model, opt, strategy, device=device)
        pool = pool if pool is not None else GraphPool()
        step_fn = build_train_step(model, opt, plan, loss_fn=loss_fn,
                                   expert_steps=expert_steps, pool=pool)
        eval_fn = build_eval_step(model, plan, loss_fn=loss_fn,
                                  pool=pool) if build_eval else None
    return CachedStep(plan, step_fn, eval_fn,
                      compile_seconds=time.perf_counter() - t0,
                      refs=(model, opt))


__all__ = ["CachedStep", "CapturedStep", "DROPOUT_BASE_SEED", "EvalStep",
           "GradAccumulator", "GraphPool", "StepCache", "TrainPlan", "TrainStep",
           "build_eval_step", "build_grad_accum_steps", "build_train_step",
           "compile_strategy", "default_loss_fn", "effective_remat",
           "get_step_cache", "init_state", "make_plan",
           "model_dropout_active", "step_dropout_seed"]
