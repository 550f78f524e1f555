"""Trainer: the user-facing training loop (counterpart of
``hetu_tpu/engine/trainer.py:40 TrainerConfig``, ``:141 Trainer``).

A Trainer owns the model, the optimizer spec, the plan of its strategy
for one device and the train state. Its step and eval come from a
:class:`~hetu_tpu_torch.engine.train_step.StepCache` (the process-wide
one unless ``step_cache=`` injects another): one captured entry per
(model, optimizer, strategy, policy, seq-len bucket), as JAX's trainer
keeps one compiled entry per key. ``train`` runs the step over an
iterator of host batches (``hetu_tpu_torch.data.build_data_loader``),
staged through the device prefetcher; it keeps the step counter on the
host and reads ``loss``/``grad_norm`` from the device only at log
boundaries, so the host never waits on the card between them.

With ``TrainerConfig(seq_buckets=...)`` each host batch is snapped, on
the host and before the prefetcher stages it, to the smallest bucket
that holds its longest real row (``data.bucket.ShapeBucketer``), and
runs through that bucket's entry: a ragged epoch captures at most one
step graph per bucket.

Checkpoints (``save``, ``resume``, the ``ckpt_every`` cadence and the
final save of ``train``; ``utils/checkpoint.py``) are in ``hetu_tpu``'s
format, so a run of either package resumes from the other's. Not
ported: distributed and delta checkpoints, telemetry and goodput, AOT
precompilation and the persistent compile cache, the watchdog and SLO
engine, hot switching (``set_strategy``, ``shrink_to``/``grow_to``),
``train_dynamic`` — ``TrainerConfig`` has no field for any of them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Callable, Iterable, Optional

from torch import nn

from hetu_tpu_torch import resolve_device
from hetu_tpu_torch.core.dtypes import BF16_COMPUTE, FP32, Policy, autocast
from hetu_tpu_torch.data.bucket import SeqLenBuckets, ShapeBucketer
from hetu_tpu_torch.data.prefetch import DevicePrefetcher, to_tensors
from hetu_tpu_torch.engine.state import TrainState
from hetu_tpu_torch.engine.train_step import (
    CachedStep, StepCache, compile_strategy, get_step_cache, init_state,
)
from hetu_tpu_torch.parallel.strategy import Strategy
from hetu_tpu_torch.utils.checkpoint import (
    CheckpointWriter, copy_optimizer_state, load_checkpoint, save_checkpoint,
)

log = logging.getLogger("hetu_tpu_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    """The fields of ``hetu_tpu``'s ``TrainerConfig`` that the port
    honours.

    ``seed``: ``None`` keeps the weights the model holds (drawn from its
    own seed when it was built, or loaded); an int draws them again with
    ``model.reset_parameters(seed)`` when the state is built, as JAX's
    ``initialize`` draws params from ``jax.random.key(seed)``.
    ``precision``: ``"bf16"`` (fp32 params, bf16 compute) or ``"fp32"``.
    ``prefetch``: device-prefetch depth for ``train`` (0: none).
    ``eval_every``: validation cadence of ``train`` (0: off).
    ``peak_flops``: the card's peak; the log records then carry ``mfu``.
    ``ckpt_dir``: where ``save`` writes by default; with it set, ``train``
    saves every ``ckpt_every`` steps (0: only at its end) and once more
    when it ends. ``async_ckpt``: the file write of a save runs on a
    thread (the host snapshot is taken before ``save`` returns).
    """

    total_steps: int = 1000
    log_every: int = 10
    seed: Optional[int] = None
    precision: str = "bf16"
    prefetch: int = 2
    eval_every: int = 0
    peak_flops: Optional[float] = None
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    async_ckpt: bool = True
    seq_buckets: Optional[tuple] = None
    step_cache: bool = True

    def __post_init__(self):
        if self.precision not in ("bf16", "fp32"):
            raise ValueError(f"precision must be bf16 or fp32, got "
                             f"{self.precision!r}")

    def policy(self) -> Policy:
        return BF16_COMPUTE if self.precision == "bf16" else FP32


def flops_per_token(model: nn.Module, seq_len: int) -> Optional[float]:
    """``bench.py:133``: 6 N for the matmuls plus 6 L H s for causal
    attention; None for a model without transformer dims."""
    cfg = getattr(model, "cfg", None)
    if cfg is None or not hasattr(cfg, "num_layers"):
        return None
    n_params = sum(p.numel() for p in model.parameters())
    return 6.0 * n_params + 6.0 * cfg.num_layers * cfg.hidden_size * seq_len


class Trainer:
    """``Trainer(model, opt, strategy, config=None, device=None,
    step_cache=None)``: the plan is made under ``config.precision``'s
    policy on ``device`` (``None`` means ``cuda`` and raises without a
    card; the model must live there). ``self.cache`` (alias
    ``_plan_cache``) is the step cache; ``self.bucketer`` the
    ``ShapeBucketer`` of ``config.seq_buckets`` (None when off)."""

    def __init__(self, model: nn.Module, opt, strategy: Strategy,
                 config: Optional[TrainerConfig] = None, device=None,
                 step_cache: Optional[StepCache] = None):
        self.model = model
        self.opt = opt
        self.config = config if config is not None else TrainerConfig()
        self.strategy = strategy
        self.device = resolve_device(device)
        self.cache = step_cache if step_cache is not None \
            else get_step_cache()
        # kept as an alias, as JAX's trainer keeps it
        self._plan_cache = self.cache
        self.bucketer = None
        if self.config.seq_buckets:
            self.bucketer = ShapeBucketer(
                SeqLenBuckets(sizes=self.config.seq_buckets))
        self._bucket_entries: dict = {}
        self.state: Optional[TrainState] = None
        base = self._entry(0)
        self.plan = base.plan
        self._step_fn = base.step_fn
        self._eval_fn = base.eval_fn
        self._ckpt_writer: Optional[CheckpointWriter] = None
        self._saved_step: Optional[int] = None
        #: the last save: ``path``, ``step``, ``blocked_s`` (the time it
        #: held the caller: the previous write's drain and the snapshot)
        self.last_save: Optional[dict] = None

    # -- the step cache and the shape plane ---------------------------------
    def _cache_key(self, strategy: Strategy, bucket: int = 0) -> tuple:
        return self.cache.key_for(
            self.model, self.opt, strategy, donate=True,
            policy_key=self.config.precision, devices=(str(self.device),),
            bucket=bucket)

    def _entry(self, bucket: int) -> CachedStep:
        """The cached entry of (strategy, ``bucket``), built on a miss
        under the config's policy (``config.step_cache=False``: built
        anew)."""
        def build() -> CachedStep:
            with autocast(self.config.policy()):
                return compile_strategy(self.model, self.opt, self.strategy,
                                        device=self.device)

        if not self.config.step_cache:
            return build()
        return self.cache.get_or_build(
            self._cache_key(self.strategy, bucket), build)

    def _bucket_entry(self, bucket: int) -> CachedStep:
        """The entry of (current strategy, ``bucket``): one per bucket,
        so each captures exactly one batch shape (``:340``)."""
        entry = self._bucket_entries.get(bucket)
        if entry is None:
            entry = self._bucket_entries[bucket] = self._entry(bucket)
        return entry

    def _step_entry_for(self, batch: dict):
        """The step for a fitted batch: its bucket's entry when bucketing
        is on, else the strategy's base step (``:376``)."""
        if self.bucketer is None or "input_ids" not in batch:
            return self._step_fn
        return self._bucket_entry(int(batch["input_ids"].shape[1]))

    def captures(self) -> dict:
        """``{bucket (0: the base entry): train-step graphs captured}``
        of this trainer's entries, with their pools' bytes."""
        out = {0: (self._step_fn.entry.captures,
                   self._step_fn.entry.pool_bytes)}
        for b, e in self._bucket_entries.items():
            out[b] = (e.step_fn.entry.captures, e.step_fn.entry.pool_bytes)
        return out

    def initialize(self) -> TrainState:
        """Step 0: the weights (drawn again from ``config.seed`` if it is
        set) cast to the policy's param dtype, and a fresh optimizer."""
        if self.config.seed is not None:
            self.model.reset_parameters(self.config.seed)
        self.state = init_state(self.model, self.opt, self.plan)
        return self.state

    def resume(self, path: str) -> TrainState:
        """The state saved at ``path`` (by this package or by
        ``hetu_tpu``): the weights into the model, in the plan policy's
        param dtype and on its device, and a fresh optimizer holding the
        saved moments and counts. ``train`` then goes on from its step;
        the caller passes the batches that remain (``:442``). Into a live
        trainer the params and the optimizer state are copied in place,
        so its captured steps stay valid."""
        self.model.to(self.plan.policy.param_dtype)
        loaded = load_checkpoint(path, self.model, self.opt)
        if self.state is None:
            self.state = loaded
        else:
            # into the live state's tensors, which the captured steps
            # read by address (a param that ``to`` reallocated makes its
            # entries re-capture)
            copy_optimizer_state(self.state.optimizer, loaded.optimizer)
            self.state.step = loaded.step
        log.info(f"resumed from {path} at step {self.state.step}")
        return self.state

    def save(self, path: Optional[str] = None, *, wait: bool = False):
        """Save the state to ``path`` (default ``config.ckpt_dir``;
        raises if neither is set). One save is in flight at a time: a
        save first waits for the previous write. The snapshot is taken
        before this returns; with ``config.async_ckpt`` and not ``wait``
        the write goes on after it, on a thread (``:462-501``). Returns
        the path."""
        path = path or self.config.ckpt_dir
        if path is None:
            raise ValueError("no checkpoint path configured")
        if self.state is None:
            raise ValueError("no train state to save: initialize, resume "
                             "or train first")
        t0 = time.perf_counter()
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
        self._ckpt_writer = save_checkpoint(
            path, self.state, async_save=self.config.async_ckpt and not wait)
        self._saved_step = self.state.step
        self.last_save = {"path": path, "step": self.state.step,
                          "blocked_s": time.perf_counter() - t0,
                          "writer": self._ckpt_writer}
        return path

    def close(self) -> None:
        """Wait for the write in flight, if any (idempotent)."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
            self._ckpt_writer = None

    def train_step(self, batch: dict) -> dict:
        """One step on one batch (numpy arrays or tensors), fitted to its
        bucket first when bucketing is on; the metrics stay on the device
        (copies of the step's static outputs, which the next step
        overwrites)."""
        if self.state is None:
            self.initialize()
        if self.bucketer is not None:
            batch = self.bucketer.fit(batch)
        batch = to_tensors(batch)
        self.state, metrics = self._step_entry_for(batch)(self.state, batch)
        return {k: v.clone() for k, v in metrics.items()}

    def _batches(self, batches: Iterable[dict], steps: int):
        if self.config.prefetch > 0:
            return DevicePrefetcher(batches, self.plan.device,
                                    buffer_size=self.config.prefetch,
                                    max_items=steps)
        return (to_tensors(b) for b in batches)

    def train(self, batches: Iterable[dict], steps: Optional[int] = None,
              *, eval_batches: Optional[Callable[[], Iterable[dict]]] = None
              ) -> list:
        """Run up to ``steps`` (default ``config.total_steps``) steps, or
        until ``batches`` ends; returns the log records.

        Every ``log_every`` steps one record: ``step``, ``loss`` and
        ``grad_norm`` of that step (the norm before any clipping),
        ``tokens_per_sec`` since the last record (every token of the
        batch as the step ran it, pads included: the fitted width when
        bucketing is on, as JAX counts), ``tokens_total``, and
        ``mfu`` with ``config.peak_flops``. ``eval_batches`` is a
        callable returning an iterable of held-out batches: every
        ``eval_every`` steps the mean validation loss (dropout off) is
        logged as ``eval_loss``. With ``config.ckpt_dir`` set, every
        ``ckpt_every`` steps a save, and at the end one whose write is
        waited for (``:690-700``); where the cadence has just saved the
        last step, its write is waited for instead of a second save of
        the same state."""
        if self.state is None:
            self.initialize()
        steps = steps if steps is not None else self.config.total_steps
        history = []
        host_step = self.state.step
        t0 = t_last = time.perf_counter()
        tokens_since = tokens_total = 0
        flops_since = 0.0
        fpt_by_width: dict = {}
        if self.bucketer is not None:
            # snap every host batch to its bucket before the prefetcher
            # stages it: each entry sees exactly one shape
            batches = (self.bucketer.fit(b) for b in batches)
        it = self._batches(batches, steps)
        try:
            for _ in range(steps):
                try:
                    batch = next(it)
                except StopIteration:
                    break
                self.state, metrics = self._step_entry_for(batch)(
                    self.state, batch)
                host_step += 1
                ids = batch["input_ids"]
                width = int(ids.shape[-1])
                if width not in fpt_by_width:
                    fpt_by_width[width] = flops_per_token(self.model, width)
                ntok = int(ids.numel())
                tokens_since += ntok
                tokens_total += ntok
                flops_since += (fpt_by_width[width] or 0.0) * ntok
                if self.config.log_every \
                        and host_step % self.config.log_every == 0:
                    rec = {"kind": "metrics", "step": host_step,
                           "loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"])}
                    now = time.perf_counter()
                    rec.update(elapsed_s=now - t0,
                               tokens_per_sec=tokens_since / (now - t_last),
                               tokens_total=tokens_total)
                    if self.config.peak_flops:
                        rec["mfu"] = flops_since / (now - t_last) \
                            / self.config.peak_flops
                    history.append(self._log(rec))
                    t_last, tokens_since, flops_since = now, 0, 0.0
                if self.config.eval_every and eval_batches is not None \
                        and host_step % self.config.eval_every == 0:
                    history.append(self._log({
                        "kind": "metrics", "step": host_step,
                        "eval_loss": self.evaluate(eval_batches())}))
                if self.config.ckpt_every and self.config.ckpt_dir \
                        and host_step % self.config.ckpt_every == 0:
                    self.save()
            if self.config.ckpt_dir:
                if self._saved_step == self.state.step:
                    self.close()
                else:
                    self.save(wait=True)
        finally:
            if isinstance(it, DevicePrefetcher):
                it.close()
        return history

    def evaluate(self, batches: Iterable[dict]) -> float:
        """Mean loss over ``batches`` under the plan's policy, without
        dropout."""
        total, n = 0.0, 0
        for batch in batches:
            total += float(self._eval_fn(to_tensors(batch)))
            n += 1
        return total / max(n, 1)

    @staticmethod
    def _log(rec: dict) -> dict:
        log.info(json.dumps(rec))
        return rec


__all__ = ["Trainer", "TrainerConfig", "flops_per_token"]
