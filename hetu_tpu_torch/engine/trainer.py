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
The graphs of every entry a trainer builds (each bucket's step and
eval) share one pool; :meth:`Trainer.close` releases them, as does
dropping the trainer.

With ``TrainerConfig(seq_buckets=...)`` each host batch is snapped, on
the host and before the prefetcher stages it, to the smallest bucket
that holds its longest real row (``data.bucket.ShapeBucketer``), and
runs through that bucket's entry: a ragged epoch captures at most one
step graph per bucket.

Checkpoints (``save``, ``resume``, the ``ckpt_every`` cadence and the
final save of ``train``; ``utils/checkpoint.py``) are in ``hetu_tpu``'s
format, so a run of either package resumes from the other's.

Telemetry is ``hetu_tpu``'s (``docs/OBSERVABILITY.md``), all of it on the
host: ``TrainerConfig(telemetry=True)`` turns the global switch on;
``train`` keeps a goodput ledger (:class:`~hetu_tpu_torch.telemetry.
GoodputAccountant`: compute, compile, stall, eval, checkpoint, with
``{category}_seconds_total`` counters), flight records (``compile``,
``step``, ``checkpoint``, ``train_error``), the hang watchdog
(``watchdog=True``), the SLO observations on the log cadence
(``slo=True``), spans around eval and save, the per-bucket
``data_bucket_compiles_total``, the cluster aggregate
(``aggregate_every``), an MoE model's expert-plane stats (drained at the
log boundary) and, with ``trace_dir``, ``trace.json`` and
``telemetry.jsonl`` (:meth:`Trainer.export_telemetry`). JAX books a step
that re-traced as ``compile``; the port books a step during which a
graph was captured on its thread (``engine.step_graph.trace_total()``
grew). The log
boundary stays the only device read.

Not ported: distributed and delta checkpoints, AOT precompilation and
the persistent compile cache, hot switching (``set_strategy``,
``shrink_to``/``grow_to``), ``train_dynamic`` — ``TrainerConfig`` has no
field for any of them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import weakref
from typing import Callable, Iterable, Optional

from torch import nn

from hetu_tpu_torch import resolve_device, telemetry
from hetu_tpu_torch.core.dtypes import BF16_COMPUTE, FP32, Policy, autocast
from hetu_tpu_torch.data.bucket import SeqLenBuckets, ShapeBucketer
from hetu_tpu_torch.data.prefetch import DevicePrefetcher, to_tensors
from hetu_tpu_torch.engine.state import TrainState
from hetu_tpu_torch.engine.step_graph import trace_total
from hetu_tpu_torch.engine.train_step import (
    CachedStep, GraphPool, StepCache, compile_strategy, get_step_cache, init_state,
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
    telemetry: bool = False
    trace_dir: Optional[str] = None
    watchdog: bool = False
    watchdog_factor: float = 8.0
    watchdog_min_timeout_s: float = 30.0
    slo: bool = False
    aggregate_every: int = 0

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


class _JsonlSink:
    """The trainer's ``telemetry.jsonl``: one JSON record a line, appended
    (``hetu_tpu``'s ``MetricsLogger`` stream; None path: nowhere)."""

    def __init__(self, path: Optional[str]):
        self._f = open(path, "a") if path else None

    def write_record(self, rec: dict) -> dict:
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def _release_entries(cache: StepCache, built: dict) -> None:
    """Drop the entries a trainer built from ``cache`` and release their
    graphs (what :meth:`Trainer.close` and the trainer's collection do)."""
    for key, entry in list(built.items()):
        cache.discard(key)
        entry.release()
    built.clear()


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
        if self.config.telemetry:
            telemetry.enable(True)
        self.tracer = telemetry.get_tracer()
        self.registry = telemetry.get_registry()
        # the flight recorder is always on; the watchdog and the goodput
        # ledger belong to each train() run
        self.flight = telemetry.get_flight_recorder()
        self.slo: Optional[telemetry.SLOEngine] = None
        if self.config.slo:
            self.slo = telemetry.default_training_rules(
                telemetry.SLOEngine(self.registry))
        self.goodput: Optional[telemetry.GoodputAccountant] = None
        self._spans_exported = 0
        self._spans_epoch = self.tracer.epoch
        path = None
        if self.config.trace_dir:
            os.makedirs(self.config.trace_dir, exist_ok=True)
            path = os.path.join(self.config.trace_dir, "telemetry.jsonl")
        self.metrics = _JsonlSink(path)
        self._t_created = time.perf_counter()
        self.cache = step_cache if step_cache is not None \
            else get_step_cache()
        # kept as an alias, as JAX's trainer keeps it
        self._plan_cache = self.cache
        self.bucketer = None
        if self.config.seq_buckets:
            self.bucketer = ShapeBucketer(
                SeqLenBuckets(sizes=self.config.seq_buckets))
        self._bucket_entries: dict = {}
        # every entry this trainer obtained (by cache key): released by
        # close() or when the trainer is collected; the graphs of all of
        # them (each bucket's step and eval) share one pool
        self._built: dict = {}
        self._pool = GraphPool()
        self._finalizer = weakref.finalize(self, _release_entries,
                                           self.cache, self._built)
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
        anew); the build is a ``compile`` span, ledger entry and flight
        record, as JAX's is."""
        strategy = self.strategy

        def build() -> CachedStep:
            t0 = time.perf_counter()
            with telemetry.span("compile", bucket=bucket,
                                strategy=strategy.to_json()), \
                    autocast(self.config.policy()):
                entry = compile_strategy(
                    self.model, self.opt, strategy, device=self.device,
                    expert_steps=max(1, self.config.log_every),
                    pool=self._pool)
            dt = time.perf_counter() - t0
            self._note("compile", dt)
            self.flight.record("compile", bucket=bucket,
                               seconds=round(dt, 3))
            return entry

        if not self.config.step_cache:
            entry = build()
            self._built[("uncached", bucket, id(entry))] = entry
            self._own_plane(entry)
            return entry
        key = self._cache_key(strategy, bucket)
        first_build = self.cache.lookup(key) is None
        entry = self.cache.get_or_build(key, build)
        self._built[key] = entry
        self._own_plane(entry)
        if bucket and first_build and telemetry.enabled():
            self.registry.counter(
                "data_bucket_compiles_total",
                "step entries built per seq-len bucket (the re-trace "
                "audit's per-bucket view)").inc(bucket=str(bucket))
        return entry

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

    def _note(self, category: str, seconds: float) -> None:
        """Goodput ledger and cumulative counter for an overhead event."""
        if self.goodput is not None:
            self.goodput.record(category, seconds)
        if telemetry.enabled():
            self.registry.counter(
                f"{category}_seconds_total",
                f"cumulative {category} time").inc(seconds)

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
        the write goes on after it, on a thread (``:462-501``). The time
        it held the caller is a ``checkpoint`` span, ledger entry and
        flight record. Returns the path."""
        path = path or self.config.ckpt_dir
        if path is None:
            raise ValueError("no checkpoint path configured")
        if self.state is None:
            raise ValueError("no train state to save: initialize, resume "
                             "or train first")
        t0 = time.perf_counter()
        with telemetry.span("checkpoint", path=path, wait=wait):
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait()
            self._ckpt_writer = save_checkpoint(
                path, self.state,
                async_save=self.config.async_ckpt and not wait)
        dt = time.perf_counter() - t0
        self._note("checkpoint", dt)
        self.flight.record("checkpoint", path=path, blocked_s=round(dt, 3))
        self._saved_step = self.state.step
        self.last_save = {"path": path, "step": self.state.step,
                          "blocked_s": dt, "writer": self._ckpt_writer}
        return path

    def _wait_writer(self) -> None:
        """Wait for the write in flight, if any."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
            self._ckpt_writer = None

    def close(self) -> None:
        """Release the trainer's resources (idempotent): wait for the
        write in flight, drop from the step cache every entry this
        trainer built and release their graphs and pools (the next step
        captures again), and close ``telemetry.jsonl``."""
        self._wait_writer()
        _release_entries(self.cache, self._built)
        self.metrics.close()

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

    def _own_plane(self, entry: CachedStep) -> None:
        """A full expert-plane ring of ``entry`` (fewer ring steps than
        steps between two drains) drains every plane of this trainer,
        oldest first, so the gauge still ends on the last step."""
        plane = getattr(entry.step_fn, "plane", None)
        if plane is not None:
            plane.on_full = weakref.WeakMethod(self._drain_planes)

    def _drain_planes(self) -> None:
        """Observe the expert-plane stats the MoE steps wrote since the
        last drain (a device read: only where the host already syncs)."""
        planes = [p for p in (getattr(e.step_fn, "plane", None)
                              for e in self._built.values())
                  if p is not None]
        for plane in sorted(planes, key=lambda p: p.last_staged):
            plane.drain()

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
        ``mfu`` with ``config.peak_flops`` (and, with telemetry on, the
        registry's snapshot under ``telemetry``). ``eval_batches`` is a
        callable returning an iterable of held-out batches: every
        ``eval_every`` steps the mean validation loss (dropout off) is
        logged as ``eval_loss``. With ``config.ckpt_dir`` set, every
        ``ckpt_every`` steps a save, and at the end one whose write is
        waited for (``:690-700``); where the cadence has just saved the
        last step, its write is waited for instead of a second save of
        the same state.

        The run's goodput ledger is ``self.goodput``; with telemetry on,
        the artifacts are exported when the run ends (after a failure
        too, best-effort, as JAX's are)."""
        if self.state is None:
            self.initialize()
        steps = steps if steps is not None else self.config.total_steps
        history = []
        tel = telemetry.enabled()
        acct = telemetry.GoodputAccountant(peak_flops=self.config.peak_flops)
        self.goodput = acct
        host_step = self.state.step
        t0 = t_last = time.perf_counter()
        tokens_since = tokens_total = 0
        flops_since = flops_sum = 0.0
        fpt_by_width: dict = {}
        slo_blocked_s = 0.0      # eval and save time inside the interval
        watchdog = None
        if self.config.watchdog:
            watchdog = telemetry.HangWatchdog(
                name="train", factor=self.config.watchdog_factor,
                min_timeout_s=self.config.watchdog_min_timeout_s,
                dump_dir=self.config.trace_dir or ".",
                registry=self.registry).start()
        if self.bucketer is not None:
            # snap every host batch to its bucket before the prefetcher
            # stages it: each entry sees exactly one shape
            batches = (self.bucketer.fit(b) for b in batches)
        it = self._batches(batches, steps)
        failed: Optional[str] = None
        try:
            for _ in range(steps):
                t_iter = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t_fetch = time.perf_counter()
                acct.record("stall", t_fetch - t_iter)
                n_traces = trace_total()
                self.state, metrics = self._step_entry_for(batch)(
                    self.state, batch)
                host_step += 1
                acct.add_step()
                self.flight.record("step", step=host_step)
                if watchdog is not None:
                    watchdog.beat()
                ids = batch["input_ids"]
                width = int(ids.shape[-1])
                if width not in fpt_by_width:
                    fpt_by_width[width] = flops_per_token(self.model, width)
                ntok = int(ids.numel())
                tokens_since += ntok
                tokens_total += ntok
                acct.add_tokens(ntok)
                fpt = fpt_by_width[width] or 0.0
                flops_since += fpt * ntok
                if fpt:
                    flops_sum += fpt * ntok
                    acct.flops_per_token = flops_sum / tokens_total
                if self.config.log_every \
                        and host_step % self.config.log_every == 0:
                    loss = float(metrics["loss"])
                    grad_norm = float(metrics["grad_norm"])
                    self._drain_planes()
                    now = time.perf_counter()
                    rec = {"kind": "metrics", "step": host_step,
                           "loss": loss, "grad_norm": grad_norm,
                           "elapsed_s": now - t0,
                           "tokens_per_sec": tokens_since / (now - t_last),
                           "tokens_total": tokens_total}
                    if self.config.peak_flops:
                        rec["mfu"] = flops_since / (now - t_last) \
                            / self.config.peak_flops
                    history.append(self._log(rec))
                    if self.slo is not None:
                        # one observation an interval; eval and save
                        # time is accounted overhead, not a regression
                        self.slo.observe("loss", loss)
                        self.slo.observe("grad_norm", grad_norm)
                        self.slo.observe(
                            "step_time_s",
                            max(now - t_last - slo_blocked_s, 0.0)
                            / self.config.log_every)
                        slo_blocked_s = 0.0
                        for a in self.slo.evaluate():
                            log.warning(f"SLO alert: {a.message}")
                            self.metrics.write_record(a.to_record())
                    t_last, tokens_since, flops_since = now, 0, 0.0
                    if tel:
                        self.tracer.record_counters(
                            self.registry.snapshot())
                # a step during which a graph was captured is compile
                # time (JAX books a re-traced step so), the rest compute
                step_s = time.perf_counter() - t_fetch
                if trace_total() > n_traces:
                    acct.record("compile", step_s)
                    if tel:
                        self.tracer.complete("compile", step_s,
                                             where="step_trace")
                else:
                    acct.record("compute", step_s)
                if self.config.eval_every and eval_batches is not None \
                        and host_step % self.config.eval_every == 0:
                    if watchdog is not None:
                        watchdog.pause()
                    t_ev = time.perf_counter()
                    with telemetry.span("eval", step=host_step):
                        ev = self.evaluate(eval_batches())
                    ev_s = time.perf_counter() - t_ev
                    acct.record("eval", ev_s)
                    slo_blocked_s += ev_s
                    history.append(self._log({
                        "kind": "metrics", "step": host_step,
                        "eval_loss": ev}))
                    if watchdog is not None:
                        watchdog.resume()
                if self.config.aggregate_every and telemetry.enabled() \
                        and host_step % self.config.aggregate_every == 0:
                    self._aggregate_cluster(host_step)
                if self.config.ckpt_every and self.config.ckpt_dir \
                        and host_step % self.config.ckpt_every == 0:
                    if watchdog is not None:
                        watchdog.pause()
                    t_ck = time.perf_counter()
                    self.save()
                    slo_blocked_s += time.perf_counter() - t_ck
                    if watchdog is not None:
                        watchdog.resume()
            if self.config.ckpt_dir:
                if watchdog is not None:
                    watchdog.pause()
                if self._saved_step == self.state.step:
                    self._wait_writer()
                else:
                    self.save(wait=True)
        except BaseException as e:
            failed = type(e).__name__
            raise
        finally:
            if watchdog is not None:
                watchdog.stop()
            if isinstance(it, DevicePrefetcher):
                it.close()
            acct.freeze()
            if failed is not None:
                # a crashed run is when the operator needs the artifacts:
                # best-effort, so an export problem never masks the error
                try:
                    self.flight.record("train_error", error=failed)
                    self.flight.dump(
                        self.flight.default_path(self.config.trace_dir),
                        reason="train_error", stacks=True)
                    if tel:
                        self.export_telemetry()
                except Exception as err:
                    log.warning(f"telemetry export failed: {err}")
        if tel:
            self._drain_planes()
            self.export_telemetry()
        return history

    def evaluate(self, batches: Iterable[dict]) -> float:
        """Mean loss over ``batches`` under the plan's policy, without
        dropout."""
        total, n = 0.0, 0
        for batch in batches:
            total += float(self._eval_fn(to_tensors(batch)))
            if self._eval_fn.plane is not None:
                self._eval_fn.plane.drain()
            n += 1
        return total / max(n, 1)

    # -- telemetry ------------------------------------------------------------
    def _aggregate_cluster(self, step: int) -> dict:
        """One aggregation round on the ``aggregate_every`` cadence
        (``hetu_tpu/engine/trainer.py:737``) for the one process the port
        trains in: the registry snapshot reduced locally (the record JAX
        writes with ``ranks=1``), a ``cluster_aggregate`` record in
        ``telemetry.jsonl``; its time is ``telemetry`` overhead. A
        multi-process run goes through ``telemetry.cluster_aggregate``
        with the multi-GPU slice."""
        t0 = time.perf_counter()
        with telemetry.span("cluster_aggregate", step=step):
            agg = telemetry.aggregate_snapshots([self.registry.snapshot()])
        self._note("telemetry", time.perf_counter() - t0)
        self.metrics.write_record({"kind": "cluster_aggregate",
                                   "step": step, "ranks": 1,
                                   "metrics": agg})
        return agg

    def export_telemetry(self) -> Optional[dict]:
        """Flush the last run's artifacts to ``config.trace_dir``
        (``hetu_tpu/engine/trainer.py:852``): rewrite ``trace.json`` (all
        spans so far) and append the new span records, the goodput
        report, the measured step time and the registry snapshot to
        ``telemetry.jsonl``. Returns the goodput record (also without a
        trace_dir)."""
        rec = None
        if self.goodput is not None:
            rec = self.goodput.report().to_record()
        if not self.config.trace_dir or not telemetry.enabled():
            return rec
        self.tracer.export_chrome(
            os.path.join(self.config.trace_dir, "trace.json"))
        if self._spans_epoch != self.tracer.epoch:   # reset() since last
            self._spans_exported = 0
            self._spans_epoch = self.tracer.epoch
        events = self.tracer.events()
        for ev in events[self._spans_exported:]:
            self.metrics.write_record(ev.to_record())
        self._spans_exported = len(events)
        if rec is not None:
            self.metrics.write_record(rec)
            comp, steps = rec["components"].get("compute", 0.0), \
                rec.get("steps", 0)
            if comp > 0 and steps:
                self.metrics.write_record({
                    "kind": "measured_step",
                    "strategy": self.strategy.to_json(),
                    "step_time_s": comp / steps, "steps": steps})
        snap = self.registry.to_record()
        if snap["metrics"]:
            self.metrics.write_record(snap)
        return rec

    def _log(self, rec: dict) -> dict:
        """A log record: with telemetry on it carries the registry's
        snapshot (JAX's ``MetricsLogger``), and goes to
        ``telemetry.jsonl``."""
        if self.registry.enabled:
            snap = self.registry.snapshot()
            if snap:
                rec["telemetry"] = snap
        log.info(json.dumps(rec))
        return self.metrics.write_record(rec)


__all__ = ["Trainer", "TrainerConfig", "flops_per_token"]
