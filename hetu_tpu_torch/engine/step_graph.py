"""A step body captured once as a CUDA graph and replayed: the port's
counterpart of a jitted JAX step (``hetu_tpu/serving/engine.py:527
_build_step``, ``hetu_tpu/engine/train_step.py`` ``jax.jit(step)``).

A body is a function over static operand buffers: it reads only those
buffers, the model's parameters and whatever state it updates in place
(the KV arena, the optimizer's moments), and returns its outputs. On
``cuda`` :class:`StepGraph` runs the body on a side stream (kernels load,
cuBLAS picks its algorithms, the allocator warms up), captures it with
``torch.cuda.graph`` into a memory pool (its own, or the ``pool`` its
owner shares among its graphs) and counts the capture with
:func:`record_trace`; from then on :meth:`StepGraph.replay` is the
only call, and one replay launches the whole step. On ``cpu`` (the tests)
the same object runs the body eagerly on the same static buffers and
copies the results into its static outputs, so the buffer plumbing a
replay reads on the card is the plumbing the CPU tests check.

A serving lane passes ``idle``: its warm-up runs write nothing that
matters and its operands are restored after them. A training step passes
no ``idle``: its warm-up is one real run, the step itself, whose writes
stand, and the capture after it executes nothing (``first`` holds that
run's outputs).

There is no fallback: a capture or replay error propagates, and nothing
turns the graphs off (JAX has no switch that skips ``jit`` either).

Several engines may serve from one process (a fleet's in-process
replicas, each stepping on a thread of its own). A serving lane captures
with ``capture_error_mode="global"``: another thread's device sync, pinned
allocation or blocking copy while it captures would fail the capture or
the other thread's step. :data:`DEVICE_GUARD` keeps them apart: a capture
holds it exclusively, and every engine iteration and every other engine
operation that touches the arena holds it shared, so a replica built
while its peers serve waits for their current iterations and they wait
for its capture, and nothing else serializes.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from hetu_tpu_torch.core.dtypes import current_policy
from hetu_tpu_torch.ops import _build

#: eager runs of a serving lane's body on a side stream before its capture
WARMUP_ITERS = 2

# -- capture accounting ------------------------------------------------------
# The port's counterpart of JAX's trace counter: a step body that runs as
# a captured CUDA graph is captured once and replayed after, so a counter
# bumped at each capture is an exact re-capture count, as JAX's is a
# re-trace count.
_TRACE_COUNTS: dict[str, int] = {}
_TRACE_LOCK = threading.Lock()
_TRACE_LOCAL = threading.local()


def record_trace(what: str) -> None:
    """Count one capture of the step body ``what``: ``serving_decode``,
    ``serving_prefill``, ``serving_draft_step``, ``train_step``,
    ``eval_step``, ``grad_step``, ``apply_step``. A replay never calls
    it. With telemetry on it also counts ``step_traces_total{what=}``,
    as ``hetu_tpu``'s re-trace counter does."""
    with _TRACE_LOCK:
        _TRACE_COUNTS[what] = _TRACE_COUNTS.get(what, 0) + 1
    _TRACE_LOCAL.total = getattr(_TRACE_LOCAL, "total", 0) + 1
    from hetu_tpu_torch import telemetry
    if telemetry.enabled():
        telemetry.get_registry().counter(
            "step_traces_total",
            "jit traces of step bodies (recompile detector)").inc(
                what=what)


def trace_counts() -> dict[str, int]:
    """``{step body: capture count}`` since process start (or the last
    :func:`reset_trace_counts`), across all threads."""
    with _TRACE_LOCK:
        return dict(_TRACE_COUNTS)


def trace_total() -> int:
    """Captures recorded on the calling thread: the trainer compares it
    around each step to book a step that captured as ``compile``, so a
    capture on another thread never counts against its compute."""
    return getattr(_TRACE_LOCAL, "total", 0)


def reset_trace_counts() -> None:
    with _TRACE_LOCK:
        _TRACE_COUNTS.clear()


class DeviceGuard:
    """A shared/exclusive lock between CUDA graph captures (exclusive) and
    the device work of engines on other threads (shared).

    Both sides are re-entrant on their own thread, and a thread that holds
    it shared may take it exclusively once it is the only holder (an
    engine iteration whose replay re-captures a lane under a new policy).
    A waiting capture blocks new shared holders of other threads, so a
    steady stream of iterations cannot starve it. Two threads that each
    hold it shared and both ask for it exclusively would wait on each
    other: a serving loop re-captures only when its policy changes, which
    its own loop never does."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared: dict[int, int] = {}        # thread id -> holds
        self._writer: Optional[int] = None
        self._depth = 0
        self._waiting = 0                        # captures waiting

    def acquire_shared(self, timeout: Optional[float] = None) -> bool:
        """Take it shared; False when ``timeout`` (seconds) ran out."""
        me = threading.get_ident()
        with self._cond:
            if self._writer == me or me in self._shared:
                self._shared[me] = self._shared.get(me, 0) + 1
                return True
            if not self._cond.wait_for(
                    lambda: self._writer is None and not self._waiting,
                    timeout):
                return False
            self._shared[me] = 1
            return True

    def release_shared(self) -> None:
        me = threading.get_ident()
        with self._cond:
            n = self._shared[me] - 1
            if n:
                self._shared[me] = n
            else:
                del self._shared[me]
                self._cond.notify_all()

    def acquire_exclusive(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._depth += 1
                return
            self._waiting += 1
            try:
                self._cond.wait_for(
                    lambda: self._writer is None
                    and all(t == me for t in self._shared))
            finally:
                self._waiting -= 1
            self._writer, self._depth = me, 1

    def release_exclusive(self) -> None:
        with self._cond:
            self._depth -= 1
            if not self._depth:
                self._writer = None
                self._cond.notify_all()

    @contextlib.contextmanager
    def shared(self):
        self.acquire_shared()
        try:
            yield
        finally:
            self.release_shared()

    @contextlib.contextmanager
    def exclusive(self):
        self.acquire_exclusive()
        try:
            yield
        finally:
            self.release_exclusive()


#: the process's guard between captures and engines' device work
DEVICE_GUARD = DeviceGuard()


class StepGraph:
    """One step: ``body()`` over the static ``operands``, captured once.

    - ``body`` returns a tuple of tensors; after a capture they are the
      step's static outputs (:attr:`outputs`), which every later replay
      overwrites: a caller that keeps a value across steps clones it;
    - ``idle`` (a serving lane) puts the operands in a state in which the
      body writes nothing that matters (every slot masked, every pack row
      invalid: the writes drop to row 0 of the null block). Warm-up and
      capture run under it, with the operands' values saved before and
      restored after, so a re-capture between two steps leaves them as
      they were. Without ``idle`` (a training step) the warm-up is one
      real run: its writes stand and :attr:`first` holds its outputs;
    - ``seeds`` (an ``ops.dropout.SeedTable``): the generators the body
      draws dropout masks from are registered with the graph, so each
      replay draws from the seeds staged before it, and the table is
      frozen while the capture runs.

    The graph freezes the precision policy (``core.autocast``) in force
    at its capture: :meth:`replay` under another policy re-captures
    first (a new ``record_trace``, as JAX re-traces) and never replays
    the stale graph. A graph replays the addresses it captured, so the
    model's parameters, the state and the operands must keep their
    storage for the life of the object: do not reallocate them (for
    example with ``model.to(...)``) after it is built.

    ``pool`` (a ``torch.cuda.graph_pool_handle()``) captures into a pool
    shared with other graphs that never replay concurrently: a training
    entry's signatures then cost about the largest of their pools, not
    the sum. A later capture into the pool may place its blocks over an
    earlier graph's scratch, so no tensor that outlives a replay may be
    allocated inside the capture: the body writes its results into
    buffers made before it (``CapturedStep`` makes them in the warm-up).

    ``launches`` is the capture's kernel tally (``_build.counting_into``);
    each replay adds it to the launch counters. A serving lane's warm-up
    runs are counted as they launch, and their tally is kept as
    ``warmup_launches``, so a caller that zeroed the counters before a
    lane was built can tell them from the replays. A capture holds
    :data:`DEVICE_GUARD` exclusively. ``capture_seconds`` and
    ``pool_bytes`` (the device memory reserved while capturing: the
    graph's pool, or what it added to a shared one) describe the last
    capture."""

    def __init__(self, name: str, body: Callable[[], Sequence[torch.Tensor]],
                 *, operands: Sequence[torch.Tensor] = (),
                 idle: Optional[Callable[[], None]] = None, device,
                 seeds=None, pool=None):
        self.name = name
        self.device = torch.device(device)
        self._body = body
        self._operands = tuple(operands)
        self._idle = idle
        self._seeds = seeds
        self._pool = pool
        self.graph = None
        self.outputs: tuple = ()
        self.first: tuple = ()
        self.launches: dict = {}
        self.warmup_launches: dict = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self._capture()

    def _capture(self) -> None:
        with DEVICE_GUARD.exclusive():
            self._capture_guarded()

    def _capture_guarded(self) -> None:
        t0 = time.perf_counter()
        # drop the last capture (its pool) before taking the next one
        self.graph, self.outputs = None, ()
        self.policy = current_policy()
        live = self._idle is None
        saved = [] if live else [t.clone() for t in self._operands]
        if not live:
            self._idle()
        with torch.no_grad():
            if self.device.type == "cuda":
                self._capture_cuda(live)
            else:
                self.outputs = tuple(self._body())
                self.first = self.outputs
        for t, s in zip(self._operands, saved):
            t.copy_(s)
        self.captures += 1
        record_trace(self.name)
        self.capture_seconds = time.perf_counter() - t0

    def _capture_cuda(self, live: bool) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        warm: dict = {}
        with torch.cuda.stream(side), (contextlib.nullcontext() if live
                                       else _build.counting_into(warm)):
            for _ in range(1 if live else WARMUP_ITERS):
                first = tuple(self._body())
        _build.add_launches(warm)
        self.warmup_launches = warm
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        if self._seeds is not None:
            for g in self._seeds.generators():
                graph.register_generator_state(g)
            self._seeds.frozen = True
        tally: dict = {}
        # a training step captures while a prefetcher thread may pin host
        # memory: only this thread's calls are checked
        mode = "thread_local" if live else "global"
        with _build.counting_into(tally), \
                torch.cuda.graph(graph, pool=self._pool,
                                 capture_error_mode=mode):
            outputs = tuple(self._body())
        if self._seeds is not None:
            self._seeds.frozen = False
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.outputs, self.launches = graph, outputs, tally
        self.first = first if live else ()

    def replay(self) -> tuple:
        """Run the step on the operands' current values; returns the
        static outputs. A re-capture of a training step (under a new
        policy) runs the step itself and returns that run's outputs."""
        if current_policy() != self.policy:
            self._capture()
            if self._idle is None:
                return self.first
        if self.graph is not None:
            self.graph.replay()
            _build.add_launches(self.launches)
        else:
            with torch.no_grad():
                for out, new in zip(self.outputs, self._body()):
                    out.copy_(new)
        return self.outputs

    def run_eager(self) -> tuple:
        """The body, run eagerly into fresh tensors (no graph): the
        reference a replay is held to, bit for bit."""
        with torch.no_grad():
            return tuple(self._body())


__all__ = ["DEVICE_GUARD", "DeviceGuard", "StepGraph", "WARMUP_ITERS",
           "record_trace", "reset_trace_counts", "trace_counts",
           "trace_total"]
