"""One lane of the serving step, captured once as a CUDA graph and
replayed (counterpart of ``hetu_tpu/serving/engine.py:527 _build_step``,
the step JAX compiles once).

A lane is a body function over static operand buffers: it reads only
those buffers, the model's parameters and the KV arena, and returns its
outputs. On ``cuda`` :class:`StepGraph` runs the body a few times on a
side stream (kernels load, cuBLAS picks its algorithms, the allocator
warms up), captures it with ``torch.cuda.graph`` into a memory pool of
its own and counts the capture with ``engine.record_trace``; from then
on :meth:`StepGraph.replay` is the only call, and one replay launches
the whole lane. On ``cpu`` (the tests) the same object runs the body
eagerly on the same static buffers and copies the results into its
static outputs, so the buffer plumbing a replay reads on the card is
the plumbing the CPU tests check.

There is no fallback: a capture or replay error propagates, and nothing
turns the graphs off (the JAX engine has no switch that skips ``jit``
either).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Sequence

import torch

from hetu_tpu_torch.core.dtypes import current_policy
from hetu_tpu_torch.engine.train_step import record_trace
from hetu_tpu_torch.ops import _build

#: eager runs of the body on a side stream before its capture
WARMUP_ITERS = 2


class StepGraph:
    """One lane: ``body()`` over the static ``operands``, captured once.

    - ``body`` returns a tuple of tensors; after a capture they are the
      lane's static outputs (:attr:`outputs`), which every later replay
      overwrites: a caller that keeps a value across steps clones it;
    - ``idle`` puts the operands in a state in which the body writes
      nothing to the arena (every slot masked, every pack row invalid:
      the writes drop to row 0 of the null block). Warm-up and capture
      run under it, with the operands' values saved before and restored
      after, so a re-capture between two steps leaves them as they were.

    The graph freezes the precision policy (``core.autocast``) in force
    at its capture: :meth:`replay` under another policy re-captures
    first (a new ``record_trace``, as JAX re-traces) and never replays
    the stale graph. A graph replays the addresses it captured, so the
    model's parameters, the arena and the operands must keep their
    storage for the life of the object: do not reallocate them (for
    example with ``model.to(...)``) after the engine is built.

    ``launches`` is the capture's kernel tally (``_build.counting_into``);
    each replay adds it to the launch counters. ``capture_seconds`` and
    ``pool_bytes`` (the device memory reserved while capturing: the
    graph's pool) describe the last capture."""

    def __init__(self, name: str, body: Callable[[], Sequence[torch.Tensor]],
                 *, operands: Sequence[torch.Tensor],
                 idle: Callable[[], None], device):
        self.name = name
        self.device = torch.device(device)
        self._body = body
        self._operands = tuple(operands)
        self._idle = idle
        self.graph = None
        self.outputs: tuple = ()
        self.launches: dict = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self._capture()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        # drop the last capture (its pool) before taking the next one
        self.graph, self.outputs = None, ()
        self.policy = current_policy()
        saved = [t.clone() for t in self._operands]
        self._idle()
        with torch.no_grad():
            if self.device.type == "cuda":
                self._capture_cuda()
            else:
                self.outputs = tuple(self._body())
        for t, s in zip(self._operands, saved):
            t.copy_(s)
        self.captures += 1
        record_trace(self.name)
        self.capture_seconds = time.perf_counter() - t0

    def _capture_cuda(self) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_ITERS):
                self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        tally: dict = {}
        with _build.counting_into(tally), torch.cuda.graph(graph):
            outputs = tuple(self._body())
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.outputs, self.launches = graph, outputs, tally

    def replay(self) -> tuple:
        """Run the lane on the operands' current values; returns the
        static outputs."""
        if current_policy() != self.policy:
            self._capture()
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


__all__ = ["StepGraph", "WARMUP_ITERS"]
