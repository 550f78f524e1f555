"""Device prefetcher (counterpart of ``hetu_tpu/data/prefetch.py:100``):
overlap host batch preparation and the host-to-device copy with the
previous step's compute.

On a CUDA device a producer thread pulls numpy batches from the host
iterator, stages each array in pinned host memory and copies it to the
card with ``non_blocking=True`` on a side stream, then records an event
there. A bounded queue holds at most ``buffer_size`` staged batches. The
consumer makes its own stream wait for the batch's event before it
returns the tensors, so a step never reads a half-copied batch and the
copy rides under the step before it. On the CPU there is nothing to
overlap: each batch is converted where it is fetched, in the caller's
thread.

``max_items`` caps how many batches are pulled from the host iterator,
checked before each pull, so a shared iterator loses nothing to an
eager read past the consumer's step budget. Producer exceptions surface
at ``__next__``. With telemetry on, every fetch counts into
``hetu_tpu``'s series (``prefetch_batches_total``, ``prefetch_ready_total``,
``data_stall_seconds``, ``data_queue_depth``, and a ``stall`` span past
1 ms of waiting); on the CPU a fetch converts in place, so it is never
ready ahead and never waits. The JAX prefetcher's hot-switch
re-placement is not ported.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator, List, Optional

import numpy as np
import torch

from hetu_tpu_torch import telemetry

_SENTINEL = object()
#: a consumer wait longer than this is also recorded as a ``stall`` span
_STALL_SPAN_THRESHOLD_S = 1e-3


def to_tensors(batch: dict, device=None) -> dict:
    """``{name: array}`` → ``{name: tensor}`` (on ``device`` if given);
    tensors pass through, ``None`` values are dropped."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        out[k] = t if device is None else t.to(device)
    return out


class _Shared:
    """Producer/consumer state that holds no reference to the
    prefetcher, so an abandoned one can be collected and stop its
    thread."""

    __slots__ = ("q", "stop", "errors")

    def __init__(self, q):
        self.q = q
        self.stop = threading.Event()
        self.errors: List[BaseException] = []


def _stage(batch: dict, device: torch.device, stream) -> tuple:
    """Pinned host copies of ``batch``, sent to ``device`` on ``stream``;
    returns the device batch and the event that marks the copy's end."""
    with torch.cuda.stream(stream):
        out = {k: t.pin_memory().to(device, non_blocking=True)
               for k, t in to_tensors(batch).items()}
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def _producer(shared: _Shared, it: Iterator[Any], device: torch.device,
              max_items: Optional[int]) -> None:
    q, stop = shared.q, shared.stop

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        torch.cuda.set_device(device)
        stream = torch.cuda.Stream(device=device)
        n = 0
        while not stop.is_set() and (max_items is None or n < max_items):
            try:
                batch = next(it)
            except StopIteration:
                break
            if not put(_stage(batch, device, stream)):
                return
            n += 1
    except BaseException as e:   # surfaces at the consumer's __next__
        shared.errors.append(e)
    finally:
        put(_SENTINEL)


class DevicePrefetcher:
    """Wrap an iterable of host batches (dicts of numpy arrays or CPU
    tensors); yields dicts of tensors on ``device``. Usable as a context
    manager; ``close`` stops the producer and drops staged batches."""

    def __init__(self, batches: Iterable[dict], device, *,
                 buffer_size: int = 2, max_items: Optional[int] = None):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        self.device = torch.device(device)
        self._it = iter(batches)
        self._max_items = max_items
        self._pulled = 0              # CPU pass-through: batches pulled
        self._done = False
        self._shared = None
        self._thread = None
        if self.device.type == "cuda":
            self._shared = _Shared(queue.Queue(maxsize=buffer_size))
            self._thread = threading.Thread(
                target=_producer, daemon=True,
                args=(self._shared, self._it, self.device, max_items))
            self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._done:
            raise StopIteration
        if self._shared is None:
            if self._max_items is not None \
                    and self._pulled >= self._max_items:
                self._done = True
                raise StopIteration
            try:
                batch = next(self._it)
            except StopIteration:
                self._done = True
                raise
            self._pulled += 1
            self._count(False, 0.0)
            return to_tensors(batch, self.device)
        q = self._shared.q
        try:
            item, ready, wait = q.get_nowait(), True, 0.0
        except queue.Empty:
            # the consumer waiting here is the data stall
            t0 = time.perf_counter()
            item = q.get()
            ready, wait = False, time.perf_counter() - t0
        if item is _SENTINEL:
            self._done = True
            if self._shared.errors:
                raise self._shared.errors.pop()
            raise StopIteration
        self._count(ready, wait)
        batch, done = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in batch.values():
            # made on the side stream, used on this one: the allocator
            # must not hand the memory back before this stream is done
            t.record_stream(stream)
        return batch

    def _count(self, ready: bool, wait: float) -> None:
        if not telemetry.enabled():
            return
        reg = telemetry.get_registry()
        reg.counter("prefetch_batches_total",
                    "batches served by the device prefetcher").inc()
        if ready:
            reg.counter("prefetch_ready_total",
                        "fetches that found the batch already "
                        "staged (H2D overlapped compute)").inc()
        reg.counter("data_stall_seconds",
                    "train loop blocked waiting for batches").inc(wait)
        reg.gauge("data_queue_depth",
                  "staged batches after this fetch").set(
                      self._shared.q.qsize() if self._shared else 0)
        if wait > _STALL_SPAN_THRESHOLD_S:
            telemetry.get_tracer().complete("stall", wait,
                                            where="prefetch")

    def close(self) -> None:
        self._done = True
        if self._shared is None:
            return
        self._shared.stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=0.3)
        try:
            while True:
                self._shared.q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
