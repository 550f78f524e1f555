"""Sequence-length buckets (a copy of ``hetu_tpu/data/bucket.py``): the
static-shape answer to ragged sequence lengths.

A captured train step holds one CUDA graph (and one memory pool) per
batch shape, as a jitted JAX step holds one executable per shape. So a
ragged loader is snapped onto a small ladder of bucket widths: each batch
is padded or sliced to the smallest bucket that holds its longest real
row, and a ragged epoch captures at most ``len(buckets)`` step graphs.
With telemetry on, every fit also counts into ``hetu_tpu``'s series
(``data_real_tokens_total``, ``data_padding_tokens_total``,
``data_raw_tokens_total``, ``data_truncated_tokens_total``,
``data_bucket_hits_total``); :attr:`ShapeBucketer.stats` keeps the same
accounting with telemetry off.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


class SeqLenBuckets:
    """Map raw lengths to a fixed set of bucket lengths."""

    def __init__(self, sizes: Sequence[int] | None = None, *,
                 min_len: int = 128, max_len: int = 8192,
                 multiple_of: int = 1):
        if sizes is None:
            sizes, s = [], min_len
            while s <= max_len:
                sizes.append(s)
                s *= 2
        sizes = sorted(set(int(s) for s in sizes))
        for s in sizes:
            if s % multiple_of != 0:
                raise ValueError(
                    f"bucket size {s} not a multiple of {multiple_of} "
                    f"(cp/block alignment)")
        self.sizes = sizes

    def bucket_for(self, length: int) -> int:
        for s in self.sizes:
            if length <= s:
                return s
        return self.sizes[-1]

    def group(self, lengths: Iterable[int]) -> dict[int, list[int]]:
        """indices grouped by bucket size."""
        out: dict[int, list[int]] = {}
        for i, L in enumerate(lengths):
            out.setdefault(self.bucket_for(L), []).append(i)
        return out


# -- the shape plane's batch-side half ---------------------------------------

#: segment id for pad tokens a ShapeBucketer appends. Any value works
#: (pad sits AFTER every real token in a row, so causal masking already
#: keeps it out of real outputs); a huge constant makes the intent
#: unmistakable in dumps and can never collide with a real segment.
PAD_SEGMENT = 2 ** 30 - 1


@dataclasses.dataclass
class BucketStats:
    """Token accounting across every batch a ShapeBucketer fitted."""

    batches: int = 0
    real_tokens: int = 0     # supervised/real tokens dispatched
    raw_tokens: int = 0      # rows x raw width (what pad-to-max feeds)
    bucket_tokens: int = 0   # rows x bucket width (what we actually feed)
    truncated_tokens: int = 0  # real tokens CUT because a row exceeded
    #                            the largest ladder bucket (warned once)

    @property
    def pad_fraction_before(self) -> float:
        """Pad waste of the batches AS GIVEN (the pad-to-max baseline)."""
        return 1.0 - self.real_tokens / self.raw_tokens \
            if self.raw_tokens else 0.0

    @property
    def pad_fraction_after(self) -> float:
        """Pad waste after snapping to the bucket ladder."""
        return 1.0 - self.real_tokens / self.bucket_tokens \
            if self.bucket_tokens else 0.0

    def to_record(self) -> dict:
        return {"kind": "shape_plane", "batches": self.batches,
                "real_tokens": self.real_tokens,
                "raw_tokens": self.raw_tokens,
                "bucket_tokens": self.bucket_tokens,
                "truncated_tokens": self.truncated_tokens,
                "pad_fraction_before": round(self.pad_fraction_before, 4),
                "pad_fraction_after": round(self.pad_fraction_after, 4)}


class ShapeBucketer:
    """Snap ragged host batches onto the bucket ladder.

    The trainer-side half of the shape plane: given a host batch whose
    sequence width reflects the raw loader padding, find the max REAL length across rows, snap it to the
    ladder, and slice/pad every seq-dim array to that bucket — so the
    captured train step sees at most ``len(buckets.sizes)`` distinct
    shapes per epoch (the re-trace audit's bound) while pad FLOPs drop
    from pad-to-max to pad-to-bucket.

    Real lengths come from ``labels != ignore_index`` when labels are
    present (the one signal that is unambiguous for LM batches — pad_id
    can be a real token id), else from ``input_ids != pad_id``.

    :attr:`stats` accumulates the token accounting of every fitted
    batch.
    """

    #: batch keys that carry a sequence dim (axis 1) and move together
    SEQ_KEYS = ("input_ids", "labels", "positions", "segment_ids")

    def __init__(self, buckets: SeqLenBuckets, *, pad_id: int = 0,
                 ignore_index: int = -100):
        self.buckets = buckets
        self.pad_id = pad_id
        self.ignore_index = ignore_index
        self.stats = BucketStats()
        self._warned_truncation = False

    @property
    def n_buckets(self) -> int:
        return len(self.buckets.sizes)

    def lengths(self, batch: dict) -> np.ndarray:
        """Per-row real lengths (int array of shape (rows,))."""
        labels = batch.get("labels")
        if labels is not None:
            valid = np.asarray(labels) != self.ignore_index
        else:
            valid = np.asarray(batch["input_ids"]) != self.pad_id
        # length = last real index + 1; all-pad rows are length 0
        rev = valid[:, ::-1]
        any_real = valid.any(axis=1)
        return np.where(any_real,
                        valid.shape[1] - rev.argmax(axis=1), 0)

    def bucket_for_batch(self, batch: dict) -> int:
        return self.buckets.bucket_for(
            max(1, int(self.lengths(batch).max(initial=0))))

    def fit(self, batch: dict) -> dict:
        """Return ``batch`` with every seq-dim array sliced/padded to
        the bucket of its max real length (other keys untouched)."""
        lens = self.lengths(batch)
        need = max(1, int(lens.max(initial=0)))
        L = self.buckets.bucket_for(need)
        rows, w = batch["input_ids"].shape[:2]
        if need > L:
            # bucket_for clamps to the ladder top: rows longer than the
            # largest bucket LOSE their tail tokens. That can be the
            # intended max-seq-len discipline, but it must never be
            # silent — warn once and count every cut token.
            cut = int(np.maximum(lens - L, 0).sum())
            self.stats.truncated_tokens += cut
            if not self._warned_truncation:
                self._warned_truncation = True
                import warnings
                warnings.warn(
                    f"batch has rows up to {need} real tokens but the "
                    f"largest seq bucket is {L} — truncating to {L} "
                    f"(this warning fires once; "
                    f"stats.truncated_tokens keeps counting). Add a "
                    f"larger bucket to train on the full sequences.",
                    stacklevel=2)
            from hetu_tpu_torch import telemetry
            if telemetry.enabled():
                telemetry.get_registry().counter(
                    "data_truncated_tokens_total",
                    "real tokens cut because a row exceeded the "
                    "largest seq-len bucket").inc(cut)
        out = dict(batch)
        if L != w:
            pad_vals = {"input_ids": self.pad_id,
                        "labels": self.ignore_index,
                        "positions": 0, "segment_ids": PAD_SEGMENT}
            for k in self.SEQ_KEYS:
                v = out.get(k)
                if v is None:
                    continue
                v = np.asarray(v)
                if L < w:
                    out[k] = v[:, :L]
                else:
                    padded = np.full(v.shape[:1] + (L,) + v.shape[2:],
                                     pad_vals[k], v.dtype)
                    padded[:, :w] = v
                    out[k] = padded
        real = int(np.minimum(lens, L).sum())
        self.stats.batches += 1
        self.stats.real_tokens += real
        self.stats.raw_tokens += rows * w
        self.stats.bucket_tokens += rows * L
        from hetu_tpu_torch import telemetry
        if telemetry.enabled():
            reg = telemetry.get_registry()
            reg.counter(
                "data_real_tokens_total",
                "real (non-pad) tokens dispatched to train steps").inc(
                real)
            reg.counter(
                "data_padding_tokens_total",
                "pad tokens dispatched after bucket snapping (the "
                "residual padding tax)").inc(rows * L - real)
            reg.counter(
                "data_raw_tokens_total",
                "tokens the raw loader batches carried before bucket "
                "snapping (the pad-to-max baseline)").inc(rows * w)
            reg.counter(
                "data_bucket_hits_total",
                "batches routed to each seq-len bucket").inc(
                bucket=str(L))
        return out


__all__ = ["BucketStats", "PAD_SEGMENT", "SeqLenBuckets", "ShapeBucketer"]
