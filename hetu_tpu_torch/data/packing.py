"""Sequence packing with segment ids and reset positions (a copy of
``hetu_tpu/data/packing.py:24-90,134``).

Variable-length documents are packed into fixed rows; each token carries
its document's ``segment_ids`` (what the flash kernels mask on) and its
``positions`` restarted at each document (what RoPE reads).

Loss alignment: ``labels[i] = tokens[i+1]`` *within* a segment; the last
token of each segment and all padding get ``ignore_index`` so packed loss
equals the sum of per-sequence losses.

Context parallelism (``cp > 1``, the zigzag layout) is the port's fourth
slice: it raises here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class PackedBatch:
    """Arrays shaped (rows, seq_len); feed directly as a model batch."""

    input_ids: np.ndarray
    labels: np.ndarray
    positions: np.ndarray
    segment_ids: np.ndarray

    def as_batch(self) -> dict:
        return {"input_ids": self.input_ids, "labels": self.labels,
                "positions": self.positions,
                "segment_ids": self.segment_ids}


def check_cp(cp: int) -> None:
    """The port packs for one device: ``cp > 1`` raises."""
    if cp != 1:
        raise NotImplementedError(
            f"slice 4: context parallelism (cp={cp}) and its zigzag "
            f"layout are not ported")


def pack_sequences(seqs: Sequence[np.ndarray], seq_len: int, *,
                   pad_id: int = 0, ignore_index: int = -100,
                   cp: int = 1, cp_layout: str = "contiguous") -> PackedBatch:
    """Greedy first-fit packing of token sequences into rows of
    ``seq_len``. ``cp``/``cp_layout`` are taken for the JAX signature;
    ``cp > 1`` raises (:func:`check_cp`).

    Sequences longer than ``seq_len`` are truncated. Each packed segment
    gets a distinct id; padding uses a trailing id with all-ignored labels.
    """
    del cp_layout                 # with cp = 1 every layout is contiguous
    check_cp(cp)
    rows: list[list[np.ndarray]] = []
    space: list[int] = []
    for seq in seqs:
        seq = np.asarray(seq)[:seq_len]
        placed = False
        for i, free in enumerate(space):
            if len(seq) <= free:
                rows[i].append(seq)
                space[i] -= len(seq)
                placed = True
                break
        if not placed:
            rows.append([seq])
            space.append(seq_len - len(seq))

    n = len(rows)
    input_ids = np.full((n, seq_len), pad_id, np.int32)
    labels = np.full((n, seq_len), ignore_index, np.int32)
    positions = np.zeros((n, seq_len), np.int32)
    segment_ids = np.zeros((n, seq_len), np.int32)
    for r, segs in enumerate(rows):
        off = 0
        for s_id, seq in enumerate(segs):
            L = len(seq)
            input_ids[r, off:off + L] = seq
            labels[r, off:off + L - 1] = seq[1:]
            positions[r, off:off + L] = np.arange(L)
            segment_ids[r, off:off + L] = s_id
            off += L
        # padding tail: its own segment id, positions 0, labels ignored
        segment_ids[r, off:] = len(segs)
    return PackedBatch(input_ids, labels, positions, segment_ids)


def pad_batch(seqs: Sequence[np.ndarray], seq_len: int, *,
              pad_id: int = 0, ignore_index: int = -100) -> PackedBatch:
    """One sequence per row (the reference's pad mode)."""
    n = len(seqs)
    input_ids = np.full((n, seq_len), pad_id, np.int32)
    labels = np.full((n, seq_len), ignore_index, np.int32)
    positions = np.zeros((n, seq_len), np.int32)
    segment_ids = np.ones((n, seq_len), np.int32)  # 1 = padding
    for r, seq in enumerate(seqs):
        seq = np.asarray(seq)[:seq_len]
        L = len(seq)
        if L == 0:
            continue
        input_ids[r, :L] = seq
        labels[r, :L - 1] = seq[1:]
        positions[r, :L] = np.arange(L)
        segment_ids[r, :L] = 0
    return PackedBatch(input_ids, labels, positions, segment_ids)
