"""Batch samplers and the data-loader pipeline (a copy of
``hetu_tpu/data/loader.py``): ``build_data_loader`` with sample-level
and token-level batch samplers, packing or padding each batch. The same
seed gives the same batches as ``hetu_tpu``'s; ``cp > 1`` raises."""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from hetu_tpu_torch.data.packing import check_cp, pack_sequences, \
    pad_batch


def sample_batches(n_items: int, batch_size: int, *, shuffle: bool = True,
                   drop_last: bool = True, seed: int = 0
                   ) -> Iterator[list[int]]:
    """Index batches of a fixed number of samples."""
    idx = np.arange(n_items)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for i in range(0, n_items, batch_size):
        b = idx[i:i + batch_size].tolist()
        if drop_last and len(b) < batch_size:
            break
        yield b


def token_batches(lengths: Sequence[int], max_tokens: int, *,
                  shuffle: bool = True, seed: int = 0
                  ) -> Iterator[list[int]]:
    """Index batches bounded by a token budget (reference token-level
    sampler, ``dataloader.py:244``)."""
    idx = np.arange(len(lengths))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    batch: list[int] = []
    total = 0
    for i in idx:
        L = int(lengths[int(i)])
        if batch and total + L > max_tokens:
            yield batch
            batch, total = [], 0
        batch.append(int(i))
        total += L
    if batch:
        yield batch


def build_data_loader(dataset, *, seq_len: int, batch_rows: int,
                      pack: bool = True, pad_id: int = 0, cp: int = 1,
                      cp_layout: str = "zigzag",
                      max_tokens: Optional[int] = None,
                      shuffle: bool = True, drop_last: bool = True,
                      seed: int = 0) -> Iterator[dict]:
    """Yield model-ready batches of exactly ``batch_rows`` rows ×
    ``seq_len`` tokens (static shapes).

    ``pack=True`` packs multiple documents per row with segment ids;
    ``max_tokens`` switches to the token-budget sampler. ``cp``/
    ``cp_layout`` are taken for the JAX signature: ``cp > 1`` raises
    before any batch is made.
    """
    check_cp(cp)
    lengths = [len(dataset[i]) for i in range(len(dataset))]
    if max_tokens is not None:
        sampler = token_batches(lengths, max_tokens, shuffle=shuffle,
                                seed=seed)
    else:
        sampler = sample_batches(len(dataset), batch_rows, shuffle=shuffle,
                                 drop_last=drop_last, seed=seed)

    rows_ids = []
    rows_labels = []
    rows_pos = []
    rows_segs = []

    def drain():
        nonlocal rows_ids, rows_labels, rows_pos, rows_segs
        while len(rows_ids) >= batch_rows:
            out = {
                "input_ids": np.stack(rows_ids[:batch_rows]),
                "labels": np.stack(rows_labels[:batch_rows]),
                "positions": np.stack(rows_pos[:batch_rows]),
                "segment_ids": np.stack(rows_segs[:batch_rows]),
            }
            rows_ids = rows_ids[batch_rows:]
            rows_labels = rows_labels[batch_rows:]
            rows_pos = rows_pos[batch_rows:]
            rows_segs = rows_segs[batch_rows:]
            yield out

    for batch_idx in sampler:
        seqs = [dataset[i] for i in batch_idx]
        pb = (pack_sequences(seqs, seq_len, pad_id=pad_id, cp=cp,
                             cp_layout=cp_layout)
              if pack else pad_batch(seqs, seq_len, pad_id=pad_id))
        rows_ids.extend(pb.input_ids)
        rows_labels.extend(pb.labels)
        rows_pos.extend(pb.positions)
        rows_segs.extend(pb.segment_ids)
        yield from drain()
    if rows_ids and not drop_last:
        # final partial batch (dynamic row count — caller opted in)
        yield {
            "input_ids": np.stack(rows_ids),
            "labels": np.stack(rows_labels),
            "positions": np.stack(rows_pos),
            "segment_ids": np.stack(rows_segs),
        }
