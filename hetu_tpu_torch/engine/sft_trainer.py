"""Supervised fine-tuning trainer (a copy of
``hetu_tpu/engine/sft_trainer.py`` on the port's :class:`Trainer`):
instruction tuning where the loss applies only to response tokens
(prompt positions masked to ``ignore_index``)."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from hetu_tpu_torch.engine.trainer import Trainer


def make_sft_batch(prompts: Sequence[np.ndarray],
                   responses: Sequence[np.ndarray], seq_len: int, *,
                   pad_id: int = 0, ignore_index: int = -100) -> dict:
    """Build (input_ids, labels, positions) with prompt tokens masked out
    of the loss. Each example is ``prompt + response`` truncated/padded to
    ``seq_len``."""
    n = len(prompts)
    input_ids = np.full((n, seq_len), pad_id, np.int32)
    labels = np.full((n, seq_len), ignore_index, np.int32)
    positions = np.zeros((n, seq_len), np.int32)
    for r, (p, a) in enumerate(zip(prompts, responses)):
        seq = np.concatenate([np.asarray(p), np.asarray(a)])[:seq_len]
        L = len(seq)
        input_ids[r, :L] = seq
        positions[r, :L] = np.arange(L)
        # next-token labels, but only where the *predicted* token is in
        # the response
        lab = np.full(L, ignore_index, np.int64)
        start = max(len(p) - 1, 0)           # predicting first response tok
        lab[start:L - 1] = seq[start + 1:L]
        labels[r, :L] = lab
    return {"input_ids": input_ids, "labels": labels,
            "positions": positions}


def sft_batches(prompts, responses, *, seq_len: int, batch_size: int,
                shuffle: bool = True, seed: int = 0) -> Iterable[dict]:
    idx = np.arange(len(prompts))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        sel = idx[i:i + batch_size]
        yield make_sft_batch([prompts[j] for j in sel],
                             [responses[j] for j in sel], seq_len)


class SFTTrainer(Trainer):
    """Trainer whose ``fit`` consumes (prompt, response) pairs."""

    def fit(self, prompts, responses, *, seq_len: int, batch_size: int,
            steps: Optional[int] = None, shuffle: bool = True,
            seed: int = 0):
        batches = sft_batches(prompts, responses, seq_len=seq_len,
                              batch_size=batch_size, shuffle=shuffle,
                              seed=seed)
        return self.train(batches, steps=steps)
