"""Datasets (a copy of ``hetu_tpu/data/dataset.py``, which is
numpy-only): ``JsonDataset`` with any tokenizer callable ``str ->
list[int]``, and ``SyntheticLMDataset``, the random-token corpus the
tests and benchmarks use. The same seed gives the same documents as
``hetu_tpu``'s."""

from __future__ import annotations

import json
from typing import Callable, Iterator, Optional

import numpy as np


class JsonDataset:
    """JSONL file of ``{"text": ...}`` (or pre-tokenized
    ``{"tokens": [...]}``) records."""

    def __init__(self, path: str, *, field: str = "text",
                 tokenizer: Optional[Callable] = None,
                 max_items: Optional[int] = None):
        self.records: list[np.ndarray] = []
        with open(path) as f:
            for i, line in enumerate(f):
                if max_items is not None and i >= max_items:
                    break
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if "tokens" in rec:
                    toks = rec["tokens"]
                elif tokenizer is not None:
                    toks = tokenizer(rec[field])
                else:
                    raise ValueError(
                        "text records need a tokenizer callable")
                self.records.append(np.asarray(toks, np.int32))

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> np.ndarray:
        return self.records[i]

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self.records)


class SyntheticLMDataset:
    """Random-token corpus with a length distribution — for tests and
    benchmarks (stands in for the reference's ci_test fixture data)."""

    def __init__(self, vocab_size: int, num_docs: int = 256, *,
                 min_len: int = 8, max_len: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.records = [
            rng.integers(0, vocab_size,
                         size=rng.integers(min_len, max_len + 1),
                         dtype=np.int32)
            for _ in range(num_docs)
        ]

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]

    def __iter__(self):
        return iter(self.records)
