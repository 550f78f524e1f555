"""Data pipeline (counterpart of ``hetu_tpu/data``): datasets, packing,
batch samplers, the loader, seq-len buckets and the device prefetcher.
Tokenizers and the Hydraulis dispatcher are not ported yet."""

from hetu_tpu_torch.data.bucket import (
    BucketStats, SeqLenBuckets, ShapeBucketer,
)
from hetu_tpu_torch.data.dataset import JsonDataset, SyntheticLMDataset
from hetu_tpu_torch.data.loader import (
    build_data_loader, sample_batches, token_batches,
)
from hetu_tpu_torch.data.packing import PackedBatch, pack_sequences, \
    pad_batch
from hetu_tpu_torch.data.prefetch import DevicePrefetcher, to_tensors

__all__ = ["BucketStats", "DevicePrefetcher", "JsonDataset", "PackedBatch",
           "SeqLenBuckets", "ShapeBucketer", "SyntheticLMDataset",
           "build_data_loader", "pack_sequences",
           "pad_batch", "sample_batches", "to_tensors", "token_batches"]
