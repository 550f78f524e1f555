"""Numerics of the port: plain PyTorch ops and the two hand-written CUDA
kernels of the serving path (``flash`` and ``paged``)."""

from hetu_tpu_torch.ops._build import launch_counts, reset_launch_counts
from hetu_tpu_torch.ops.activations import gelu
from hetu_tpu_torch.ops.attention import (
    NEG_INF, attention_reference, attention_with_lse, gather_block_rows,
)
from hetu_tpu_torch.ops.flash import (
    flash_attention_fwd, flash_attention_fwd_reference,
)
from hetu_tpu_torch.ops.normalization import layer_norm
from hetu_tpu_torch.ops.paged import (
    combine_attention_lse, paged_attention, paged_attention_reference,
)

__all__ = [
    "NEG_INF", "attention_reference", "attention_with_lse",
    "combine_attention_lse", "flash_attention_fwd",
    "flash_attention_fwd_reference", "gather_block_rows", "gelu",
    "launch_counts", "layer_norm", "paged_attention",
    "paged_attention_reference", "reset_launch_counts",
]
