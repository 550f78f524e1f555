"""Numerics of the port: plain PyTorch ops and the hand-written CUDA
kernels (``flash`` forward and backward, ``paged`` with its int8 lane,
``fused_ce``)."""

from hetu_tpu_torch.ops._build import launch_counts, reset_launch_counts
from hetu_tpu_torch.ops.activations import gelu, swiglu
from hetu_tpu_torch.ops.attention import (
    NEG_INF, attention_reference, attention_with_lse, flash_attention,
    gather_block_rows,
)
from hetu_tpu_torch.ops.dropout import dropout
from hetu_tpu_torch.ops.flash import (
    dropout_keep, dropout_keep_bh, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference, flash_lane,
)
from hetu_tpu_torch.ops.fused_ce import (
    fused_ce_dh, fused_ce_dh_reference, fused_ce_dw, fused_ce_dw_reference,
    fused_ce_fwd, fused_ce_lane, fused_lm_ce, fused_lse_tgt,
    fused_lse_tgt_reference,
)
from hetu_tpu_torch.ops.losses import (
    bce_loss, bce_with_logits_loss, chunked_lm_loss, cross_entropy_mean,
    kl_div_loss, mse_loss, nll_loss, softmax_cross_entropy,
    vocab_parallel_lm_loss,
)
from hetu_tpu_torch.ops.normalization import layer_norm, rms_norm
from hetu_tpu_torch.ops.paged import (
    combine_attention_lse, paged_attention, paged_attention_reference,
    paged_lane,
)
from hetu_tpu_torch.ops.quantization import (
    dequantize_int4, dequantize_int8, int8_matmul, int8_mm, int8_w8a8_matmul,
    int8_w8a8_matmul_prequant, quantize_int4, quantize_int8,
)
from hetu_tpu_torch.ops.rotary import apply_rotary, rope_frequencies

__all__ = [
    "NEG_INF", "apply_rotary", "attention_reference", "attention_with_lse",
    "bce_loss", "bce_with_logits_loss", "chunked_lm_loss", "combine_attention_lse", "cross_entropy_mean",
    "dequantize_int4", "dequantize_int8", "dropout", "dropout_keep",
    "dropout_keep_bh", "flash_attention",
    "flash_attention_bwd", "flash_attention_bwd_reference",
    "flash_attention_fwd", "flash_attention_fwd_reference", "flash_lane",
    "fused_ce_dh", "fused_ce_dh_reference", "fused_ce_dw",
    "fused_ce_dw_reference", "fused_ce_fwd", "fused_ce_lane", "fused_lm_ce",
    "fused_lse_tgt", "fused_lse_tgt_reference",
    "gather_block_rows", "gelu", "int8_matmul", "int8_mm",
    "int8_w8a8_matmul", "int8_w8a8_matmul_prequant", "kl_div_loss",
    "launch_counts", "layer_norm", "mse_loss", "nll_loss",
    "paged_attention", "paged_attention_reference", "paged_lane",
    "quantize_int4", "quantize_int8",
    "reset_launch_counts", "rms_norm", "rope_frequencies",
    "softmax_cross_entropy", "swiglu", "vocab_parallel_lm_loss",
]
