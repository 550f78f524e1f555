"""LM losses (counterpart of ``hetu_tpu/ops/losses.py`` at tp=1).

The head matmul multiplies operands of the compute dtype into fp32
logits (``preferred_element_type=float32`` in JAX). ``chunked_lm_loss``
never holds more than one chunk's (tokens, V) logits: each chunk runs
under ``torch.utils.checkpoint``, which keeps only the chunk's inputs and
recomputes its logits in the backward. ``HETU_LM_LOSS_IMPL=fused``
switches a large vocab to the fused kernels of ``ops/fused_ce.py``,
which never write logits to device memory. The auxiliary losses
(``mse_loss``, ``nll_loss``, ``bce_loss``, ``bce_with_logits_loss``,
``kl_div_loss``, ``:350-395``) compute in fp32 with JAX's reductions.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hetu_tpu_torch.core.dtypes import current_policy
from hetu_tpu_torch.ops.fused_ce import fused_lm_ce

# Per-chunk fp32 logits budget (``hetu_tpu/ops/losses.py:47``): chunk
# count, not chunk size, sets the backward's traffic (each chunk re-reads
# and re-writes the (V, E) dW accumulator), so chunks stay large.
CHUNK_LOGITS_BYTES = 768 * 1024 * 1024


class _HeadMatmul(torch.autograd.Function):
    """``h (N, E) @ w (V, E)^T`` from operands of a 16-bit dtype into fp32
    logits, with fp32 accumulation. On CUDA one cuBLAS call with an fp32
    output; on the CPU the same products upcast (a product of two bf16
    values is exact in fp32). The backward rounds the fp32 cotangent to
    the operands' dtype before its two matmuls, and returns grads in that
    dtype, as the transpose of a mixed-precision dot does in JAX."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.device.type == "cuda":
            return torch.mm(h, w.t(), out_dtype=torch.float32)
        return h.float() @ w.float().t()

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return g @ w, g.t() @ h


def head_logits(h: torch.Tensor, w: torch.Tensor,
                mm_dt: torch.dtype) -> torch.Tensor:
    """fp32 logits ``h @ w^T`` with both operands cast to ``mm_dt``
    first; h (..., E), w (V, E)."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1]).to(mm_dt)
    w = w.to(mm_dt)
    if mm_dt == torch.float32:
        out = h2 @ w.t()
    else:
        out = _HeadMatmul.apply(h2, w)
    return out.reshape(*lead, w.shape[0])


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -100):
    """Token-level CE. Returns the per-token loss (0 where ignored) and
    the valid mask."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None].long()).squeeze(-1)
    return (lse - tgt) * valid, valid


def cross_entropy_mean(logits, labels, ignore_index: int = -100):
    loss, valid = softmax_cross_entropy(logits, labels, ignore_index)
    return loss.sum() / valid.sum().clamp(min=1)


def _chunk_loss(h_c, w, y_c, mm_dt, ignore_index):
    # the weight cast stays inside the chunk: its backward turns each
    # chunk's dW back to fp32 before the cross-chunk sum, so the tied
    # embedding's head grad accumulates in fp32, not bf16
    loss, valid = softmax_cross_entropy(head_logits(h_c, w, mm_dt), y_c,
                                        ignore_index)
    return loss.sum(), valid.sum()


def chunked_lm_loss(hidden: torch.Tensor, vocab_weight: torch.Tensor,
                    labels: torch.Tensor, *,
                    mm_dt: Optional[torch.dtype] = None,
                    ignore_index: int = -100,
                    chunk_tokens: Optional[int] = None) -> torch.Tensor:
    """Mean LM CE without the full (B, S, V) logits
    (``hetu_tpu/ops/losses.py:72``). The sequence dim is cut into chunks
    of ``chunk_tokens // B`` steps (batch stays whole); a ragged tail is
    padded with ``ignore_index`` labels. ``chunk_tokens`` defaults to
    ``CHUNK_LOGITS_BYTES`` of fp32 logits, at least 512 tokens."""
    mm_dt = mm_dt if mm_dt is not None else hidden.dtype
    B, S, _ = hidden.shape
    if chunk_tokens is None:
        chunk_tokens = max(512, CHUNK_LOGITS_BYTES
                           // (4 * vocab_weight.shape[0]))
    c = max(1, min(S, chunk_tokens // max(B, 1)))
    if S % c:
        pad = c - S % c
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
        S += pad
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    valid_sum = torch.zeros((), dtype=torch.long, device=hidden.device)
    for i in range(S // c):
        cut = slice(i * c, (i + 1) * c)
        loss, valid = checkpoint(_chunk_loss, hidden[:, cut], vocab_weight,
                                 labels[:, cut], mm_dt, ignore_index,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        loss_sum = loss_sum + loss
        valid_sum = valid_sum + valid
    return loss_sum / valid_sum.clamp(min=1)


def vocab_parallel_lm_loss(hidden: torch.Tensor, vocab_weight: torch.Tensor,
                           labels: torch.Tensor, *,
                           ignore_index: int = -100) -> torch.Tensor:
    """Mean LM loss at tp=1 (``hetu_tpu/ops/losses.py:251``): a vocab of
    8192 or more goes through :func:`chunked_lm_loss`, or, with
    ``HETU_LM_LOSS_IMPL=fused``, through the fused LM-head kernels
    (:func:`~hetu_tpu_torch.ops.fused_ce.fused_lm_ce`, TPU kernels
    #5-#7); a smaller one through dense logits. All multiply in the
    policy's compute dtype."""
    mm_dt = current_policy().compute_dtype
    if vocab_weight.shape[0] >= 8192:
        if os.environ.get("HETU_LM_LOSS_IMPL") == "fused":
            return fused_lm_ce(hidden.to(mm_dt), vocab_weight, labels,
                               ignore_index=ignore_index)
        return chunked_lm_loss(hidden, vocab_weight, labels, mm_dt=mm_dt,
                               ignore_index=ignore_index)
    return cross_entropy_mean(head_logits(hidden, vocab_weight, mm_dt),
                              labels, ignore_index)


# -- auxiliary losses (``hetu_tpu/ops/losses.py:350-395``) ---------------------

def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none":
        return x
    raise ValueError(f"unknown reduction {reduction!r}")


def mse_loss(pred, target, *, reduction: str = "mean"):
    d = (pred.float() - target.float()) ** 2
    return _reduce(d, reduction)


def nll_loss(log_probs, labels, *, ignore_index: int = -100,
             reduction: str = "mean"):
    """Negative log likelihood over pre-computed log-probs (..., C);
    ``ignore_index`` labels add nothing and leave the mean."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ll = torch.gather(log_probs.float(), -1,
                      safe[..., None].long()).squeeze(-1)
    loss = -ll * valid
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1)
    return _reduce(loss, reduction)


def bce_loss(probs, target, *, eps: float = 1e-7, reduction: str = "mean"):
    p = probs.float().clamp(eps, 1.0 - eps)
    t = target.float()
    loss = -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))
    return _reduce(loss, reduction)


def bce_with_logits_loss(logits, target, *, reduction: str = "mean"):
    """Sigmoid and BCE in the stable log-sum-exp form."""
    x = logits.float()
    t = target.float()
    loss = x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return _reduce(loss, reduction)


def kl_div_loss(log_pred, target_probs, *, eps: float = 1e-12,
                reduction: str = "batchmean"):
    """KL(target || pred) with ``pred`` given as log-probs; ``batchmean``
    divides the sum by the leading dim."""
    t = target_probs.float()
    lp = log_pred.float()
    point = t * (torch.log(t.clamp(min=eps)) - lp)
    if reduction == "batchmean":
        return point.sum() / point.shape[0]
    return _reduce(point, reduction)
