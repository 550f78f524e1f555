"""Attention: the plain fp32 oracle, the differentiable flash attention
that training runs, and the ``(out, lse)`` entry the packed-prefill lane
uses (counterpart of ``hetu_tpu/ops/attention.py``).

Layout everywhere: ``(batch, seq, heads, head_dim)``; GQA allowed (kv
heads divide q heads). Masked logits are the finite ``NEG_INF`` so a
fully masked row gives output 0 and LSE ``NEG_INF``, never NaN.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from hetu_tpu_torch.ops.dropout import seed_word

NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    kv_heads = k.shape[-2]
    if kv_heads == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // kv_heads, dim=-2)


def gather_block_rows(buf: torch.Tensor,
                      block_tables: torch.Tensor) -> torch.Tensor:
    """Paged-KV gather: ``(n_blocks, block_size, ...)`` arena + ``(b, W)``
    block tables → the contiguous ``(b, W*block_size, ...)`` view. Row
    ``r``'s position ``p`` lives at arena row
    ``block_tables[r, p // block_size] * block_size + p % block_size``."""
    n_blocks, block_size = buf.shape[0], buf.shape[1]
    flat = buf.reshape((n_blocks * block_size,) + tuple(buf.shape[2:]))
    rows = (block_tables.long()[:, :, None] * block_size
            + torch.arange(block_size, device=buf.device)[None, None, :])
    rows = rows.reshape(block_tables.shape[0], -1)
    return flat[rows]


def attention_reference(q, k, v, *, causal: bool = False,
                        segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        return_lse: bool = False,
                        q_offset: Union[int, torch.Tensor] = 0,
                        kv_offset: Union[int, torch.Tensor] = 0,
                        block_tables: Optional[torch.Tensor] = None):
    """Plain attention, fp32 softmax.

    ``q_offset``/``kv_offset`` shift the absolute positions of the causal
    mask; a 1-D ``q_offset`` gives every batch row its own base position
    (row ``i`` of batch row ``r`` sits at ``q_offset[r] + i``).
    ``block_tables`` (b, W) switches k/v to the paged arena layout
    ``(n_blocks, block_size, h, d)``, gathered per row first. Returns
    ``out`` in q's dtype, plus the fp32 ``lse`` (b, h, sq) on request."""
    if block_tables is not None:
        k = gather_block_rows(k, block_tables)
        v = gather_block_rows(v, block_tables)
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    qf = q.float() * scale
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())

    mask = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=dev)
    if causal:
        qoff = torch.as_tensor(q_offset, device=dev)
        koff = torch.as_tensor(kv_offset, device=dev)
        qi = torch.arange(sq, device=dev)
        ki = torch.arange(sk, device=dev)
        if qoff.ndim or koff.ndim:
            qpos = qi[None, :, None] + qoff.reshape(-1, 1, 1)
            kpos = ki[None, None, :] + koff.reshape(-1, 1, 1)
            mask = mask & (qpos >= kpos)[:, None]
        else:
            qpos = qi[:, None] + qoff
            kpos = ki[None, :] + koff
            mask = mask & (qpos >= kpos)[None, None]
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None \
            else segment_ids
        mask = mask & (segment_ids[:, None, :, None]
                       == kv_seg[:, None, None, :])
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))

    lse = torch.logsumexp(logits, dim=-1)                   # (b, h, q)
    probs = torch.exp(logits - lse[..., None])
    probs = torch.where(mask, probs, torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    if return_lse:
        return out, lse
    return out


def flash_attention(q, k, v, *, causal: bool = False,
                    segment_ids: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    seed=None) -> torch.Tensor:
    """Differentiable flash attention, (b, s, h, d) layout, GQA allowed —
    the training attention (``hetu_tpu/ops/attention.py:211``,
    ``flash_pallas.py:671 flash_attention_pallas``).

    The forward and backward are the ``hetu_tpu_torch::flash_fwd`` /
    ``flash_bwd`` ops of ``ops/flash.py``: the hand-written kernels on a
    CUDA tensor (a head dim they refuse raises), the plain versions on a
    CPU tensor. ``dropout_rate`` applies only with a ``seed`` (an int or
    a staged seed; the mask is a hash of it and the positions), as a JAX
    dropout key does. The seed reaches the kernels as a device word
    (``ops.dropout.seed_word``)."""
    from hetu_tpu_torch.ops import flash  # noqa: F401  (registers the ops)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    drop = dropout_rate > 0.0 and seed is not None
    out, _ = torch.ops.hetu_tpu_torch.flash_fwd(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), segment_ids, segment_ids,
        bool(causal), float(scale), 0, 0,
        float(dropout_rate) if drop else 0.0,
        seed_word(seed, q.device) if drop else None)
    return out.transpose(1, 2)


def attention_with_lse(q, k, v, *, causal: bool = False,
                       segment_ids: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None):
    """Attention that also returns the log-sum-exp: ``(out, lse)`` with
    ``out`` (b, s, h, d) and ``lse`` (b, h, s) fp32.

    The packed-prefill lane's intra-pack part. It runs the flash forward
    (:func:`hetu_tpu_torch.ops.flash.flash_attention_fwd`): the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor — one
    formulation on both devices."""
    from hetu_tpu_torch.ops.flash import flash_attention_fwd
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out, lse = flash_attention_fwd(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), segment_ids, segment_ids,
        causal=causal, scale=scale)
    return out.transpose(1, 2), lse
