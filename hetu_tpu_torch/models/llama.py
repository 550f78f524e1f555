"""Llama family (counterpart of ``hetu_tpu/models/llama.py``): RMSNorm,
RoPE, GQA, SwiGLU, an untied LM head by default. The training forward
(``loss``: residual and attention dropout, remat through
``StackedBlocks``), the inference forward and the decode path the
serving engine runs. With ``num_experts > 0`` each block's FFN is a
mixture of SwiGLU experts (``nn/moe.py``) on one device; expert
parallelism comes with slice 4."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hetu_tpu_torch import resolve_device
from hetu_tpu_torch.nn.layers import RMSNorm
from hetu_tpu_torch.nn.moe import add_aux, moe_mlp, with_aux
from hetu_tpu_torch.nn.parallel import (
    ColumnParallelLinear, ParallelAttention, ParallelMLP, StackedBlocks,
    VocabParallelEmbedding,
)
from hetu_tpu_torch.ops.dropout import dropout, generator_for, split_seed
from hetu_tpu_torch.ops.losses import vocab_parallel_lm_loss


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """``hetu_tpu/models/llama.py:30-70``; the defaults are Llama-2-7B."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None   # None → MHA
    head_dim: Optional[int] = None
    max_positions: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    init_std: float = 0.02
    tie_embeddings: bool = False
    # residual dropout (0: Llama's pretraining; nonzero is the usual SFT
    # regularizer); applies only when the train step passes a seed
    resid_pdrop: float = 0.0
    # on the attention probabilities, inside the flash kernels
    attn_pdrop: float = 0.0
    # mixture of experts (0 experts: dense; experts are SwiGLU like the
    # dense MLP): see ``GPTConfig``
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_gate: str = "topk"   # "topk" | "ktop1" | "sam" | "balance"
    moe_num_groups: int = 0  # SAM expert groups (0 = gate default)

    @classmethod
    def llama_7b(cls):
        return cls()

    @classmethod
    def llama_13b(cls):
        return cls(hidden_size=5120, intermediate_size=13824,
                   num_layers=40, num_heads=40)

    @classmethod
    def tiny(cls):
        """Test-size config with GQA exercised."""
        return cls(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2,
                   max_positions=128)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, **kw)
        self.attn = ParallelAttention(
            cfg.hidden_size, cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads or cfg.num_heads,
            head_dim=cfg.head_dim, bias=False, use_rope=True,
            rope_theta=cfg.rope_theta, max_positions=cfg.max_positions, **kw)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps,
                                      **kw)
        #: an MoE block returns ``(x, aux)`` from ``forward``
        self.returns_aux = cfg.num_experts > 0
        if self.returns_aux:
            self.mlp = moe_mlp(cfg, cfg.intermediate_size, gated=True, **kw)
        else:
            self.mlp = ParallelMLP(cfg.hidden_size, cfg.intermediate_size,
                                   bias=False, gated=True, **kw)
        self.resid_pdrop = cfg.resid_pdrop
        self.attn_pdrop = cfg.attn_pdrop

    def forward(self, x, *, positions=None, segment_ids=None,
                dropout_seed=None):
        """Training forward (``hetu_tpu/models/llama.py:130-156``); the
        seed splits as the JAX key does: three ways with attention
        dropout, else two ways with residual dropout. Without a seed it
        is the inference forward. An MoE block returns ``(x, aux)``."""
        sa = s1 = s2 = None
        if dropout_seed is not None and self.attn_pdrop > 0:
            sa, s1, s2 = split_seed(dropout_seed, 3)
        elif dropout_seed is not None and self.resid_pdrop > 0:
            s1, s2 = split_seed(dropout_seed, 2)
        a = self.attn(self.input_norm(x), positions=positions,
                      segment_ids=segment_ids, dropout_rate=self.attn_pdrop,
                      dropout_seed=sa)
        x = x + dropout(a, self.resid_pdrop, generator_for(s1, x.device))
        h = self.mlp(self.post_attn_norm(x))
        if self.returns_aux:
            h, aux = h
        x = x + dropout(h, self.resid_pdrop, generator_for(s2, x.device))
        return (x, aux) if self.returns_aux else x

    def decode(self, x, kv_cache, *, lora=None, w8a8: bool = False,
               w8a8_wq=None, **kwargs):
        """Decode mode; an MoE FFN runs ``MoEMLP.decode``. ``lora`` (one
        layer's adapter pages) reaches attention and a dense FFN; expert
        weights carry no adapter. ``w8a8`` sends the FFN through its W8A8
        lane, against ``w8a8_wq`` (this layer's ``prequantize`` tree)
        when given (``hetu_tpu/models/llama.py:120-128``); the MoE lane
        quantizes only with the tree."""
        x = x + self.attn.decode(self.input_norm(x), kv_cache, lora=lora,
                                 **kwargs)
        if self.returns_aux:
            return x + self.mlp.decode(self.post_attn_norm(x), w8a8=w8a8,
                                       wq=w8a8_wq)
        return x + self.mlp(self.post_attn_norm(x), lora=lora, w8a8=w8a8,
                            w8a8_wq=w8a8_wq)


class LlamaLMHeadModel(nn.Module):
    """Llama with an untied LM head (or the embedding when
    ``tie_embeddings``).

    ``device=None`` means ``cuda`` (raises without a card unless
    ``device="cpu"``). Weights are random, drawn on the model's device
    from a ``torch.Generator`` seeded with ``seed``: every matrix and
    embedding ~ N(0, ``init_std``), norm scales 1 — ``hetu_tpu``'s init
    distribution, not its values (load converted ``hetu_tpu`` params with
    ``models.convert.params_from_jax``)."""

    def __init__(self, cfg: LlamaConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=dev, dtype=dtype)
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                          **kw)
        self.blocks = StackedBlocks(lambda: LlamaBlock(cfg, **kw),
                                    cfg.num_layers)
        self.final_norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps,
                                  **kw)
        if not cfg.tie_embeddings:
            self.lm_head = ColumnParallelLinear(cfg.hidden_size,
                                                cfg.vocab_size, bias=False,
                                                **kw)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith(".lora_B"):
                p.zero_()
            else:
                p.normal_(0.0, self.cfg.init_std, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wte.weight.dtype

    def embed(self, input_ids, *, positions=None):
        """Token embedding; the rotary positions are applied inside the
        blocks."""
        del positions
        return self.wte(input_ids)

    def backbone(self, input_ids, *, positions=None, segment_ids=None,
                 remat: str = "none", remat_mask=None, unroll: bool = False,
                 dropout_seed=None):
        """embed + blocks under ``remat`` (``StackedBlocks.forward``),
        without the final norm (``head_loss`` applies it). ``positions``
        (b, s) rotate q and k (default ``arange(s)``); a packed batch
        restarts them at each document. ``dropout_seed=None`` (eval)
        disables dropout whatever the config's rates. Returns ``(h,
        aux)`` (``:191-204``): the MoE aux summed over layers, an fp32
        zero for a dense model."""
        h = self.embed(input_ids)
        out = self.blocks(h, remat=remat, remat_mask=remat_mask,
                          unroll=unroll, positions=positions,
                          segment_ids=segment_ids,
                          dropout_seed=dropout_seed)
        return with_aux(self.blocks, out)

    def head_loss(self, h, labels, *, ignore_index: int = -100):
        """Final norm + LM loss (``hetu_tpu/models/llama.py:184``) on
        pre-norm backbone output: the chunked CE for a vocab of 8192 or
        more (``ops/losses.py``)."""
        return vocab_parallel_lm_loss(self.final_norm(h), self.head_weight(),
                                      labels, ignore_index=ignore_index)

    def loss(self, input_ids, labels, *, ignore_index: int = -100, **kwargs):
        """Mean LM loss plus ``moe_aux_coef`` times the MoE aux
        (``:219-223``); ``kwargs`` go to :meth:`backbone`."""
        h, aux = self.backbone(input_ids, **kwargs)
        return add_aux(self.cfg, self.head_loss(h, labels,
                                                ignore_index=ignore_index),
                       aux)

    def hidden_norm(self, h):
        return self.final_norm(h)

    def head_weight(self):
        """(V, E): the tied embedding or the LM head."""
        if self.cfg.tie_embeddings:
            return self.wte.weight
        return self.lm_head.weight

    def logits(self, h):
        """fp32 logits of normed hidden states, as ``hetu_tpu`` computes
        them (``models/llama.py:212-217``, ``generation.py:110-112``)."""
        return F.linear(h.float(), self.head_weight().float())

    def forward(self, input_ids, **kwargs):
        """Full fp32 logits (b, s, V)."""
        h, _ = self.backbone(input_ids, **kwargs)
        return self.logits(self.hidden_norm(h))
