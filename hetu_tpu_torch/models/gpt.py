"""GPT-2 family (counterpart of ``hetu_tpu/models/gpt.py``): learned
position embeddings, pre-LayerNorm blocks, GELU MLP (or, with
``num_experts > 0``, a mixture of GELU experts: GPT-MoE), LM head tied
to the token embedding. The training forward (``loss``) and the decode
path."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from hetu_tpu_torch import resolve_device
from hetu_tpu_torch.nn.layers import Embedding, LayerNorm
from hetu_tpu_torch.nn.moe import add_aux, moe_mlp, with_aux
from hetu_tpu_torch.nn.parallel import (
    ParallelAttention, ParallelMLP, StackedBlocks, VocabParallelEmbedding,
)
from hetu_tpu_torch.ops.dropout import dropout, generator_for, split_seed
from hetu_tpu_torch.ops.losses import vocab_parallel_lm_loss


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    max_positions: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-5
    init_std: float = 0.02
    # dropout rates (0: GPT-2's pretraining benches stay deterministic);
    # they apply only when the train step passes a dropout seed
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    # on the attention probabilities, inside the flash kernels
    attn_pdrop: float = 0.0
    # mixture of experts (0 experts: dense; BASELINE config 4). The
    # capacity factor is read only by ``nn.moe.gate_drop_stats`` on one
    # device; the gate is "topk" | "ktop1" | "sam" | "balance", and
    # ``moe_num_groups`` the SAM gate's expert groups (0: its default)
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_gate: str = "topk"
    moe_num_groups: int = 0

    @classmethod
    def small(cls):
        return cls()

    @classmethod
    def moe_8e(cls):
        """GPT-MoE 8-expert (BASELINE config 4)."""
        return cls(num_experts=8)

    @classmethod
    def tiny(cls):
        """Test-size config."""
        return cls(vocab_size=256, max_positions=128, hidden_size=64,
                   num_layers=2, num_heads=4)

    @classmethod
    def tiny_moe(cls, num_experts=4, **kw):
        return cls(vocab_size=256, max_positions=128, hidden_size=64,
                   num_layers=2, num_heads=4, num_experts=num_experts, **kw)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.attn = ParallelAttention(cfg.hidden_size, cfg.num_heads,
                                      bias=True, **kw)
        self.ln_2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        #: an MoE block returns ``(x, aux)`` from ``forward``
        self.returns_aux = cfg.num_experts > 0
        if self.returns_aux:
            self.mlp = moe_mlp(cfg, cfg.mlp_ratio * cfg.hidden_size,
                               gated=False, **kw)
        else:
            self.mlp = ParallelMLP(cfg.hidden_size,
                                   cfg.mlp_ratio * cfg.hidden_size,
                                   bias=True, **kw)
        self.resid_pdrop = cfg.resid_pdrop
        self.attn_pdrop = cfg.attn_pdrop

    def forward(self, x, *, positions=None, segment_ids=None,
                dropout_seed=None):
        """Training forward (``hetu_tpu/models/gpt.py:138-164``); the seed
        splits as the JAX key does: three ways with attention dropout,
        else two ways with residual dropout. ``positions`` is taken for
        the blocks' common signature: GPT-2's are added in the
        embedding. An MoE block returns ``(x, aux)``."""
        del positions
        sa = s1 = s2 = None
        if dropout_seed is not None and self.attn_pdrop > 0:
            sa, s1, s2 = split_seed(dropout_seed, 3)
        elif dropout_seed is not None and self.resid_pdrop > 0:
            s1, s2 = split_seed(dropout_seed, 2)
        a = self.attn(self.ln_1(x), segment_ids=segment_ids,
                      dropout_rate=self.attn_pdrop, dropout_seed=sa)
        x = x + dropout(a, self.resid_pdrop, generator_for(s1, x.device))
        h = self.mlp(self.ln_2(x))
        if self.returns_aux:
            h, aux = h
        x = x + dropout(h, self.resid_pdrop, generator_for(s2, x.device))
        return (x, aux) if self.returns_aux else x

    def decode(self, x, kv_cache, *, lora=None, w8a8: bool = False,
               w8a8_wq=None, **kwargs):
        """Decode mode; an MoE FFN runs its per-row top-k lane
        (``MoEMLP.decode``), as ``hetu_tpu``'s kv-cache branch does.
        ``lora`` (one layer's adapter pages) reaches attention and a dense
        FFN; expert weights carry no adapter. ``w8a8`` sends the FFN
        through its W8A8 lane, against ``w8a8_wq`` (this layer's
        ``prequantize`` tree) when given (``hetu_tpu/models/gpt.py:
        115-136``); the MoE lane quantizes only with the tree."""
        x = x + self.attn.decode(self.ln_1(x), kv_cache, lora=lora, **kwargs)
        if self.returns_aux:
            return x + self.mlp.decode(self.ln_2(x), w8a8=w8a8, wq=w8a8_wq)
        return x + self.mlp(self.ln_2(x), lora=lora, w8a8=w8a8,
                            w8a8_wq=w8a8_wq)


class GPTLMHeadModel(nn.Module):
    """GPT-2 with a tied-embedding LM head.

    ``device=None`` means ``cuda`` (raises without a card unless
    ``device="cpu"``). Weights are random, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device: every
    matrix and embedding ~ N(0, ``init_std``), biases 0, norm scales 1 —
    ``hetu_tpu``'s init distribution (not its values; load converted
    ``hetu_tpu`` params with ``models.convert.params_from_jax``)."""

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=dev, dtype=dtype)
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                          **kw)
        self.wpe = Embedding(cfg.max_positions, cfg.hidden_size, **kw)
        self.blocks = StackedBlocks(lambda: GPTBlock(cfg, **kw),
                                    cfg.num_layers)
        self.ln_f = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf in ("bias", "lora_B"):
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
        if positions is None:
            positions = torch.arange(input_ids.shape[-1],
                                     device=input_ids.device)[None, :]
        return self.wte(input_ids) + self.wpe(positions)

    def backbone(self, input_ids, *, positions=None, segment_ids=None,
                 remat: str = "none", remat_mask=None, unroll: bool = False,
                 dropout_seed=None):
        """embed + blocks, without the final norm (``head_loss`` applies
        it). ``dropout_seed=None`` (eval) disables dropout whatever the
        config's rates. Returns ``(h, aux)`` as ``hetu_tpu`` does
        (``models/gpt.py:200-220``): aux is the MoE load-balance loss
        summed over layers, an fp32 zero for a dense model."""
        s_embd = s_blocks = None
        if dropout_seed is not None:
            s_embd, s_blocks = split_seed(dropout_seed, 2)
        h = self.embed(input_ids, positions=positions)
        h = dropout(h, self.cfg.embd_pdrop, generator_for(s_embd, h.device))
        out = self.blocks(h, remat=remat, remat_mask=remat_mask,
                          unroll=unroll, segment_ids=segment_ids,
                          dropout_seed=s_blocks)
        return with_aux(self.blocks, out)

    def head_loss(self, h, labels, *, ignore_index: int = -100):
        """Final norm + LM loss (tied head) on pre-norm backbone output."""
        return vocab_parallel_lm_loss(self.ln_f(h), self.wte.weight, labels,
                                      ignore_index=ignore_index)

    def loss(self, input_ids, labels, *, ignore_index: int = -100, **kwargs):
        """Mean LM loss plus ``moe_aux_coef`` times the MoE aux
        (``:236-242``); ``kwargs`` go to :meth:`backbone`."""
        h, aux = self.backbone(input_ids, **kwargs)
        return add_aux(self.cfg, self.head_loss(h, labels,
                                                ignore_index=ignore_index),
                       aux)

    def forward(self, input_ids, **kwargs):
        """Full fp32 logits (b, s, V)."""
        h, _ = self.backbone(input_ids, **kwargs)
        return self.logits(self.hidden_norm(h))

    def hidden_norm(self, h):
        return self.ln_f(h)

    def head_weight(self):
        return self.wte.weight

    def logits(self, h):
        """fp32 logits of normed hidden states: ``h @ wte^T``."""
        return F.linear(h.float(), self.head_weight().float())
