"""GPT-2 family, decode path (counterpart of ``hetu_tpu/models/gpt.py``):
learned position embeddings, pre-LayerNorm blocks, GELU MLP, LM head tied
to the token embedding."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from hetu_tpu_torch import resolve_device
from hetu_tpu_torch.nn.layers import Embedding, LayerNorm
from hetu_tpu_torch.nn.parallel import (
    ParallelAttention, ParallelMLP, StackedBlocks, VocabParallelEmbedding,
)


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

    @classmethod
    def small(cls):
        return cls()

    @classmethod
    def tiny(cls):
        """Test-size config."""
        return cls(vocab_size=256, max_positions=128, hidden_size=64,
                   num_layers=2, num_heads=4)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.attn = ParallelAttention(cfg.hidden_size, cfg.num_heads,
                                      bias=True, **kw)
        self.ln_2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.mlp = ParallelMLP(cfg.hidden_size,
                               cfg.mlp_ratio * cfg.hidden_size, bias=True,
                               **kw)

    def decode(self, x, kv_cache, **kwargs):
        x = x + self.attn.decode(self.ln_1(x), kv_cache, **kwargs)
        return x + self.mlp(self.ln_2(x))


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
            elif leaf == "bias":
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

    def hidden_norm(self, h):
        return self.ln_f(h)

    def head_weight(self):
        return self.wte.weight

    def logits(self, h):
        """fp32 logits of normed hidden states: ``h @ wte^T``."""
        return F.linear(h.float(), self.head_weight().float())
