"""Autoregressive generation with KV caches (counterpart of
``hetu_tpu/models/generation.py``).

Fixed-capacity KV buffers written in place; the prompt is prefilled in
one pass, then one decode step per new token. The dense cache's
attention is plain PyTorch (as ``hetu_tpu`` computes it in plain jnp), so
:func:`generate` is an oracle for the serving engine that runs neither
hand-written kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch import resolve_device
from hetu_tpu_torch.nn.moe import refuse_batch_coupled


class PromptTooLongError(ValueError):
    """A prompt (plus its decode budget) exceeds a hard length limit:
    ``prompt_len`` + ``max_tokens`` against ``limit``."""

    def __init__(self, *, prompt_len: int, max_tokens: int, limit: int,
                 source: str = "decode", hint: Optional[str] = None):
        self.prompt_len = int(prompt_len)
        self.max_tokens = int(max_tokens)
        self.limit = int(limit)
        self.source = source
        worst = self.prompt_len + self.max_tokens
        msg = (f"prompt of {self.prompt_len} tokens + {self.max_tokens} "
               f"decode tokens = {worst} exceeds the {self.limit}-token "
               f"{source} budget")
        if hint:
            msg += f" ({hint})"
        super().__init__(msg)


def init_kv_caches(model, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None):
    """Zeroed ``(k, v)`` buffers stacked over layers,
    ``(L, batch, max_len, hkv, d)``, in ``dtype`` (default: the model's)
    on the model's device.

    ``dtype=torch.int8`` builds the QUANTIZED cache ``(k int8, k scales,
    v int8, v scales)`` with fp32 scales ``(L, batch, max_len, hkv, 1)``,
    one per (position, kv head) (``hetu_tpu/models/generation.py:55-69``):
    zero scales dequantize never-written rows to exact 0."""
    attn = model.blocks.block.attn
    shape = (model.blocks.num_layers, batch, max_len, attn.num_kv_heads,
             attn.head_dim)
    dtype = dtype or model.dtype
    dev = model.device
    if dtype == torch.int8:
        sshape = shape[:-1] + (1,)
        return (torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(sshape, dtype=torch.float32, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(sshape, dtype=torch.float32, device=dev))
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


@torch.no_grad()
def decode(model, input_ids, positions, caches, *, slot_mask=None,
           block_tables=None, row_mask=None, lora=None, w8a8_mask=None,
           w8a8_wq=None):
    """Run a chunk through the model in decode mode; returns fp32 logits
    ``(b, s, V)`` and updates ``caches`` in place.

    ``positions`` (b, s) are absolute positions. Without ``block_tables``
    the caches are dense ``(L, b, max_len, hkv, d)`` (or the int8
    4-tuple of :func:`init_kv_caches`) and every row shares the write
    index ``positions[0]``. With ``block_tables`` (b, W) int32
    and ``slot_mask`` (b,) bool the caches are the paged arena
    ``(L, n_blocks, block_size, hkv, d)`` and each row decodes at its own
    ``positions[r, 0]`` (masked-off rows write nothing); ``row_mask``
    (b, s) bool then lets only its True cells write
    (``hetu_tpu/models/generation.py:66``). ``lora`` (an adapter arena,
    ``{"ids": (b, s) pages, "pages": {proj: {"A": (L, P, in, r), "B":
    (L, P, r, out)}}}``) adds each token's adapter delta
    (``nn.parallel.lora_apply``); None is the base model, with no op
    added. ``w8a8_mask`` (one bool a layer) sends each True layer's FFN
    through its W8A8 lane, against ``w8a8_wq[l]`` (that layer's
    ``prequantize`` tree) when given (``hetu_tpu/models/generation.py:
    73-108``; ``StackedBlocks.decode``); None adds no op."""
    h = model.embed(input_ids, positions=positions)
    h = model.blocks.decode(h, caches, positions=positions,
                            slot_mask=slot_mask, block_tables=block_tables,
                            row_mask=row_mask, lora=lora,
                            w8a8_mask=w8a8_mask, w8a8_wq=w8a8_wq)
    return model.logits(model.hidden_norm(h))


def _sample(logits, *, temperature: float, top_k: int, top_p: float,
            generator: Optional[torch.Generator]):
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    from hetu_tpu_torch.serving.sampling import adjust_logits
    probs = torch.softmax(adjust_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, input_ids, *, max_new_tokens: int,
             max_len: Optional[int] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None, pad_id: Optional[int] = None,
             prompt_lens=None, device=None,
             return_logits: bool = False,
             cache_dtype: Optional[torch.dtype] = None, lora=None):
    """Generate ``max_new_tokens`` continuations for a ``(b, s)`` prompt.

    Returns ``(b, s + max_new_tokens)`` token ids (int64). Greedy at
    ``temperature=0``; otherwise each step draws one categorical sample
    per row from ``generator`` after the serving sampler's
    temperature/top-k/top-p masking. ``return_logits=True`` also returns
    the fp32 logits each token was chosen from, ``(b, max_new_tokens,
    V)``. ``device=None`` means ``cuda``; the model must live there.
    ``cache_dtype`` is the KV cache's dtype (default: the model's);
    ``torch.int8`` decodes from the quantized cache, as ``hetu_tpu``'s
    ``generate(cache_dtype=jnp.int8)`` does. ``lora`` decodes each row
    under an adapter: ``{"ids": (b,) page of each row, "pages": an arena
    as :func:`decode` takes it}``. An MoE model whose gate couples the
    rows of a batch (the balance gate) raises.

    As ``hetu_tpu/models/generation.py:136-159``: ``max_len`` is the KV
    cache's length (default ``s + max_new_tokens``; a prompt and budget
    past it raise :class:`PromptTooLongError`); after a row samples
    ``eos_id`` its later positions hold ``pad_id`` (or ``eos_id`` when
    no ``pad_id`` is given). ``prompt_lens`` (b,) makes the prompts
    RAGGED: row r's prompt is ``input_ids[r, :prompt_lens[r]]``
    (right-padded to s); its first token is sampled at its last real
    position, and its decode writes position ``prompt_lens[r] + t`` under
    its own causal mask, so the pad KV is never attended. The generated
    tokens still fill the trailing ``max_new_tokens`` columns."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, generate was asked "
                         f"for {dev}")
    refuse_batch_coupled(model)
    ids = torch.as_tensor(input_ids, dtype=torch.long, device=model.device)
    if ids.dim() == 1:
        ids = ids[None]
    b, s = ids.shape
    total = max_len or (s + max_new_tokens)
    if s + max_new_tokens > total:
        raise PromptTooLongError(
            prompt_len=s, max_tokens=max_new_tokens, limit=total,
            source="generate KV-cache (max_len)",
            hint="raise max_len or trim the prompt")
    if total > model.cfg.max_positions:
        raise PromptTooLongError(
            prompt_len=s, max_tokens=max_new_tokens,
            limit=model.cfg.max_positions, source="model max_positions",
            hint="the model cannot address positions past its trained "
                 "context window")
    caches = init_kv_caches(model, b, total, cache_dtype)
    knobs = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                 generator=generator)
    fill_id = pad_id if pad_id is not None else eos_id

    def rows(n):
        if lora is None:
            return None
        pages = torch.as_tensor(lora["ids"], device=ids.device)
        return {"ids": pages.view(b, 1).expand(b, n),
                "pages": lora["pages"]}

    pos = torch.arange(s, device=ids.device)[None, :].expand(b, s)
    logits = decode(model, ids, pos, caches, lora=rows(s))
    if prompt_lens is not None:
        # each row decodes from its own length: per-row writes and
        # causal offsets (the dense cache's slot_mask path)
        plens = torch.as_tensor(prompt_lens, dtype=torch.long,
                                device=ids.device).view(b)
        mask = torch.ones(b, dtype=torch.bool, device=ids.device)
        # sample at each row's last REAL position, not at a pad
        last = logits[torch.arange(b, device=ids.device), plens - 1]
    else:
        plens = torch.full((b,), s, dtype=torch.long, device=ids.device)
        mask = None
        last = logits[:, -1]
    seen = [last]
    toks = [_sample(last, **knobs)]
    done = None if eos_id is None else toks[0] == eos_id
    for i in range(max_new_tokens - 1):
        last = decode(model, toks[-1][:, None], (plens + i)[:, None],
                      caches, slot_mask=mask, lora=rows(1))[:, -1]
        seen.append(last)
        nxt = _sample(last, **knobs)
        if eos_id is not None:
            raw = nxt
            nxt = torch.where(done, torch.full_like(raw, fill_id), raw)
            done = done | (raw == eos_id)
        toks.append(nxt)
    out = torch.cat([ids, torch.stack(toks, dim=1)], dim=1)
    if return_logits:
        return out, torch.stack(seen, dim=1)
    return out
