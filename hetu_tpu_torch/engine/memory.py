"""The serving plane's byte ledger: KV-pool and spill-arena sizing, and the
device's own memory counters (counterpart of ``hetu_tpu/engine/memory.py``
``:303-575``, the serving part: the KV pool, the spill arena and the
adapter arena).

The serving engine's admission control is a BYTES question — how many
fixed-shape KV slots fit next to the weights — and this ledger is the
one place that arithmetic lives. It is ``hetu_tpu``'s arithmetic,
unchanged, so both packages size the same arena from the same budget:

- the weights are ``param_bytes_per_el`` (default 4) bytes a parameter
  of the analytic count :func:`model_params` (``vocab x hidden`` counted
  once, so an untied head is left out), whatever dtype the model holds;
- a KV block costs :func:`kv_bytes_per_block`: K and V in the cache
  dtype, plus the int8 arena's fp32 scale per (position, kv head).

The card's real footprint differs (bf16 weights weigh half, the engine's
captured lanes hold graph pools the ledger does not price);
:func:`device_peak_bytes` reads it.
"""

from __future__ import annotations

from typing import Optional

import torch

from hetu_tpu_torch import resolve_device

#: bytes per KV element by cache dtype: fp32/bf16 dense caches, int8 =
#: 1 byte/elem + per-(position, head) fp32 scales amortized over
#: head_dim (``generation.init_kv_caches`` quantized layout)
KV_CACHE_BYTES_PER_EL = {"fp32": 4.0, "bf16": 2.0, "int8": 1.0}


def model_params(cfg) -> float:
    """The analytic parameter count the ledger prices weights with: every
    block's attention and (dense or expert) MLP, plus ``vocab x hidden``
    once (``hetu_tpu/tools/galvatron/cost_model.py:134-182``
    ``ModelDims.total_params``). A gated MLP (intermediate != 4 x hidden)
    counts three matrices, an ungated one two; every expert counts."""
    h = cfg.hidden_size
    heads = cfg.num_heads
    kv_heads = getattr(cfg, "num_kv_heads", None) or heads
    inter = getattr(cfg, "intermediate_size",
                    getattr(cfg, "mlp_ratio", 4) * h)
    hd = h // heads
    attn = h * (heads * hd + 2 * kv_heads * hd) + heads * hd * h
    mlp = 3 * h * inter if inter != 4 * h else 2 * h * inter
    if getattr(cfg, "num_experts", 0) > 0:
        mlp *= cfg.num_experts
    return cfg.num_layers * (attn + mlp) + cfg.vocab_size * h


def kv_bytes_per_block(cfg, *, block_size: int,
                       cache_dtype: str = "fp32", tp: int = 1) -> float:
    """Bytes of one ``block_size``-token K+V page across every layer —
    the allocation unit of the paged serving pool (the scheduler's
    free-block admission gate prices requests in these)."""
    if cache_dtype not in KV_CACHE_BYTES_PER_EL:
        raise ValueError(f"cache_dtype must be one of "
                         f"{sorted(KV_CACHE_BYTES_PER_EL)}, "
                         f"got {cache_dtype!r}")
    hkv = getattr(cfg, "num_kv_heads", None) or cfg.num_heads
    d = getattr(cfg, "head_dim", None) or cfg.hidden_size // cfg.num_heads
    rows = cfg.num_layers * block_size * (hkv / max(tp, 1))
    per_el = KV_CACHE_BYTES_PER_EL[cache_dtype]
    bytes_kv = 2.0 * rows * d * per_el          # K and V
    if cache_dtype == "int8":
        bytes_kv += 2.0 * rows * 4.0            # fp32 row scales
    return bytes_kv


def kv_bytes_per_slot(cfg, *, max_len: int, cache_dtype: str = "fp32",
                      tp: int = 1) -> float:
    """Per-slot bytes of one request's worst-case K+V rows across every
    layer — a ``max_len``-token page."""
    return kv_bytes_per_block(cfg, block_size=max_len,
                              cache_dtype=cache_dtype, tp=tp)


def size_kv_blocks(cfg, *, hbm_budget_bytes: float, block_size: int,
                   cache_dtype: str = "fp32", tp: int = 1,
                   param_bytes_per_el: float = 4.0,
                   headroom: float = 0.1) -> int:
    """How many KV blocks fit in ``hbm_budget_bytes`` next to the
    weights (``param_bytes_per_el`` per parameter, sharded over tp).

    Raises ``ValueError`` when not even one block fits — the caller
    must shrink ``block_size``, quantize the cache, or raise tp."""
    weights = model_params(cfg) * param_bytes_per_el / max(tp, 1)
    avail = hbm_budget_bytes * (1.0 - headroom) - weights
    per_block = kv_bytes_per_block(cfg, block_size=block_size,
                                   cache_dtype=cache_dtype, tp=tp)
    blocks = int(avail // per_block)
    if blocks < 1:
        raise ValueError(
            f"KV pool does not fit: weights {weights / 1e9:.2f}GB + one "
            f"{per_block / 1e6:.1f}MB block exceed the "
            f"{hbm_budget_bytes / 1e9:.2f}GB budget — shrink the "
            f"block/slot size, use an int8 cache, or raise tp")
    return blocks


def size_spill_arena(cfg, *, host_budget_bytes: float, block_size: int,
                     cache_dtype: str = "fp32", tp: int = 1) -> int:
    """How many KV blocks the host spill arena may park in
    ``host_budget_bytes`` of host memory: the same
    :func:`kv_bytes_per_block` the device pool allocates with (no
    weights term — the host holds only KV). Raises when not even one
    block fits."""
    per_block = kv_bytes_per_block(cfg, block_size=block_size,
                                   cache_dtype=cache_dtype, tp=tp)
    blocks = int(float(host_budget_bytes) // per_block)
    if blocks < 1:
        raise ValueError(
            f"spill arena does not fit: one {per_block / 1e6:.1f}MB "
            f"block exceeds the {host_budget_bytes / 1e6:.1f}MB host "
            f"budget — raise the budget or shrink block_size")
    return blocks


def size_kv_pool(cfg, *, hbm_budget_bytes: float, max_len: int,
                 cache_dtype: str = "fp32", tp: int = 1,
                 param_bytes_per_el: float = 4.0,
                 headroom: float = 0.1) -> int:
    """How many serving slots fit in ``hbm_budget_bytes`` next to the
    weights — :func:`size_kv_blocks` with one ``max_len``-token block
    per slot."""
    return size_kv_blocks(cfg, hbm_budget_bytes=hbm_budget_bytes,
                          block_size=max_len, cache_dtype=cache_dtype,
                          tp=tp, param_bytes_per_el=param_bytes_per_el,
                          headroom=headroom)


def size_adapter_arena(cfg, *, r: int, max_adapters: int,
                       dtype_bytes: float = 4.0) -> int:
    """Device bytes of the multi-tenant LoRA adapter arena
    (``serving/tenancy.py``): per layer and per arena page, an
    ``(in, r)`` A plus an ``(r, out)`` B for every adapter-targetable
    projection — q/k/v/out always, plus the dense FFN matrices
    (gated gate/up/down when the config carries ``intermediate_size``,
    GPT fc_in/fc_out otherwise; MoE expert weights are not adapter
    targets, so MoE FFNs price zero). The serving engine subtracts it
    from ``hbm_budget_bytes`` before sizing the KV pool."""
    L = int(cfg.num_layers)
    E = int(cfg.hidden_size)
    heads = int(cfg.num_heads)
    hd = int(getattr(cfg, "head_dim", None) or E // heads)
    kvh = int(getattr(cfg, "num_kv_heads", None) or heads)
    q_out, kv_out = heads * hd, kvh * hd
    dims = [(E, q_out), (E, kv_out), (E, kv_out), (q_out, E)]
    if getattr(cfg, "num_experts", 0) <= 0:
        inter = getattr(cfg, "intermediate_size", None)
        if inter is not None:
            dims += [(E, int(inter)), (E, int(inter)), (int(inter), E)]
        else:
            hidden = int(getattr(cfg, "mlp_ratio", 4)) * E
            dims += [(E, hidden), (hidden, E)]
    per_page = sum((i + o) * int(r) for i, o in dims) * L
    return int(per_page * int(max_adapters) * float(dtype_bytes))


# -- the device's own counters ------------------------------------------------


def reset_memory_stats(device=None) -> None:
    """Restart the peak counter :func:`device_peak_bytes` reads (a no-op
    on the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def device_peak_bytes(device=None) -> Optional[int]:
    """The allocator's peak allocation on a CUDA ``device`` since the last
    :func:`reset_memory_stats` (``torch.cuda.max_memory_allocated``);
    None on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(dev))


__all__ = ["KV_CACHE_BYTES_PER_EL", "device_peak_bytes",
           "kv_bytes_per_block", "kv_bytes_per_slot", "model_params",
           "reset_memory_stats", "size_kv_blocks", "size_kv_pool",
           "size_spill_arena"]
