"""Per-slot sampling for the serving engine (counterparts of
``hetu_tpu/serving/speculative.py:57 adjust_logits`` and
``hetu_tpu/serving/engine.py:110 sample_slots``).

Greedy is an argmax. A sampled draw is one categorical sample from the
masked softmax, taken from the request's own ``torch.Generator`` — so a
request replays exactly from its seed, whatever else shares the batch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def adjust_logits(logits, temperature, top_k, top_p):
    """Temperature / top-k / top-p masking of ``logits`` (..., V); returns
    the scaled logits with dropped entries at ``-inf``. Knobs are scalars
    or arrays broadcastable against the leading dims. Top-k keeps values
    >= the k-th largest; nucleus keeps the smallest prefix of the sorted
    distribution whose prior mass is < top_p (the top token always
    survives); ``top_k <= 0`` / ``top_p`` outside (0, 1) switch them off."""
    dev = logits.device
    V = logits.shape[-1]
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.long, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits / t[..., None].to(logits.dtype)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kidx = torch.clamp(top_k - 1, 0, V - 1)[..., None].expand(
        scaled.shape[:-1] + (1,))
    kth = torch.gather(sorted_desc, -1, kidx)
    no_k = (top_k <= 0)[..., None]
    neg_inf = torch.full_like(scaled, float("-inf"))
    masked = torch.where(no_k | (scaled >= kth), scaled, neg_inf)
    sd = torch.where(no_k | (sorted_desc >= kth), sorted_desc, neg_inf)
    probs = torch.softmax(sd, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[..., None]
    cutoff = torch.where(keep, sd, torch.full_like(sd, float("inf"))).amin(
        dim=-1, keepdim=True)
    use_p = ((top_p > 0) & (top_p < 1))[..., None]
    return torch.where(use_p & (masked < cutoff), neg_inf, masked)


def sample_slots(logits, temperature: np.ndarray, top_k: np.ndarray,
                 top_p: np.ndarray,
                 generators: Sequence) -> np.ndarray:
    """(S, V) logits + per-row host knobs → (S,) int64 tokens on the host.
    Rows with temperature 0 take the argmax; the others draw one sample
    each from their own generator (``generators[i]``)."""
    toks = logits.argmax(dim=-1)
    sampled = np.nonzero(np.asarray(temperature) > 0)[0]
    for i in sampled:
        probs = torch.softmax(adjust_logits(
            logits[i], float(temperature[i]), int(top_k[i]),
            float(top_p[i])), dim=-1)
        toks[i] = torch.multinomial(probs, 1, generator=generators[i])[0]
    return toks.cpu().numpy()
