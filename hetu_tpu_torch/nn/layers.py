"""Basic layers (counterpart of ``hetu_tpu/nn/layers.py``): ``Embedding``,
``LayerNorm`` and ``RMSNorm`` as ``nn.Module``s.

Parameter names follow ``hetu_tpu``'s flattened keys (``weight``;
``scale``/``bias`` for norms) so a converted ``hetu_tpu`` tree loads with
``load_state_dict``. Initial values come from the model constructor.
Both return the policy's compute dtype (``core/dtypes.py``): the lookup
and the norm's statistics run in the param dtype and fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hetu_tpu_torch.core.dtypes import current_policy
from hetu_tpu_torch.ops.normalization import layer_norm, rms_norm


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, features, device=device, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(
            current_policy().compute_dtype)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.features = features
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device,
                                             dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, eps=self.eps).to(
            current_policy().compute_dtype)


class RMSNorm(nn.Module):
    """RMSNorm with fp32 statistics (``hetu_tpu/nn/layers.py:86``); the
    default eps is the class's 1e-6, models pass their config's."""

    def __init__(self, features: int, eps: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.features = features
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, eps=self.eps).to(
            current_policy().compute_dtype)
