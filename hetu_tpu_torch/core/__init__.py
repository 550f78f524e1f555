from hetu_tpu_torch.core.bits import fmix32, mul32
from hetu_tpu_torch.core.dtypes import (
    BF16_COMPUTE, BF16_FULL, FP32, Policy, autocast, current_policy,
)

__all__ = ["BF16_COMPUTE", "BF16_FULL", "FP32", "Policy", "autocast",
           "current_policy", "fmix32", "mul32"]
