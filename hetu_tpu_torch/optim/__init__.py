from hetu_tpu_torch.optim.clipping import clip_by_global_norm, global_norm
from hetu_tpu_torch.optim.optimizers import (
    OptimizerSpec, adam, adamw, chain, jax_decay_mask, masked, sgd,
)
from hetu_tpu_torch.optim.schedules import constant, cosine_decay, \
    linear_warmup

__all__ = ["OptimizerSpec", "adam", "adamw", "chain",
           "clip_by_global_norm", "constant", "cosine_decay", "global_norm",
           "jax_decay_mask", "linear_warmup", "masked", "sgd"]
