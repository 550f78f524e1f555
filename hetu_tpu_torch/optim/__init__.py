from hetu_tpu_torch.optim.clipping import clip_by_global_norm, global_norm
from hetu_tpu_torch.optim.optimizers import (
    OptimizerSpec, StagedOptimizer, adafactor, adagrad, adam, adamw, chain,
    jax_decay_mask, masked, sgd,
)
from hetu_tpu_torch.optim.scaler import (
    ScalerState, init_scaler, scale_loss, unscale_and_check, update_scaler,
)
from hetu_tpu_torch.optim.schedules import (
    constant, cosine_decay, inverse_sqrt, linear_decay, linear_warmup,
    wd_increment,
)

__all__ = ["OptimizerSpec", "ScalerState", "StagedOptimizer", "adafactor",
           "adagrad", "adam", "adamw", "chain", "clip_by_global_norm",
           "constant", "cosine_decay", "global_norm", "init_scaler",
           "inverse_sqrt", "jax_decay_mask", "linear_decay", "linear_warmup",
           "masked", "scale_loss", "sgd", "unscale_and_check",
           "update_scaler", "wd_increment"]
