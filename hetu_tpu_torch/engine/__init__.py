from hetu_tpu_torch.engine.sft_trainer import (
    SFTTrainer, make_sft_batch, sft_batches,
)
from hetu_tpu_torch.engine.state import TrainState
from hetu_tpu_torch.engine.train_step import (
    TrainPlan, build_eval_step, build_train_step, default_loss_fn,
    init_state, make_plan, model_dropout_active, record_trace,
    reset_trace_counts, step_dropout_seed, trace_counts,
)
from hetu_tpu_torch.engine.trainer import Trainer, TrainerConfig

__all__ = ["SFTTrainer", "TrainPlan", "TrainState", "Trainer",
           "TrainerConfig", "build_eval_step", "build_train_step",
           "default_loss_fn", "init_state", "make_plan", "make_sft_batch",
           "model_dropout_active", "record_trace", "reset_trace_counts",
           "sft_batches", "step_dropout_seed", "trace_counts"]
