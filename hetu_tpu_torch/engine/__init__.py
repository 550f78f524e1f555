from hetu_tpu_torch.engine.sft_trainer import (
    SFTTrainer, make_sft_batch, sft_batches,
)
from hetu_tpu_torch.engine.state import TrainState
from hetu_tpu_torch.engine.step_graph import (
    StepGraph, record_trace, reset_trace_counts, trace_counts, trace_total,
)
from hetu_tpu_torch.engine.train_step import (
    CachedStep, GraphPool, StepCache, TrainPlan, build_eval_step,
    build_grad_accum_steps, build_train_step, compile_strategy,
    default_loss_fn, get_step_cache, init_state, make_plan,
    model_dropout_active, step_dropout_seed,
)
from hetu_tpu_torch.engine.trainer import Trainer, TrainerConfig

__all__ = ["CachedStep", "GraphPool", "SFTTrainer", "StepCache", "StepGraph",
           "TrainPlan", "TrainState", "Trainer", "TrainerConfig",
           "build_eval_step", "build_grad_accum_steps", "build_train_step",
           "compile_strategy", "default_loss_fn", "get_step_cache",
           "init_state", "make_plan", "make_sft_batch",
           "model_dropout_active", "record_trace", "reset_trace_counts",
           "sft_batches", "step_dropout_seed", "trace_counts",
           "trace_total"]
