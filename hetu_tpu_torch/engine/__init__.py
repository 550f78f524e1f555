from hetu_tpu_torch.engine.state import TrainState
from hetu_tpu_torch.engine.train_step import (
    TrainPlan, build_train_step, default_loss_fn, init_state, make_plan,
    model_dropout_active, record_trace, reset_trace_counts,
    step_dropout_seed, trace_counts,
)

__all__ = ["TrainPlan", "TrainState", "build_train_step", "default_loss_fn",
           "init_state", "make_plan", "model_dropout_active",
           "record_trace", "reset_trace_counts", "step_dropout_seed",
           "trace_counts"]
