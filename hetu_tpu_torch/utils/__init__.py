"""Utilities (counterpart of ``hetu_tpu/utils/``): checkpoints."""

from hetu_tpu_torch.utils.checkpoint import (
    CheckpointWriter, load_checkpoint, load_tensors, save_checkpoint,
    save_tensors,
)

__all__ = ["CheckpointWriter", "load_checkpoint", "load_tensors",
           "save_checkpoint", "save_tensors"]
