"""Parameter-efficient fine-tuning (counterpart of ``hetu_tpu/peft``):
LoRA config, layer, injection, migration, trainable mask and merge."""

from hetu_tpu_torch.peft.lora import (
    LoraConfig, LoraLinear, inject_lora, lora_trainable_mask, merge_lora,
    wrap_params_for_lora,
)

__all__ = ["LoraConfig", "LoraLinear", "inject_lora", "lora_trainable_mask",
           "merge_lora", "wrap_params_for_lora"]
