from hetu_tpu_torch.models.convert import params_from_jax
from hetu_tpu_torch.models.generation import (
    PromptTooLongError, decode, generate, init_kv_caches,
)
from hetu_tpu_torch.models.gpt import GPTBlock, GPTConfig, GPTLMHeadModel

__all__ = ["GPTBlock", "GPTConfig", "GPTLMHeadModel", "PromptTooLongError",
           "decode", "generate", "init_kv_caches", "params_from_jax"]
