from hetu_tpu_torch.models.convert import (
    grads_from_jax, jax_param_layout, params_from_jax,
)
from hetu_tpu_torch.models.generation import (
    PromptTooLongError, decode, generate, init_kv_caches,
)
from hetu_tpu_torch.models.gpt import GPTBlock, GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.llama import (
    LlamaBlock, LlamaConfig, LlamaLMHeadModel,
)

__all__ = ["GPTBlock", "GPTConfig", "GPTLMHeadModel", "LlamaBlock",
           "LlamaConfig", "LlamaLMHeadModel", "PromptTooLongError",
           "decode", "generate", "grads_from_jax", "init_kv_caches",
           "jax_param_layout", "params_from_jax"]
