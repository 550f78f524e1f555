"""The port's serving byte ledger (``hetu_tpu_torch/engine/memory.py``) and
budget-sized arenas against ``hetu_tpu``'s, on the CPU.

Every sizing function must return exactly what ``hetu_tpu/engine/memory.py``
returns (the same float or int, and the same error when nothing fits) over
GPT tiny/small, Llama-7B and GPT-MoE 8-expert, every cache dtype and
several budgets; ``KVPool.sized_for`` and ``ServingEngine(slots=None,
hbm_budget_bytes=...)`` must build JAX's slot and block counts, and the
arena's bytes must equal the ledger's price to the byte.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.engine import memory as jax_memory
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.serving import ServingEngine as JaxServingEngine
from hetu_tpu.serving.kv_pool import KVPool as JaxKVPool
from hetu_tpu.tools.galvatron.cost_model import ModelDims

from hetu_tpu_torch.engine import memory
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel,
)
from hetu_tpu_torch.serving import KVPool, ServingEngine
from hetu_tpu_torch.serving.kv_pool import cache_dtype_name

torch.set_num_threads(2)

CONFIGS = {
    "gpt_tiny": (GPTConfig.tiny, JaxGPTConfig.tiny),
    "gpt_small": (GPTConfig.small, JaxGPTConfig.small),
    "llama_7b": (LlamaConfig.llama_7b, JaxLlamaConfig.llama_7b),
    "moe_8e": (GPTConfig.moe_8e, JaxGPTConfig.moe_8e),
}
DTYPES = ("fp32", "bf16", "int8")
TORCH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8}
JAX_DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}


def _same(fn, jax_fn, **kw):
    """Both functions return the same value, or raise the same error."""
    try:
        want = jax_fn(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn(**kw)
        assert str(got.value) == str(e)
        return None
    got = fn(**kw)
    assert type(got) is type(want) and got == want, (kw, got, want)
    return got


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_count_matches_cost_model(name):
    cfg, jcfg = (f() for f in CONFIGS[name])
    want = ModelDims.from_config(jcfg, seq_len=16,
                                 global_batch=1).total_params()
    assert memory.model_params(cfg) == want
    if name == "llama_7b":
        # vocab x hidden once: Llama's untied head is not counted
        assert want == 6_607_077_376


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kv_prices_match_jax(name, dtype):
    cfg, jcfg = (f() for f in CONFIGS[name])
    for bs in (1, 16, 2048):
        for tp in (1, 2):
            assert memory.kv_bytes_per_block(
                cfg, block_size=bs, cache_dtype=dtype, tp=tp) \
                == jax_memory.kv_bytes_per_block(
                    jcfg, block_size=bs, cache_dtype=dtype, tp=tp)
    for max_len in (512, 2048):
        for tp in (1, 2):
            assert memory.kv_bytes_per_slot(
                cfg, max_len=max_len, cache_dtype=dtype, tp=tp) \
                == jax_memory.kv_bytes_per_slot(
                    jcfg, max_len=max_len, cache_dtype=dtype, tp=tp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sizing_matches_jax(name, dtype):
    cfg, jcfg = (f() for f in CONFIGS[name])
    weights = memory.model_params(cfg) * 4.0
    slot = memory.kv_bytes_per_slot(cfg, max_len=2048, cache_dtype=dtype)
    # nothing fits, one slot, a few, many; then a tight host budget
    budgets = [weights, (weights + 1.5 * slot) / 0.9,
               (weights + 7.2 * slot) / 0.9, 40e9, 80e9]
    sizes = []
    for budget in budgets:
        for headroom in (0.1, 0.0):
            sizes.append(_same(
                lambda c, **kw: memory.size_kv_pool(cfg, **kw),
                lambda c, **kw: jax_memory.size_kv_pool(jcfg, **kw),
                c=None, hbm_budget_bytes=budget, max_len=2048,
                cache_dtype=dtype, headroom=headroom))
            _same(lambda c, **kw: memory.size_kv_blocks(cfg, **kw),
                  lambda c, **kw: jax_memory.size_kv_blocks(jcfg, **kw),
                  c=None, hbm_budget_bytes=budget, block_size=16,
                  cache_dtype=dtype, headroom=headroom,
                  param_bytes_per_el=2.0)
    assert sizes[0] is None and sizes[2] == 1      # the error, one slot
    block = memory.kv_bytes_per_block(cfg, block_size=16, cache_dtype=dtype)
    for host in (block / 2, 1.5 * block, 10.5 * block, 4e9):
        for bs in (16, 2048):
            _same(lambda c, **kw: memory.size_spill_arena(cfg, **kw),
                  lambda c, **kw: jax_memory.size_spill_arena(jcfg, **kw),
                  c=None, host_budget_bytes=host, block_size=bs,
                  cache_dtype=dtype)


def test_bad_arguments_raise_as_jax():
    cfg, jcfg = GPTConfig.tiny(), JaxGPTConfig.tiny()
    _same(lambda **kw: memory.kv_bytes_per_block(cfg, **kw),
          lambda **kw: jax_memory.kv_bytes_per_block(jcfg, **kw),
          block_size=16, cache_dtype="fp8")
    _same(lambda **kw: memory.size_kv_pool(cfg, **kw),
          lambda **kw: jax_memory.size_kv_pool(jcfg, **kw),
          hbm_budget_bytes=1e9, max_len=32, cache_dtype="fp16")


def test_llama_7b_budget_gives_seventeen_int8_slots():
    """The card's sizing cell: 40e9 bytes of budget, max_len 2048, int8."""
    cfg = LlamaConfig.llama_7b()
    assert memory.kv_bytes_per_slot(cfg, max_len=2048,
                                    cache_dtype="int8") == 553_648_128
    assert memory.kv_bytes_per_block(cfg, block_size=16,
                                     cache_dtype="int8") == 4_325_376
    assert memory.size_kv_pool(cfg, hbm_budget_bytes=40e9, max_len=2048,
                               cache_dtype="int8") == 17


def test_device_counters_are_none_on_the_cpu():
    assert memory.device_peak_bytes("cpu") is None
    memory.reset_memory_stats("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            memory.device_peak_bytes()


@pytest.fixture(scope="module")
def tiny_models():
    gpt = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    llama = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    return {"gpt": (gpt, JaxGPT(JaxGPTConfig.tiny())),
            "llama": (llama, JaxLlama(JaxLlamaConfig.tiny()))}


def _budget(model, slots, max_len, dtype):
    """A budget that holds ``slots`` and a half worst-case slots."""
    cfg = model.cfg
    per = memory.kv_bytes_per_slot(cfg, max_len=max_len, cache_dtype=dtype)
    return (memory.model_params(cfg) * 4.0 + (slots + 0.5) * per) / 0.9


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_sized_pool_matches_jax_to_the_byte(tiny_models, name, dtype):
    model, jmodel = tiny_models[name]
    budget = _budget(model, 3, 32, dtype)
    for bs in (8, None):
        pool = KVPool.sized_for(model, hbm_budget_bytes=budget, max_len=32,
                                cache_dtype=TORCH_DTYPES[dtype],
                                block_size=bs)
        want = JaxKVPool.sized_for(jmodel, hbm_budget_bytes=budget,
                                   max_len=32,
                                   cache_dtype=JAX_DTYPES[dtype],
                                   block_size=bs)
        assert (pool.slots, pool.n_blocks, pool.block_size,
                pool.table_width) == (want.slots, want.n_blocks,
                                      want.block_size, want.table_width)
        assert pool.nbytes() == want.nbytes()
        assert pool.nbytes() == pool.n_blocks * memory.kv_bytes_per_block(
            model.cfg, block_size=pool.block_size, cache_dtype=dtype)
        assert cache_dtype_name(pool.cache_dtype) == dtype
    assert KVPool.sized_for(model, hbm_budget_bytes=budget, max_len=32,
                            cache_dtype=TORCH_DTYPES[dtype]).slots == 3


@pytest.mark.parametrize("kw", [
    dict(hbm_budget_bytes="budget"),
    dict(hbm_budget_bytes="budget", block_size=16),
    dict(slots=4, kv_blocks=9, block_size=8),
    dict(slots=3, hbm_budget_bytes=1.0),       # slots win over a budget
])
def test_engine_arena_sizing_matches_jax(tiny_models, kw):
    model, jmodel = tiny_models["gpt"]
    budget = _budget(model, 3, 32, "fp32")
    kw = {k: budget if v == "budget" else v for k, v in kw.items()}
    jparams = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    want = JaxServingEngine(jmodel, jparams, max_len=32, prefill_chunk=8,
                            **kw).pool
    eng = ServingEngine(model, max_len=32, prefill_chunk=8, device="cpu",
                        **kw)
    got = eng.pool
    assert (got.slots, got.n_blocks, got.block_size) \
        == (want.slots, want.n_blocks, want.block_size)
    assert got.nbytes() == want.nbytes()
    assert eng.scheduler.slots == got.slots
    assert eng.blocks.n_blocks == got.n_blocks


def test_engine_sizing_errors_match_jax(tiny_models):
    model, jmodel = tiny_models["gpt"]
    jparams = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    for kw in (dict(), dict(hbm_budget_bytes=1e9, kv_blocks=9),
               dict(slots=2, kv_blocks=4, block_size=8),
               dict(hbm_budget_bytes=1.0)):
        with pytest.raises(ValueError) as want:
            JaxServingEngine(jmodel, jparams, max_len=32, **kw)
        with pytest.raises(ValueError) as got:
            ServingEngine(model, max_len=32, device="cpu", **kw)
        assert str(got.value) == str(want.value)
