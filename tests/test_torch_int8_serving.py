"""The port's ``ServingEngine`` over the int8 KV arena against
``hetu_tpu``'s, on the CPU, for ``LlamaConfig.tiny`` (GQA 4/2, RoPE) and
``GPTConfig.tiny``.

Both engines serve the same weights (a ``hetu_tpu`` tree carried over
with ``params_from_jax``) from ``cache_dtype=int8`` arenas. The JAX
engine runs its packed flash prefill lane (``prefill_attn="flash"``),
the formulation the port runs on every device. Both run in fp32: on the
CPU the JAX engine's ``attn_kernel="auto"`` resolves to the gather
reference, which dequantizes the arena to q's dtype, while the port's
int8 lane dequantizes in fp32 as the TPU kernel does; in fp32 the two
routes agree. The workload has prompts longer than the prefill chunk
(multi-chunk prefill), a shared system prompt whose cached blocks later
requests hit (whole blocks plus a copy-on-write tail), and more requests
than slots. Greedy tokens must be identical to the JAX engine and to
both frameworks' ``generate(cache_dtype=int8)``, and the first-token
logits the engine records equal the port ``generate``'s at atol 1e-5
(fp32, sums in different orders). After one
``max_tokens=1`` request the two arenas agree: codes equal but for ±1 in
at most 0.1% of them (fp32 noise at a rounding boundary; none is seen
at this size), scales at rtol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.models import generate as jax_generate
from hetu_tpu.serving import SamplingParams as JaxSamplingParams
from hetu_tpu.serving import ServingEngine as JaxServingEngine

from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel, generate,
    params_from_jax,
)
from hetu_tpu_torch.serving import (
    KVPool, SamplingParams, ServingEngine,
)

torch.set_num_threads(2)

SLOTS, MAX_LEN, CHUNK, BLOCK, NEW = 3, 64, 8, 8, 6
CODE_FLIP_SHARE = 1e-3
MODELS = {"llama": (JaxLlamaConfig, JaxLlama, LlamaConfig, LlamaLMHeadModel),
          "gpt": (JaxGPTConfig, JaxGPT, GPTConfig, GPTLMHeadModel)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    jcfg_cls, jcls, cfg_cls, cls = MODELS[request.param]
    jmodel = jcls(jcfg_cls.tiny())
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = cfg_cls.tiny()
    model = cls(cfg, device="cpu")
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), cfg), strict=True)
    return jmodel, params, model


def _prompts(vocab):
    rng = np.random.default_rng(3)
    system = rng.integers(1, vocab, 20).tolist()   # 2.5 blocks
    out = [system + rng.integers(1, vocab, n).tolist() for n in (6, 9)]
    out.append(rng.integers(1, vocab, 19).tolist())  # three chunks
    out += [system + rng.integers(1, vocab, n).tolist() for n in (4, 11)]
    out.append(rng.integers(1, vocab, 5).tolist())
    return out


def _jax_engine(jmodel, params):
    return JaxServingEngine(jmodel, params, slots=SLOTS, max_len=MAX_LEN,
                            prefill_chunk=CHUNK, block_size=BLOCK,
                            cache_dtype=jnp.int8, prefill_attn="flash")


def _port_engine(model, **kw):
    return ServingEngine(model, slots=SLOTS, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, block_size=BLOCK,
                         cache_dtype=torch.int8, device="cpu", **kw)


def test_int8_engine_matches_jax_engine_and_generate(pair):
    jmodel, params, model = pair
    prompts = _prompts(model.cfg.vocab_size)
    jax_out = _jax_engine(jmodel, params).generate_many(
        prompts, JaxSamplingParams(max_tokens=NEW))
    eng = _port_engine(model, record_first_logits=True)
    assert eng.pool.quantized and len(eng.pool.caches) == 4
    reqs = [eng.submit(p, SamplingParams(max_tokens=NEW)) for p in prompts]
    eng.run_until_drained()
    got = [list(r.tokens) for r in reqs]
    assert got == jax_out
    # the workload really exercised the prefix cache and its CoW tail
    hits = [r.cached_tokens for r in reqs]
    assert any(h >= 2 * BLOCK for h in hits)
    assert any(h % BLOCK for h in hits)
    assert eng.lane_iters["prefill"] > 0 and eng.lane_iters["decode"] > 0
    for p, toks in zip(prompts, got):
        want = np.asarray(jax_generate(
            jmodel, params, jnp.asarray([p], jnp.int32), max_new_tokens=NEW,
            cache_dtype=jnp.int8))[0, len(p):].tolist()
        assert toks == want
    for r, p, toks in zip(reqs, prompts, got):
        mine, logits = generate(model, [p], max_new_tokens=NEW,
                                device="cpu", cache_dtype=torch.int8,
                                return_logits=True)
        assert mine[0, len(p):].tolist() == toks
        # the logits the engine sampled the first token from (fp32)
        np.testing.assert_allclose(r.first_logits.numpy(),
                                   logits[0, 0].numpy(), atol=1e-5)
    # arrival order and slot assignment change no request's tokens
    order = [5, 2, 4, 0, 3, 1]
    out = _port_engine(model).generate_many(
        [prompts[i] for i in order], SamplingParams(max_tokens=NEW))
    assert [out[order.index(i)] for i in range(len(prompts))] == jax_out


def test_int8_prefill_arena_matches_jax(pair):
    """A lone ``max_tokens=1`` request writes only prefill rows (two
    chunks and a partial one): the two int8 arenas (same block ids, same
    layout) agree."""
    jmodel, params, model = pair
    prompt = _prompts(model.cfg.vocab_size)[2]
    je = _jax_engine(jmodel, params)
    want = je.generate_many([prompt], JaxSamplingParams(max_tokens=1))
    pe = _port_engine(model)
    assert pe.generate_many([prompt], SamplingParams(max_tokens=1)) == want
    flips = total = 0
    for i, (a, t) in enumerate(zip(je.pool.caches, pe.pool.caches)):
        a = np.asarray(a)
        assert t.shape == a.shape and t.numpy().dtype == a.dtype
        if i % 2 == 0:
            diff = np.abs(t.numpy().astype(np.int32) - a.astype(np.int32))
            assert diff.max() <= 1
            flips += int((diff > 0).sum())
            total += diff.size
        else:
            np.testing.assert_allclose(t.numpy(), a, rtol=1e-5, atol=0)
    assert flips <= CODE_FLIP_SHARE * total
    # the prompt's rows were written: nonzero codes and scales
    assert int(torch.count_nonzero(pe.pool.caches[0])) > 0
    assert int(torch.count_nonzero(pe.pool.caches[1])) > 0


def test_int8_pool_layout(pair):
    _, _, model = pair
    pool = KVPool(model, 2, 32, 8, torch.int8)
    attn = model.blocks.block.attn
    shape = (model.cfg.num_layers, pool.n_blocks, 8, attn.num_kv_heads,
             attn.head_dim)
    assert pool.quantized and pool.cache_dtype == torch.int8
    assert [tuple(c.shape) for c in pool.caches] \
        == [shape, shape[:-1] + (1,)] * 2
    assert [c.dtype for c in pool.caches] \
        == [torch.int8, torch.float32] * 2
    n = int(np.prod(shape))
    assert pool.nbytes() == 2 * n + 2 * 4 * (n // attn.head_dim)
    fp = KVPool(model, 2, 32, 8)
    assert not fp.quantized and fp.cache_dtype == model.dtype
    assert fp.nbytes() == 2 * 4 * n
