"""The port's ``ServingEngine`` against ``hetu_tpu``'s, on the CPU.

Both engines serve ``GPTConfig.tiny`` on the same weights (a ``hetu_tpu``
tree carried over with ``params_from_jax``). The JAX engine runs its
packed flash prefill lane (``prefill_attn="flash"``), the formulation the
port runs on every device. The workload has prompts longer than the
prefill chunk (multi-chunk prefill), a shared system prompt whose cached
blocks later requests hit (whole blocks plus a copy-on-write tail), and
more requests than slots (slot churn), served in two arrival orders.
Greedy tokens must be identical to the JAX engine and to JAX
``generate``; after one ``max_tokens=1`` request the two arenas agree at
atol 1e-6 (fp32, sums in different orders).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import generate as jax_generate
from hetu_tpu.serving import SamplingParams as JaxSamplingParams
from hetu_tpu.serving import ServingEngine as JaxServingEngine

from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, generate, params_from_jax,
)
from hetu_tpu_torch.serving import SamplingParams, ServingEngine

torch.set_num_threads(2)

SLOTS, MAX_LEN, CHUNK, BLOCK, NEW = 3, 64, 8, 8, 6


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxGPT(JaxGPTConfig.tiny())
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = GPTConfig.tiny()
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), cfg))
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
                            prefill_attn="flash")


def _port_engine(model):
    return ServingEngine(model, slots=SLOTS, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, block_size=BLOCK,
                         device="cpu")


@pytest.fixture(scope="module")
def served(pair):
    jmodel, params, model = pair
    prompts = _prompts(model.cfg.vocab_size)
    jax_out = _jax_engine(jmodel, params).generate_many(
        prompts, JaxSamplingParams(max_tokens=NEW))
    return prompts, jax_out


def test_engine_matches_jax_engine_and_generate(pair, served):
    jmodel, params, model = pair
    prompts, jax_out = served
    eng = _port_engine(model)
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
            jmodel, params, jnp.asarray([p], jnp.int32),
            max_new_tokens=NEW))[0, len(p):].tolist()
        assert toks == want
        mine = generate(model, [p], max_new_tokens=NEW, device="cpu")
        assert mine[0, len(p):].tolist() == toks


def test_engine_arrival_order_does_not_change_tokens(pair, served):
    _, _, model = pair
    prompts, jax_out = served
    order = [5, 2, 4, 0, 3, 1]
    out = _port_engine(model).generate_many(
        [prompts[i] for i in order], SamplingParams(max_tokens=NEW))
    assert [out[order.index(i)] for i in range(len(prompts))] == jax_out


def test_engine_sampled_request_replays_from_its_seed(pair):
    _, _, model = pair
    prompt = list(range(1, 14))
    sp = SamplingParams(max_tokens=5, temperature=0.9, top_k=30, seed=11)
    a = _port_engine(model).generate_many([prompt, prompt[:6]], sp)
    b = _port_engine(model).generate_many([prompt[:6], prompt], sp)
    assert a[0] == b[1] and a[1] == b[0]


def test_prefill_arena_matches_jax(pair):
    """A lone ``max_tokens=1`` request writes only prefill rows: the two
    engines' arenas (same block ids, same layout) agree to fp noise."""
    jmodel, params, model = pair
    prompt = _prompts(model.cfg.vocab_size)[2]
    je = _jax_engine(jmodel, params)
    je.generate_many([prompt], JaxSamplingParams(max_tokens=1))
    pe = _port_engine(model)
    pe.generate_many([prompt], SamplingParams(max_tokens=1))
    for a, t in zip(je.pool.caches, pe.pool.caches):
        assert t.shape == a.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-6)
    assert float(torch.count_nonzero(pe.pool.caches[0])) > 0
