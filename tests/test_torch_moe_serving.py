"""MoE decoding in the port (``MoEMLP.decode``, ``generate`` and the
``ServingEngine``'s captured lanes) against ``hetu_tpu``'s, on the CPU.

The twins of ``tests/test_moe_plane.py:375-430``: the decode lane
against the dense combine, the balance gate's refusal, and greedy
serving of ``GPTConfig.tiny_moe`` equal to ``hetu_tpu``'s one-shot
``generate``, with one capture a lane through request churn. Params come
from a ``hetu_tpu`` tree through ``params_from_jax``; prompts from numpy
with a seed.

Tolerances: the decode lane against the dense forward (the same
products, gathered), and against ``hetu_tpu``'s decode, 1e-5 in fp32;
generated tokens exactly equal.
"""

import dataclasses
import warnings

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
from hetu_tpu.nn import moe as jmoe

from hetu_tpu_torch.engine import trace_counts
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel, generate,
    params_from_jax,
)
from hetu_tpu_torch.models import convert
from hetu_tpu_torch.nn import moe
from hetu_tpu_torch.serving import SamplingParams, ServingEngine

torch.set_num_threads(2)

NEW = 6
LANES = {"decode": "serving_decode", "prefill": "serving_prefill"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("gate", ("topk", "ktop1", "sam"))
@pytest.mark.parametrize("gated", (False, True), ids=("gelu", "swiglu"))
def test_moe_decode_matches_dense_combine_and_jax(gated, gate):
    """``MoEMLP.decode`` (the k chosen experts through gathered weight
    slices) computes the dense forward's ``Σ_j w_j·expert_j(x)``, and
    ``hetu_tpu``'s decode on the same params and rows."""
    kw = {"num_groups": 2} if gate == "sam" else None
    jm = jmoe.MoEMLP(8, 16, num_experts=4, k=2, gated=gated,
                     gate_type=gate, gate_kwargs=kw)
    params = jm.init(jax.random.key(0), dtype=jnp.float32)
    pm = moe.MoEMLP(8, 16, num_experts=4, k=2, gated=gated,
                    gate_type=gate, gate_kwargs=kw)
    pm.load_state_dict({k: _t(v) for k, v in
                        convert._flatten(_np_tree(params)).items()})
    x = np.random.default_rng(2).normal(size=(2, 5, 8)).astype(np.float32)
    with torch.no_grad():
        dense, _ = pm(_t(x))
        out = pm.decode(_t(x))
    assert out.shape == (2, 5, 8) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jm.decode(params, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


def test_balance_gate_refuses_to_decode_before_any_capture():
    """The balance gate routes over the whole co-batched row set:
    ``MoEMLP.decode``, ``generate`` and the ``ServingEngine`` refuse it,
    naming the gate, and the engine refuses before capturing a lane (as
    ``hetu_tpu``'s decode refuses it, ``test_moe_plane.py:388``)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        layer = moe.MoEMLP(8, 16, 4, gate_type="balance")
        model = GPTLMHeadModel(GPTConfig.tiny_moe(moe_gate="balance"),
                               device="cpu")
    x = torch.randn(1, 3, 8)
    with pytest.raises(NotImplementedError, match="per-token gate"):
        layer.decode(x)
    moe.refuse_batch_coupled(GPTLMHeadModel(GPTConfig.tiny_moe(),
                                            device="cpu"))
    before = trace_counts()
    with pytest.raises(NotImplementedError, match="BalanceGate"):
        ServingEngine(model, slots=2, max_len=32, device="cpu")
    assert trace_counts() == before
    with pytest.raises(NotImplementedError, match="BalanceGate"):
        generate(model, [[1, 2, 3]], max_new_tokens=2, device="cpu")


def _pair(family):
    if family == "gpt":
        jcfg, cfg = JaxGPTConfig.tiny_moe(), GPTConfig.tiny_moe()
        jcls, cls = JaxGPT, GPTLMHeadModel
    else:
        base = dataclasses.asdict(JaxLlamaConfig.tiny())
        jcfg = JaxLlamaConfig(**{**base, "num_experts": 4})
        cfg = LlamaConfig(**dataclasses.asdict(jcfg))
        jcls, cls = JaxLlama, LlamaLMHeadModel
    jmodel = jcls(jcfg)
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(params), cfg),
                          strict=True)
    return jmodel, params, model


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, (int(n),)).tolist()
            for n in (5, 11, 3, 9)]


@pytest.fixture(scope="module")
def gpt_refs():
    """``hetu_tpu``'s one-shot greedy ``generate`` of each prompt on
    ``GPTConfig.tiny_moe`` (``test_moe_plane.py:402``'s workload)."""
    jmodel, params, model = _pair("gpt")
    prompts = _prompts(model.cfg.vocab_size)
    refs = [np.asarray(jax_generate(
        jmodel, params, jnp.asarray([p], jnp.int32),
        max_new_tokens=NEW))[0, len(p):].tolist() for p in prompts]
    return model, prompts, refs


def test_moe_engine_tokens_equal_jax_generate_with_one_capture_a_lane(
        gpt_refs):
    """``ServingEngine`` serving ``tiny_moe`` greedily (2 slots for 4
    requests: slots are recycled, prompts span several prefill chunks)
    produces ``hetu_tpu``'s one-shot ``generate`` tokens, each lane
    captured once when the engine is built and never again; the port's
    own ``generate`` agrees too."""
    model, prompts, refs = gpt_refs
    before = trace_counts()
    eng = ServingEngine(model, slots=2, max_len=32, prefill_chunk=8,
                        device="cpu")
    built = trace_counts()
    res = eng.generate_many(prompts, SamplingParams(max_tokens=NEW))
    after = trace_counts()
    assert res == refs
    for lane, key in LANES.items():
        assert built.get(key, 0) - before.get(key, 0) == 1, lane
        assert after.get(key, 0) == built.get(key, 0), lane
        assert eng.lanes[lane].captures == 1
    assert eng.lane_iters["prefill"] >= 3 and eng.lane_iters["decode"] > 0
    for p, ref in zip(prompts, refs):
        out = generate(model, [p], max_new_tokens=NEW, device="cpu")
        assert out[0, len(p):].tolist() == ref


def test_llama_moe_generate_equals_jax():
    """Llama-MoE (SwiGLU experts, GQA, RoPE) greedy ``generate`` and the
    engine against ``hetu_tpu``'s ``generate``."""
    jmodel, params, model = _pair("llama")
    prompts = _prompts(model.cfg.vocab_size)[:2]
    refs = [np.asarray(jax_generate(
        jmodel, params, jnp.asarray([p], jnp.int32),
        max_new_tokens=NEW))[0, len(p):].tolist() for p in prompts]
    for p, ref in zip(prompts, refs):
        out = generate(model, [p], max_new_tokens=NEW, device="cpu")
        assert out[0, len(p):].tolist() == ref
    eng = ServingEngine(model, slots=2, max_len=32, prefill_chunk=8,
                        device="cpu")
    assert eng.generate_many(prompts, SamplingParams(max_tokens=NEW)) \
        == refs
