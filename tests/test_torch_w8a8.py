"""The port's W8A8 quantized decode (``ParallelMLP``'s and ``MoEMLP``'s
int8 lanes, ``StackedBlocks.decode(w8a8_mask=, w8a8_wq=)``, the serving
engine's ``w8a8=`` option and ``swap_params``' in-place re-quantize)
against ``hetu_tpu``'s, on the CPU at tiny widths.

Inputs come from numpy with a seed; params from a ``hetu_tpu`` tree
(``params_from_jax``). Tolerances, all fp32:

- a lane's output against JAX's: 1e-5 (abs and rel). The int8 products
  are exact and rescale in JAX's order, so the first products are
  bit-equal; the activation between the two products is computed by
  each framework's own GELU / SiLU, whose last bits may differ, and a
  last-bit difference at a rounding boundary flips one code of the
  hidden's quantize. The flips are counted and reported, and must stay
  under 1e-3 of the codes (none is seen at these sizes); 1e-5 holds
  while none occurs;
- ``decode`` logits against JAX's: 1e-4 (the attention and the norms
  are fp32 in two frameworks, as in ``test_torch_int8_serving.py``), and
  the W8A8 lane must move them by more than that from the fp lane;
- engine tokens: equal to ``hetu_tpu``'s engine, greedy.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.models import generation as jax_generation
from hetu_tpu.nn import moe as jmoe
from hetu_tpu.nn import parallel as jpar
from hetu_tpu.ops.quantization import quantize_int8 as jax_quantize_int8
from hetu_tpu.peft import LoraConfig as JaxLoraConfig
from hetu_tpu.peft import inject_lora as jax_inject_lora
from hetu_tpu.peft import wrap_params_for_lora as jax_wrap
from hetu_tpu.serving import SamplingParams as JaxSamplingParams
from hetu_tpu.serving import ServingEngine as JaxServingEngine
from hetu_tpu.serving import tenancy as jax_tenancy

from hetu_tpu_torch.engine import trace_counts
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel,
    init_kv_caches, params_from_jax,
)
from hetu_tpu_torch.models import convert, generation
from hetu_tpu_torch.nn import moe
from hetu_tpu_torch.nn.parallel import ParallelMLP, lora_select
from hetu_tpu_torch.ops import quantization
from hetu_tpu_torch.serving import SamplingParams, ServingEngine, \
    TenantPlane

torch.set_num_threads(2)

SLOTS, MAX_LEN, CHUNK, BLOCK, NEW = 3, 64, 8, 8, 6
LANE_TOL = 1e-5
LOGIT_TOL = 1e-4
FLIP_SHARE = 1e-3
FAMILIES = {
    "gpt": (JaxGPTConfig.tiny, JaxGPT, GPTConfig, GPTLMHeadModel),
    "llama": (JaxLlamaConfig.tiny, JaxLlama, LlamaConfig, LlamaLMHeadModel),
    "moe": (JaxGPTConfig.tiny_moe, JaxGPT, GPTConfig, GPTLMHeadModel)}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _int_mm_calls(monkeypatch):
    """Count ``torch._int_mm`` calls (the W8A8 contraction)."""
    calls = []
    real = torch._int_mm

    def counted(a, b):
        calls.append(tuple(b.shape))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", counted)
    return calls


# -- the dense FFN lane ------------------------------------------------------

MLP_WIDTHS = {"gpt": (64, 256, True, False), "llama": (64, 176, False, True)}


def _mlp_pair(family, seed=0):
    features, hidden, bias, gated = MLP_WIDTHS[family]
    jm = jpar.ParallelMLP(features, hidden, bias=bias, gated=gated)
    params = _np(jm.init(jax.random.key(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    if bias:                       # nonzero biases: their add is checked
        for name in ("fc_in", "fc_out"):
            params[name]["bias"] = rng.normal(
                0, 0.1, params[name]["bias"].shape).astype(np.float32)
    pm = ParallelMLP(features, hidden, bias=bias, gated=gated)
    state = {}
    for k, v in convert._flatten(params).items():
        state[k] = _t(v.T if k.endswith("weight") else v)
    pm.load_state_dict(state, strict=True)
    return jm, params, pm


def _lora_pages(names, features, hidden, seed):
    """One layer's adapter pages for ``names`` (page 0 zero) and each
    token's page, in JAX's and the port's forms."""
    rng = np.random.default_rng(seed)
    P, r = 3, 4
    dims = {"gate_proj": (features, hidden), "up_proj": (features, hidden),
            "fc_in": (features, hidden), "fc_out": (hidden, features)}
    pages = {}
    for name in names:
        d_in, d_out = dims[name]
        A = rng.normal(0, 0.3, (P, d_in, r)).astype(np.float32)
        B = rng.normal(0, 0.3, (P, r, d_out)).astype(np.float32)
        A[0], B[0] = 0.0, 0.0
        pages[name] = {"A": A, "B": B}
    ids = rng.integers(0, P, (2, 5)).astype(np.int32)
    jl = {"ids": jnp.asarray(ids), "pages": jax.tree.map(jnp.asarray, pages)}
    sel, live = lora_select(torch.as_tensor(ids), P, r, torch.float32)
    pl = {"sel": sel, "live": live,
          "pages": jax.tree.map(torch.as_tensor, pages)}
    return jl, pl


def _hidden_flips(family, pm, jm, params, x, wq, lora_pair):
    """Codes of the hidden's quantize that differ between the port's and
    JAX's activation of the same (bit-equal) int8 in-products."""
    from hetu_tpu.ops import activations as jact
    dt = torch.float32
    names = ("gate_proj", "up_proj") if pm.gated else ("fc_in",)
    ys = []
    for name in names:
        lin = getattr(pm, name)
        y = quantization.int8_w8a8_matmul_prequant(
            x, wq[name]["q"].t(), wq[name]["scale"], dtype=dt)
        if lin.bias is not None:
            y = y + lin.bias
        if lora_pair is not None:
            from hetu_tpu_torch.nn.parallel import lora_apply
            y = lora_apply(lora_pair[1], name, x, y)
        ys.append(y)
    if pm.gated:
        from hetu_tpu_torch.ops.activations import swiglu
        h = swiglu(*ys)
        hj = jact.swiglu(*(jnp.asarray(y.numpy()) for y in ys))
    else:
        from hetu_tpu_torch.ops.activations import gelu
        h = gelu(ys[0])
        hj = jax.nn.gelu(jnp.asarray(ys[0].numpy()))
    q, _ = quantization.quantize_int8(h)
    qj, _ = jax_quantize_int8(hj)
    return int((q.numpy() != np.asarray(qj)).sum()), q.numel()


@pytest.mark.parametrize("lora", (False, True), ids=("base", "lora"))
@pytest.mark.parametrize("prequant", (True, False), ids=("wq", "per_call"))
@pytest.mark.parametrize("family", sorted(MLP_WIDTHS))
def test_mlp_lane_matches_jax(family, prequant, lora):
    """``ParallelMLP``'s W8A8 lane against JAX's ``_w8a8_lane``, with the
    pre-quantized tree and per call, with and without a LoRA tree; the
    tree's codes are JAX's ``prequantize`` codes, transposed."""
    jm, params, pm = _mlp_pair(family)
    features, hidden = MLP_WIDTHS[family][:2]
    x = np.random.default_rng(1).normal(size=(2, 5, features)).astype(
        np.float32)
    jwq = jm.prequantize(params) if prequant else None
    wq = pm.prequantize()
    for name, leaf in jm.prequantize(params).items():
        np.testing.assert_array_equal(wq[name]["q"].t().numpy(),
                                      np.asarray(leaf["q"]))
        np.testing.assert_array_equal(wq[name]["scale"].t().numpy(),
                                      np.asarray(leaf["scale"]))
    pair = _lora_pages(pm._names(), features, hidden, 3) if lora else None
    want = np.asarray(jm._w8a8_lane(params, jnp.asarray(x), wq=jwq,
                                    lora=pair[0] if lora else None))
    with torch.no_grad():
        got = pm(_t(x), lora=pair[1] if lora else None, w8a8=True,
                 w8a8_wq=wq if prequant else None)
        fp = pm(_t(x), lora=pair[1] if lora else None)
        flips, codes = _hidden_flips(family, pm, jm, params, _t(x), wq,
                                     pair)
    print(f"{family}: {flips} of {codes} hidden codes flip")
    assert flips <= FLIP_SHARE * codes
    np.testing.assert_allclose(got.numpy(), want, atol=LANE_TOL,
                               rtol=LANE_TOL)
    assert float((got - fp).abs().max()) > 10 * LANE_TOL


#: the share of codes a one-ulp change of every input flips, at most:
#: about ulp / code width, which is 2^-24 amax-relative in fp32 and up to
#: 2^-8 * 127 (0.5) for bf16's largest inputs
ULP_FLIP_SHARE = {torch.float32: 1e-4, torch.bfloat16: 0.25}


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("fp32", "bf16"))
def test_one_ulp_before_the_quantize_flips_codes(dtype):
    """How many activation codes flip where an op before the per-token
    quantize differs in the last bit (as two frameworks' GELU, or two
    GEMM shapes, may): every input moved by one ulp away from zero, at
    Llama-7B's width. In fp32 almost none; in bf16 a sizable share,
    which is why two implementations of one bf16 W8A8 decode lie
    further apart than two bf16 ones (PERF.md, W8A8 findings)."""
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(16, 4096)).astype(np.float32)).to(dtype)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    nudged = (x.view(bits) + 1).view(dtype)        # one ulp, away from 0
    assert bool((nudged != x).all())
    q, _ = quantization.quantize_int8(x)
    qn, _ = quantization.quantize_int8(nudged)
    share = float((q != qn).float().mean())
    print(f"{dtype}: {share:.2e} of the codes flip")
    assert share <= ULP_FLIP_SHARE[dtype]
    assert int((q.int() - qn.int()).abs().max()) <= 1


# -- the MoE lane ------------------------------------------------------------

@pytest.mark.parametrize("gated", (False, True), ids=("gelu", "swiglu"))
def test_moe_lane_matches_jax(gated):
    """``MoEMLP.decode(w8a8=True, wq=prequantize())`` against JAX's
    ``q_lane``; the tree's codes and scales are JAX's; the gate routes in
    fp (the same experts as the fp lane); without a tree the fp lane
    runs, as in JAX."""
    jm = jmoe.MoEMLP(16, 48, num_experts=4, k=2, gated=gated)
    params = _np(jm.init(jax.random.key(0), dtype=jnp.float32))
    rng = np.random.default_rng(4)
    for name in ("wi", "wg", "wo"):      # outputs of order 1
        if name in params:
            params[name] = rng.normal(0, 0.3, params[name].shape).astype(
                np.float32)
    pm = moe.MoEMLP(16, 48, num_experts=4, k=2, gated=gated)
    pm.load_state_dict({k: _t(v) for k, v in
                        convert._flatten(params).items()})
    x = np.random.default_rng(2).normal(size=(3, 5, 16)).astype(np.float32)
    jwq = jm.prequantize(params)
    wq = pm.prequantize()
    for name, leaf in jwq.items():
        np.testing.assert_array_equal(wq[name]["q"].numpy(),
                                      np.asarray(leaf["q"]))
        np.testing.assert_array_equal(wq[name]["scale"].numpy(),
                                      np.asarray(leaf["scale"]))
        # the contraction axis innermost in memory
        assert wq[name]["q"].stride(1) == 1
    want = np.asarray(jm.decode(params, jnp.asarray(x), w8a8=True, wq=jwq))
    with torch.no_grad():
        got = pm.decode(_t(x), w8a8=True, wq=wq)
        fp = pm.decode(_t(x))
        no_tree = pm.decode(_t(x), w8a8=True)
    np.testing.assert_allclose(got.numpy(), want, atol=LANE_TOL,
                               rtol=LANE_TOL)
    assert float((got - fp).abs().max()) > 10 * LANE_TOL
    assert torch.equal(no_tree, fp)


def test_prequantize_in_place_keeps_the_tensors():
    """``prequantize(into=tree)`` writes the current weights' codes into
    the tree's own tensors (the dense and the MoE layer)."""
    _, _, pm = _mlp_pair("llama")
    tree = pm.prequantize()
    ptrs = {n: (t["q"].data_ptr(), t["scale"].data_ptr())
            for n, t in tree.items()}
    with torch.no_grad():
        for p in pm.parameters():
            p.mul_(-2.0)
    assert pm.prequantize(into=tree) is tree
    fresh = pm.prequantize()
    for n, t in tree.items():
        assert (t["q"].data_ptr(), t["scale"].data_ptr()) == ptrs[n]
        assert torch.equal(t["q"], fresh[n]["q"])
        assert torch.equal(t["scale"], fresh[n]["scale"])
    mm = moe.MoEMLP(16, 48, num_experts=4, k=2, gated=True)
    with torch.no_grad():
        for p in mm.parameters():
            p.normal_(0, 0.02)
    tree = mm.prequantize()
    ptrs = {n: t["q"].data_ptr() for n, t in tree.items()}
    with torch.no_grad():
        mm.wo.mul_(3.0)
    mm.prequantize(into=tree)
    fresh = mm.prequantize()
    for n, t in tree.items():
        assert t["q"].data_ptr() == ptrs[n]
        assert torch.equal(t["q"], fresh[n]["q"])
        assert torch.equal(t["scale"], fresh[n]["scale"])


# -- decode through the stacked blocks ---------------------------------------

def _pair(family):
    jcfg_fn, jcls, cfg_cls, cls = FAMILIES[family]
    jcfg = jcfg_fn()
    jmodel = jcls(jcfg)
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = cfg_cls(**{f.name: getattr(jcfg, f.name)
                     for f in dataclasses.fields(cfg_cls)})
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np(params), cfg), strict=True)
    return dict(jmodel=jmodel, params=params, cfg=cfg, model=model)


@pytest.fixture(scope="module")
def gpt():
    return _pair("gpt")


@pytest.fixture(scope="module")
def llama():
    return _pair("llama")


@pytest.fixture(scope="module")
def moe_pair():
    return _pair("moe")


def _port_trees(model, mask):
    return [blk.mlp.prequantize() if on else None
            for blk, on in zip(model.blocks, mask)]


@pytest.mark.parametrize("prequant", (True, False), ids=("wq", "per_call"))
@pytest.mark.parametrize("family", ("gpt", "llama", "moe"))
def test_decode_with_a_mixed_mask_matches_jax(family, prequant, request):
    """``generation.decode`` over a dense int8 cache with ``w8a8_mask=
    [True, False]``: a prompt chunk, then one token, against JAX's
    ``decode`` with the same mask (and its stacked ``prequantize`` tree);
    the lane moves the logits off the fp decode's. The MoE lane runs only
    with the tree (without one both packages run the fp lane)."""
    s = request.getfixturevalue({"moe": "moe_pair"}.get(family, family))
    jmodel, params, model = s["jmodel"], s["params"], s["model"]
    L = s["cfg"].num_layers
    mask = [True] + [False] * (L - 1)
    jwq = jmodel.blocks.block.mlp.prequantize(params["blocks"]["mlp"],
                                               stacked=True) \
        if prequant else None
    wq = _port_trees(model, mask) if prequant else None
    rng = np.random.default_rng(5)
    ids = rng.integers(1, s["cfg"].vocab_size, (2, 9)).astype(np.int32)
    jc = jax_generation.init_kv_caches(jmodel, 2, 16, jnp.int8)
    pc = init_kv_caches(model, 2, 16, torch.int8)
    fc = init_kv_caches(model, 2, 16, torch.int8)
    for lo, hi in ((0, 8), (8, 9)):
        pos = np.broadcast_to(np.arange(lo, hi), (2, hi - lo))
        want, jc = jax_generation.decode(
            jmodel, params, jnp.asarray(ids[:, lo:hi]), jnp.asarray(pos),
            jc, w8a8_mask=jnp.asarray(mask), w8a8_wq=jwq)
        ti, tp = torch.as_tensor(ids[:, lo:hi]).long(), torch.as_tensor(
            pos.copy()).long()
        got = generation.decode(model, ti, tp, pc, w8a8_mask=mask,
                                w8a8_wq=wq)
        fp = generation.decode(model, ti, tp, fc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    moved = float((got - fp).abs().max())
    if family == "moe" and not prequant:
        assert moved == 0.0
    else:
        assert moved > LOGIT_TOL
    with pytest.raises(ValueError, match="w8a8_mask has 1 entries"):
        generation.decode(model, ti, tp, pc, w8a8_mask=[True])


# -- the serving engine ------------------------------------------------------

def _prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, 20).tolist()
    out = [system + rng.integers(1, vocab, n).tolist() for n in (6, 9)]
    out.append(rng.integers(1, vocab, 19).tolist())
    out += [system + rng.integers(1, vocab, 4).tolist()]
    out.append(rng.integers(1, vocab, 5).tolist())
    return out


def _jax_engine(s, **kw):
    return JaxServingEngine(s["jmodel"], s["params"], slots=SLOTS,
                            max_len=MAX_LEN, prefill_chunk=CHUNK,
                            block_size=BLOCK, cache_dtype=jnp.int8,
                            prefill_attn="flash", **kw)


def _engine(model, **kw):
    kw = dict(dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                   block_size=BLOCK, cache_dtype=torch.int8, device="cpu"),
              **kw)
    return ServingEngine(model, **kw)


@pytest.mark.parametrize("w8a8", ("on", (0,)), ids=("on", "layer0"))
@pytest.mark.parametrize("family", ("gpt", "llama", "moe"))
def test_engine_tokens_match_jax(family, w8a8, request, monkeypatch):
    """Greedy tokens of the port's engine under ``w8a8`` equal
    ``hetu_tpu``'s engine's; the decode lane runs the int8 products of
    the chosen layers (2 a dense GPT layer, 3 a Llama layer, 2 an MoE
    layer: one product over all experts a projection) and the prefill
    lane none; each lane is captured once."""
    s = request.getfixturevalue({"moe": "moe_pair"}.get(family, family))
    prompts = _prompts(s["cfg"].vocab_size)
    want = _jax_engine(s, w8a8=list(w8a8) if w8a8 != "on" else w8a8) \
        .generate_many(prompts, JaxSamplingParams(max_tokens=NEW))
    calls = _int_mm_calls(monkeypatch)
    before = trace_counts()
    eng = _engine(s["model"], w8a8=w8a8)
    L = s["cfg"].num_layers
    on = L if w8a8 == "on" else 1
    assert eng._w8a8_mask == ((True,) * L if w8a8 == "on"
                              else (True,) + (False,) * (L - 1))
    assert [t is not None for t in eng._w8a8_wq] == list(eng._w8a8_mask)
    per_layer = 3 if family == "llama" else 2
    del calls[:]
    eng.lanes["decode"].replay()
    assert len(calls) == on * per_layer
    del calls[:]
    eng.lanes["prefill"].replay()
    assert not calls
    assert eng.generate_many(prompts, SamplingParams(max_tokens=NEW)) == want
    now = trace_counts()
    assert {k: now.get(k, 0) - before.get(k, 0)
            for k in ("serving_decode", "serving_prefill")} \
        == {"serving_decode": 1, "serving_prefill": 1}


def test_speculation_with_w8a8_matches_jax(gpt):
    """The verify lane (K + 1 rows a slot) under ``w8a8="on"``: JAX's
    spec engine's tokens and per-request drafted/accepted counts."""
    rng = np.random.default_rng(0)
    pat = rng.integers(1, 256, (4,)).tolist()
    prompts = [pat * 4, rng.integers(1, 256, (7,)).tolist(), pat * 3,
               rng.integers(1, 256, (11,)).tolist()]
    jeng = _jax_engine(gpt, w8a8="on", spec_depth=2)
    jreqs = [jeng.submit(p, JaxSamplingParams(max_tokens=8))
             for p in prompts]
    jeng.run_until_drained()
    eng = _engine(gpt["model"], w8a8="on", spec_depth=2)
    reqs = [eng.submit(p, SamplingParams(max_tokens=8)) for p in prompts]
    eng.run_until_drained()
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs]
    assert [(r.drafted, r.accepted) for r in reqs] \
        == [(r.drafted, r.accepted) for r in jreqs]
    assert eng.spec_stats["accepted"] > 0


def _adapter(s, pattern, seed):
    """An adapter with random B (so it changes tokens), as JAX's registry
    takes it, and its scaling."""
    jcfg = FAMILIES["llama"][0]()
    lmodel = JaxLlama(jcfg)
    jax_inject_lora(lmodel, JaxLoraConfig(r=4, alpha=8.0,
                                          target_patterns=(pattern,)))
    lp = _np(jax_wrap(lmodel, jax.tree.map(jnp.copy, s["params"]),
                      jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def randomize(tree):
        for k, v in tree.items():
            if k == "lora_B":
                tree[k] = rng.normal(0, 1.0, v.shape).astype(np.float32)
            elif isinstance(v, dict):
                randomize(v)

    randomize(lp)
    return (jax_tenancy.extract_adapter(lp),
            jax_tenancy.lora_scaling(lmodel))


def test_tenancy_with_w8a8_matches_jax(llama):
    """Two adapters (one on the attention projections, one on the FFN's,
    which the W8A8 lane adds in compute dtype) and base requests mixed
    in one batch under ``w8a8="on"``: JAX's engine's tokens."""
    adapters = {"att": _adapter(llama, r"\.(q_proj|v_proj)$", 1),
                "mlp": _adapter(llama, r"\.(gate_proj|up_proj|fc_out)$", 2)}
    prompts = _prompts(llama["cfg"].vocab_size, seed=8)
    sps = [dict(), dict(tenant="acme", adapter="att"),
           dict(tenant="acme", adapter="mlp"), dict(),
           dict(tenant="acme", adapter="mlp")]
    jeng = _jax_engine(llama, w8a8="on", tenancy=jax_tenancy.TenantPlane(
        max_adapters=4, r=4))
    eng = _engine(llama["model"], w8a8="on",
                  tenancy=TenantPlane(max_adapters=4, r=4))
    for name, (weights, scale) in adapters.items():
        jeng.load_adapter("acme", name, weights, scaling=scale)
        eng.load_adapter("acme", name, weights, scaling=scale)
    jreqs = [jeng.submit(p, JaxSamplingParams(max_tokens=NEW, **sp))
             for p, sp in zip(prompts, sps)]
    jeng.run_until_drained()
    reqs = [eng.submit(p, SamplingParams(max_tokens=NEW, **sp))
            for p, sp in zip(prompts, sps)]
    eng.run_until_drained()
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs]


def test_option_resolution_and_refusal(gpt):
    """``"auto"`` is off on the CPU, ``"off"``/None/False are off, and
    ``"on"`` or a layer list without the int8 arena raise as JAX's
    engine raises."""
    model = gpt["model"]
    for off in ("off", None, False):
        assert _engine(model, w8a8=off)._w8a8_mask is None
    eng = _engine(model, w8a8="auto")
    assert eng._w8a8_mask is None and eng._w8a8_wq is None
    for w8a8 in ("on", True, [1]):
        with pytest.raises(ValueError, match="int8 arena"):
            _engine(model, cache_dtype=None, w8a8=w8a8)
        with pytest.raises(ValueError, match="int8 arena"):
            JaxServingEngine(gpt["jmodel"], gpt["params"], slots=SLOTS,
                             max_len=MAX_LEN, w8a8=w8a8)
    assert _engine(model, w8a8=[-1])._w8a8_mask == (False, True)


def test_swap_params_requantizes_in_place(gpt):
    """``swap_params`` re-quantizes into the tree's own tensors (the
    captured decode lane reads them by address): the pointers stay, the
    codes and scales become JAX's ``quantize_int8`` of the new weights
    (its stacked ``(L, in, out)`` tree over axis 1), and the tokens
    those of JAX's engine serving the new weights."""
    jmodel, cfg, model = gpt["jmodel"], gpt["cfg"], gpt["model"]
    params1 = jmodel.init(jax.random.key(1), dtype=jnp.float32)
    eng = _engine(model, w8a8="on")
    prompts = _prompts(cfg.vocab_size)[:3]
    sp = SamplingParams(max_tokens=NEW)
    old = eng.generate_many(prompts, sp)
    ptrs = [{n: (t["q"].data_ptr(), t["scale"].data_ptr())
             for n, t in tree.items()} for tree in eng._w8a8_wq]
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        new = {k: v for k, v in params_from_jax(_np(params1), cfg).items()}
        eng.swap_params(new)
        for name in ("fc_in", "fc_out"):
            wq, ws = jax_quantize_int8(
                params1["blocks"]["mlp"][name]["weight"], axis=1)
            for layer, tree in enumerate(eng._w8a8_wq):
                assert (tree[name]["q"].data_ptr(),
                        tree[name]["scale"].data_ptr()) \
                    == ptrs[layer][name]
                np.testing.assert_array_equal(
                    tree[name]["q"].t().numpy(), np.asarray(wq[layer]))
                np.testing.assert_array_equal(
                    tree[name]["scale"].t().numpy(), np.asarray(ws[layer]))
        want = JaxServingEngine(
            jmodel, params1, slots=SLOTS, max_len=MAX_LEN,
            prefill_chunk=CHUNK, block_size=BLOCK, cache_dtype=jnp.int8,
            prefill_attn="flash", w8a8="on").generate_many(
                prompts, JaxSamplingParams(max_tokens=NEW))
        got = eng.generate_many(prompts, sp)
        assert got == want and got != old
        assert {k: g.captures for k, g in eng.lanes.items()} \
            == {"decode": 1, "prefill": 1}
    finally:
        model.load_state_dict(saved)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_off_lanes_hold_the_ops_they_held(llama):
    """With ``w8a8`` off, the decode lane runs exactly the ops of
    ``generation.decode`` called without the W8A8 arguments (the lane
    as it was before the option existed), and no int8 product; with
    ``w8a8=[0]`` the int8 products appear in the decode lane only."""
    model = llama["model"]
    for off in ("off", "auto"):
        eng = _engine(model, w8a8=off)
        ops = eng._ops
        with _OpLog() as log:
            eng.lanes["decode"].run_eager()
        lane = log.ops
        top = model.cfg.max_positions - 1
        row = torch.arange(1)[None, :]
        with _OpLog() as log, torch.no_grad():
            logits = generation.decode(
                model, ops["dec_tok"], (ops["dec_pos"] + row).clamp(max=top),
                eng.pool.caches, slot_mask=ops["dec_mask"],
                block_tables=ops["bt"])
            logits.argmax(dim=-1)
        assert lane == log.ops
        assert not any("_int_mm" in op for op in lane)
    eng = _engine(model, w8a8=[0])
    for name, n in (("decode", 3), ("prefill", 0)):
        with _OpLog() as log:
            eng.lanes[name].run_eager()
        assert sum("_int_mm" in op for op in log.ops) == n
