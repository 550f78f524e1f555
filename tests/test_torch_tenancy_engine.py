"""The port's multi-tenant serving (``ServingEngine(tenancy=...)``, the
adapter arena, ``nn.parallel.lora_apply``) against ``hetu_tpu``'s, on the
CPU at tiny widths.

Both packages serve one JAX parameter tree (``params_from_jax``) and one
adapter (``hetu_tpu.serving.tenancy.extract_adapter`` of a JAX LoRA tree
with random B, so it changes the tokens). ``lora_apply`` matches JAX's in
fp32 within 1e-5 and returns a base token's output bit for bit; a
mixed-tenant batch gives JAX's engine's greedy tokens and those of
``generate`` under ``merge_lora`` weights (adapter requests) or the plain
ones (base requests), from the fp32 and the int8 arena, on GPT and Llama.
Each lane is captured once through adapter load, hot-swap and eviction;
base-only traffic on a tenancy engine is bit-equal to a tenancy-off one
(tokens, first-token logits and the whole KV arena)."""

import dataclasses
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.nn.parallel import lora_apply as jax_lora_apply
from hetu_tpu.peft import LoraConfig as JaxLoraConfig
from hetu_tpu.peft import inject_lora as jax_inject_lora
from hetu_tpu.peft import merge_lora as jax_merge_lora
from hetu_tpu.peft import wrap_params_for_lora as jax_wrap
from hetu_tpu.serving import SamplingParams as JaxSamplingParams
from hetu_tpu.serving import ServingEngine as JaxServingEngine
from hetu_tpu.serving import tenancy as jax_tenancy

from hetu_tpu_torch.engine import trace_counts
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel, generate,
    params_from_jax,
)
from hetu_tpu_torch.nn.parallel import lora_apply, lora_select
from hetu_tpu_torch.serving import SamplingParams, ServingEngine, TenantPlane

torch.set_num_threads(2)

MAX_LEN = 32
CHUNK = 8
KEYS = ("serving_decode", "serving_prefill")
FAMILIES = {
    "gpt": (JaxGPTConfig.tiny, JaxGPT, GPTConfig, GPTLMHeadModel,
            r"\.(q_proj|v_proj)$"),
    "llama": (JaxLlamaConfig.tiny, JaxLlama, LlamaConfig, LlamaLMHeadModel,
              JaxLoraConfig.target_patterns[0]),
    "moe": (JaxGPTConfig.tiny_moe, JaxGPT, GPTConfig, GPTLMHeadModel,
            r"\.(q_proj|v_proj)$"),
    "llama_mlp": (JaxLlamaConfig.tiny, JaxLlama, LlamaConfig,
                  LlamaLMHeadModel, r"\.(gate_proj|up_proj|fc_out)$")}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _setup(family):
    """JAX model + params, the adapter's pages (B ~ N(0, 1), so the
    adapter changes tokens) and scaling, the merged tree; the port's plain
    and merged models."""
    jcfg_fn, jcls, cfg_cls, cls, pattern = FAMILIES[family]
    jcfg = jcfg_fn()
    jmodel = jcls(jcfg)
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    lmodel = jcls(jcfg)
    jax_inject_lora(lmodel, JaxLoraConfig(r=4, alpha=8.0,
                                          target_patterns=(pattern,)))
    lp = _np(jax_wrap(lmodel, jax.tree.map(jnp.copy, params),
                      jax.random.key(1)))
    rng = np.random.default_rng(7)

    def randomize(tree):
        for k, v in tree.items():
            if k == "lora_B":
                tree[k] = rng.normal(0, 1.0, v.shape).astype(np.float32)
            elif isinstance(v, dict):
                randomize(v)

    randomize(lp)
    weights = jax_tenancy.extract_adapter(lp)
    scale = jax_tenancy.lora_scaling(lmodel)
    merged = _np(jax_merge_lora(lmodel, lp))
    cfg = cfg_cls(**{f.name: getattr(jcfg, f.name)
                     for f in dataclasses.fields(cfg_cls)})
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np(params), cfg))
    mmodel = cls(cfg, device="cpu")
    mmodel.load_state_dict(params_from_jax(merged, cfg))
    return dict(jmodel=jmodel, params=params, weights=weights, scale=scale,
                merged=merged, cfg=cfg, model=model, mmodel=mmodel)


@pytest.fixture(scope="module")
def gpt():
    return _setup("gpt")


@pytest.fixture(scope="module")
def llama():
    return _setup("llama")


def _gen(model, prompt, n, cache_dtype=None, lora=None):
    out = generate(model, [prompt], max_new_tokens=n, device="cpu",
                   cache_dtype=cache_dtype, lora=lora)
    return out[0, len(prompt):].tolist()


def _engine(model, **kw):
    kw = dict(dict(slots=3, max_len=MAX_LEN, prefill_chunk=CHUNK,
                   device="cpu"), **kw)
    return ServingEngine(model, **kw)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def _deltas(before):
    now = trace_counts()
    return {k: now.get(k, 0) - before.get(k, 0) for k in KEYS}


ADAPTER = dict(tenant="acme", adapter="fr")


@pytest.mark.parametrize("shape", [(2, 3, 16, 24, 4, 4), (1, 7, 8, 40, 3, 2)])
def test_lora_apply_matches_jax_and_keeps_base_rows(shape):
    """The port's page-select form of BGMV against JAX's per-token gather
    (fp32, 1e-5); page-0 rows are ``y`` bit for bit; no arena, or a
    projection it lacks, returns ``y`` itself."""
    b, s, d_in, d_out, P, r = shape
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, s, d_in)).astype(np.float32)
    y = rng.normal(size=(b, s, d_out)).astype(np.float32)
    y[0, 0, 0] = -0.0
    A = rng.normal(0, 0.3, (P, d_in, r)).astype(np.float32)
    B = rng.normal(0, 0.3, (P, r, d_out)).astype(np.float32)
    A[0], B[0] = 0.0, 0.0
    ids = rng.integers(0, P, (b, s)).astype(np.int32)
    ids[0, 0] = 0
    want = np.asarray(jax_lora_apply(
        {"ids": jnp.asarray(ids), "pages": {"q_proj": {
            "A": jnp.asarray(A), "B": jnp.asarray(B)}}}, "q_proj",
        jnp.asarray(x), jnp.asarray(y)))
    sel, live = lora_select(torch.as_tensor(ids), P, r, torch.float32)
    lora = {"sel": sel, "live": live, "pages": {"q_proj": {
        "A": torch.as_tensor(A), "B": torch.as_tensor(B)}}}
    yt = torch.as_tensor(y)
    got = lora_apply(lora, "q_proj", torch.as_tensor(x), yt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    base = torch.as_tensor(ids == 0)
    assert torch.equal(got[base], yt[base])
    assert torch.signbit(got[0, 0, 0])
    assert lora_apply(None, "q_proj", torch.as_tensor(x), yt) is yt
    assert lora_apply(lora, "k_proj", torch.as_tensor(x), yt) is yt


def _mixed(vocab, seed):
    prompts = _prompts(vocab, (5, 7, 4, 9), seed)
    sps = [dict(), ADAPTER, ADAPTER, dict()]
    return prompts, sps


def _jax_engine(s, **kw):
    eng = JaxServingEngine(s["jmodel"], s["params"], slots=3,
                           max_len=MAX_LEN, prefill_chunk=CHUNK,
                           tenancy=jax_tenancy.TenantPlane(max_adapters=4,
                                                           r=4), **kw)
    eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
    return eng


@pytest.mark.parametrize("family,cache", [("gpt", None), ("llama", "int8")])
def test_mixed_tenant_batch_matches_jax_engine(family, cache, request):
    """A mixed batch (base and adapter requests sharing slots) gives JAX's
    engine's tokens, and the dense oracle's under a one-page arena."""
    s = request.getfixturevalue(family)
    prompts, sps = _mixed(s["cfg"].vocab_size, 0)
    jkw = {"cache_dtype": jnp.int8} if cache else {}
    jeng = _jax_engine(s, **jkw)
    jreqs = [jeng.submit(p, JaxSamplingParams(max_tokens=6, **sp))
             for p, sp in zip(prompts, sps)]
    jeng.run_until_drained()
    dt = torch.int8 if cache else None
    eng = _engine(s["model"], cache_dtype=dt,
                  tenancy=TenantPlane(max_adapters=4, r=4))
    info = eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
    assert info["page"] == 1 and info["version"] == 1
    reqs = [eng.submit(p, SamplingParams(max_tokens=6, **sp))
            for p, sp in zip(prompts, sps)]
    eng.run_until_drained()
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs]
    one_page = {k: {"A": v["A"][:, 1:2].clone(), "B": v["B"][:, 1:2].clone()}
                for k, v in eng._lora_pages.items()}
    for p, sp, r in zip(prompts, sps, reqs):
        lora = {"ids": [1 if sp else 0],
                "pages": {k: {m: torch.cat([torch.zeros_like(t), t], 1)
                              for m, t in v.items()}
                          for k, v in one_page.items()}}
        assert r.tokens == _gen(s["model"], p, 6, dt, lora=lora)


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("cache", [None, torch.int8])
def test_mixed_tenant_batch_matches_merged_generate(family, cache, request):
    """``tests/test_tenancy.py``'s acceptance: adapter requests equal
    ``generate`` under ``merge_lora`` weights, base requests under the
    plain ones, from both arenas."""
    s = request.getfixturevalue(family)
    prompts, sps = _mixed(s["cfg"].vocab_size, 2)
    eng = _engine(s["model"], cache_dtype=cache,
                  tenancy=TenantPlane(max_adapters=3, r=4))
    eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
    reqs = [eng.submit(p, SamplingParams(max_tokens=5, **sp))
            for p, sp in zip(prompts, sps)]
    eng.run_until_drained()
    changed = 0
    for p, sp, r in zip(prompts, sps, reqs):
        want = _gen(s["mmodel"] if sp else s["model"], p, 5, cache)
        assert r.tokens == want
        changed += bool(sp) and want != _gen(s["model"], p, 5, cache)
    assert changed, "the adapter changed no request's tokens"


def test_churn_keeps_one_capture_and_hot_swap_continuity(gpt):
    """Load, a hot-swap under live traffic, a second tenant and an
    eviction: each lane is captured once. The request in flight at the
    swap finishes under the old version; the next one decodes under the
    new (zero B: base tokens); the stale page drains with its last ref."""
    s = gpt
    before = trace_counts()
    plane = TenantPlane(max_adapters=4, r=4)
    eng = _engine(s["model"], slots=2, tenancy=plane)
    assert _deltas(before) == {"serving_decode": 1, "serving_prefill": 1}
    eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
    uid1 = plane.registry.get("acme", "fr").uid
    p_old, p_new = _prompts(256, (6, 5), 4)
    r_old = eng.submit(p_old, SamplingParams(max_tokens=6, **ADAPTER))
    while r_old.status == "queued":
        assert eng.step()
    assert r_old.adapter_ref.uid == uid1
    w2 = {k: {"A": v["A"], "B": np.zeros_like(v["B"])}
          for k, v in s["weights"].items()}
    info = eng.load_adapter("acme", "fr", w2, scaling=s["scale"])
    assert info["version"] == 2 and info["uid"] != uid1
    assert plane.registry.stats()["pages_in_use"] == 2
    r_new = eng.submit(p_new, SamplingParams(max_tokens=6, **ADAPTER))
    eng.load_adapter("beta", "de", s["weights"], scaling=s["scale"])
    r_beta = eng.submit(p_new, SamplingParams(max_tokens=6, tenant="beta",
                                              adapter="de"))
    eng.run_until_drained()
    assert r_old.tokens == _gen(s["mmodel"], p_old, 6)
    assert r_new.tokens == _gen(s["model"], p_new, 6)
    assert r_beta.tokens == _gen(s["mmodel"], p_new, 6)
    assert plane.registry.stats()["pages_in_use"] == 2
    assert eng.evict_adapter("beta", "de") == {"flushed_blocks": 0}
    stats = plane.registry.stats()
    assert stats["adapters"] == 1 and stats["pages_in_use"] == 1
    assert not eng._lora_pages["q_proj"]["A"][:, 3].any()
    assert _deltas(before) == {"serving_decode": 1, "serving_prefill": 1}
    assert plane.ledgers["admitted"] == {"acme": 2, "beta": 1}


BETA = dict(tenant="beta", adapter="de")
WAIT_S = 20.0


def test_adapter_plane_under_the_running_loop_matches_jax(gpt):
    """With the loop stepping mixed traffic: an adapter load, a second
    tenant's load, a hot-swap while the old version serves a request and
    an eviction while a base request decodes. Each lane is captured once,
    and every request gives the tokens of JAX's engine serving it under
    the same adapter version."""
    s = gpt
    base_p, acme_p, beta_p, new_p = _prompts(s["cfg"].vocab_size,
                                             (9, 6, 7, 5), 11)
    w0 = {k: {"A": v["A"], "B": np.zeros_like(v["B"])}
          for k, v in s["weights"].items()}
    jeng = _jax_engine(s)
    jeng.load_adapter("beta", "de", s["weights"], scaling=s["scale"])
    jreqs = [jeng.submit(p, JaxSamplingParams(max_tokens=n, **sp))
             for p, n, sp in ((base_p, 20, {}), (acme_p, 8, ADAPTER),
                              (beta_p, 8, BETA))]
    jeng.run_until_drained()
    jeng.load_adapter("acme", "fr", w0, scaling=s["scale"])
    jreqs.append(jeng.submit(new_p, JaxSamplingParams(max_tokens=8,
                                                      **ADAPTER)))
    jeng.run_until_drained()
    want = [list(r.tokens) for r in jreqs]

    before = trace_counts()
    plane = TenantPlane(max_adapters=4, r=4)
    eng = _engine(s["model"], tenancy=plane)
    eng.start()
    try:
        eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
        base = eng.submit(base_p, SamplingParams(max_tokens=20))
        acme = eng.submit(acme_p, SamplingParams(max_tokens=8, **ADAPTER))
        eng.load_adapter("beta", "de", s["weights"], scaling=s["scale"])
        beta = eng.submit(beta_p, SamplingParams(max_tokens=8, **BETA))
        deadline = time.monotonic() + WAIT_S
        while acme.status == "queued":      # pin v1 before the hot-swap
            assert time.monotonic() < deadline, "acme never admitted"
            time.sleep(1e-3)
        assert eng.load_adapter("acme", "fr", w0,
                                scaling=s["scale"])["version"] == 2
        new = eng.submit(new_p, SamplingParams(max_tokens=8, **ADAPTER))
        got = {"beta": eng.result(beta, timeout=WAIT_S)["tokens"]}
        eng.evict_adapter("beta", "de")
        for name, r in (("base", base), ("acme", acme), ("new", new)):
            got[name] = eng.result(r, timeout=WAIT_S)["tokens"]
    finally:
        eng.stop()
    assert [got[k] for k in ("base", "acme", "beta", "new")] == want
    assert plane.registry.stats()["adapters"] == 1
    assert _deltas(before) == {"serving_decode": 1, "serving_prefill": 1}
    assert plane.ledgers["admitted"] == {"base": 1, "acme": 2, "beta": 1}


@pytest.mark.parametrize("verb", ["load", "evict"])
def test_adapter_verbs_wait_for_the_iteration_boundary(gpt, verb):
    """``load_adapter`` and ``evict_adapter`` take the iteration lock: while
    an iteration holds it, neither writes the arena or the registry; once
    it is released, each lands."""
    s = gpt
    plane = TenantPlane(max_adapters=4, r=4)
    eng = _engine(s["model"], tenancy=plane)
    if verb == "evict":
        eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
    arena = {k: v["B"].clone() for k, v in eng._lora_pages.items()}
    call = (lambda: eng.load_adapter("acme", "fr", s["weights"],
                                     scaling=s["scale"])) \
        if verb == "load" else (lambda: eng.evict_adapter("acme", "fr"))
    eng._step_lock.acquire()                # an iteration in flight
    try:
        t = threading.Thread(target=call, daemon=True)
        t.start()
        t.join(timeout=0.3)
        assert t.is_alive(), f"{verb}_adapter ran inside an iteration"
        assert all(torch.equal(v["B"], arena[k])
                   for k, v in eng._lora_pages.items())
        assert plane.registry.has("acme", "fr") == (verb == "evict")
    finally:
        eng._step_lock.release()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert plane.registry.has("acme", "fr") == (verb == "load")
    if verb == "load":
        assert not all(torch.equal(v["B"], arena[k])
                       for k, v in eng._lora_pages.items())


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_base_traffic_is_bit_equal_to_tenancy_off(family, request):
    """Base-only requests on an engine with adapters loaded: the tokens,
    the first-token logits and the whole KV arena of a tenancy-off
    engine, bit for bit."""
    s = request.getfixturevalue(family)
    prompts = _prompts(s["cfg"].vocab_size, (5, 13, 9, 20), 5)
    runs = []
    for tenancy in (None, TenantPlane(max_adapters=3, r=4)):
        eng = _engine(s["model"], tenancy=tenancy, record_first_logits=True)
        if tenancy is not None:
            eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
            assert "adapter" in eng._ops
        else:
            assert "adapter" not in eng._ops and not eng._lora_pages
        reqs = [eng.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
        eng.run_until_drained()
        runs.append((reqs, eng.pool.caches))
    (off, c_off), (on, c_on) = runs
    assert [r.tokens for r in on] == [r.tokens for r in off]
    assert all(torch.equal(a.first_logits, b.first_logits)
               for a, b in zip(on, off))
    assert all(torch.equal(a, b) for a, b in zip(c_on, c_off))


def test_preempted_adapter_request_resumes_under_its_uid(llama):
    """A priority-2 adapter request, preempted by an urgent base one, keeps
    its page pin and resumes into the same adapter load with the tokens of
    an unpreempted run; evicted to another engine it resumes only where
    the same uid serves it, and a base or foreign-uid engine replays it."""
    s = llama
    prompt, urgent = _prompts(s["cfg"].vocab_size, (9, 6), 6)
    sp = SamplingParams(max_tokens=8, priority=2, **ADAPTER)
    want = _gen(s["mmodel"], prompt, 8)
    plane = TenantPlane(max_adapters=3, r=4)
    eng = _engine(s["model"], slots=1, tenancy=plane)
    eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
    uid = plane.registry.get("acme", "fr").uid
    req = eng.submit(prompt, sp)
    while len(req.tokens) < 3:
        eng.step()
    hot = eng.submit(urgent, SamplingParams(max_tokens=4, priority=0))
    while req.preemptions == 0:
        eng.step()
    assert req.adapter_ref is not None and req.adapter_ref.uid == uid
    assert plane.registry.get("acme", "fr").refs == 1
    assert eng.spill_arena.get(req.id).adapter == uid
    eng.run_until_drained()
    assert req.timing()["resumed"] and req.tokens == want
    assert hot.tokens == _gen(s["model"], urgent, 4)
    assert plane.registry.get("acme", "fr").refs == 0

    # evict mid-decode, resume elsewhere
    req = eng.submit(prompt, sp)
    while len(req.tokens) < 3:
        eng.step()
    entry = eng.evict_request(req)
    assert entry.adapter == uid and plane.registry.get("acme", "fr").refs == 0
    base = _engine(s["model"], slots=1)
    assert not entry.compatible_with(base.pool, 0)
    other = _engine(s["model"], slots=1,
                    tenancy=TenantPlane(max_adapters=3, r=4))
    other.load_adapter("beta", "de", s["weights"], scaling=s["scale"])
    other.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
    moved = other.submit(prompt, sp, resume=entry)
    assert moved.spill is None and moved.kv_adapter != uid
    same = eng.submit(prompt, sp, resume=entry)
    assert same.spill is entry
    other.run_until_drained()
    eng.run_until_drained()
    assert moved.tokens == want
    assert same.tokens == want and same.timing()["resumed"]
    assert same.timing()["prefill_chunks"] == 0


def test_speculation_with_tenancy_equals_spec_off(gpt):
    """``spec_depth=2`` with adapters mixed in: the greedy tokens of the
    spec-off engine."""
    s = gpt
    pat = [3, 9, 27, 81]
    prompts = [pat * 4, _prompts(256, (7,), 8)[0], pat * 3, pat * 2 + [5]]
    sps = [ADAPTER, {}, ADAPTER, {}]
    toks = []
    for depth in (0, 2):
        eng = _engine(s["model"], spec_depth=depth,
                      tenancy=TenantPlane(max_adapters=3, r=4))
        eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
        reqs = [eng.submit(p, SamplingParams(max_tokens=8, **sp))
                for p, sp in zip(prompts, sps)]
        eng.run_until_drained()
        toks.append([r.tokens for r in reqs])
        if depth:
            assert eng.spec_stats["accepted"] > 0
    assert toks[0] == toks[1]


def test_attention_adapter_on_moe_matches_jax():
    """GPT-MoE tiny: the arena pages attention only (expert weights carry
    no adapter) and the mixed batch gives JAX's engine's tokens."""
    s = _setup("moe")
    prompts, sps = _mixed(s["cfg"].vocab_size, 3)
    jeng = _jax_engine(s)
    jreqs = [jeng.submit(p, JaxSamplingParams(max_tokens=5, **sp))
             for p, sp in zip(prompts, sps)]
    jeng.run_until_drained()
    eng = _engine(s["model"], tenancy=TenantPlane(max_adapters=4, r=4))
    assert sorted(eng._lora_pages) == ["k_proj", "out_proj", "q_proj",
                                       "v_proj"]
    eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
    reqs = [eng.submit(p, SamplingParams(max_tokens=5, **sp))
            for p, sp in zip(prompts, sps)]
    eng.run_until_drained()
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs]


def test_mlp_only_adapter_maps_a_base_prefix_as_jax_does():
    """An adapter with no attention target tags its KV as base (JAX's
    sharing rule), so it maps a base request's cached prefix block, while
    an attention adapter's request on the same prompt maps none; the
    tokens of both are JAX's engine's."""
    s = _setup("llama_mlp")
    assert set(s["weights"]) == {"gate_proj", "up_proj", "fc_out"}
    head = _prompts(s["cfg"].vocab_size, (17,), 10)[0]
    follow = head[:16] + [5, 6, 7, 8]
    att = _setup("llama")
    runs = []
    for jax_side in (True, False):
        if jax_side:
            eng = _jax_engine(s)
            eng.load_adapter("beta", "de", att["weights"],
                             scaling=att["scale"])
            sp = JaxSamplingParams
        else:
            eng = _engine(s["model"], tenancy=TenantPlane(max_adapters=4,
                                                          r=4))
            eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
            eng.load_adapter("beta", "de", att["weights"],
                             scaling=att["scale"])
            sp = SamplingParams
        base = eng.submit(head, sp(max_tokens=4))
        eng.run_until_drained()
        mlp = eng.submit(follow, sp(max_tokens=6, **ADAPTER))
        eng.run_until_drained()
        attn = eng.submit(follow, sp(max_tokens=6, tenant="beta",
                                     adapter="de"))
        eng.run_until_drained()
        runs.append([list(r.tokens) for r in (base, mlp, attn)]
                    + [r.cached_tokens for r in (mlp, attn)])
    assert runs[0] == runs[1]
    assert runs[1][3:] == [16, 0]


def test_refusals_carry_jax_messages(gpt):
    """An unknown adapter is rejected, and ``adapter=`` without
    ``tenancy=`` raises, each with JAX's message; a load the arena
    cannot page refuses."""
    s = gpt
    jeng = _jax_engine(s)
    eng = _engine(s["model"], tenancy=True)
    eng.load_adapter("acme", "fr", s["weights"], scaling=s["scale"])
    jr = jeng.submit([1, 2, 3], JaxSamplingParams(tenant="acme",
                                                  adapter="nope"))
    r = eng.submit([1, 2, 3], SamplingParams(tenant="acme", adapter="nope"))
    assert r.status == jr.status == "rejected"
    assert r.error == jr.error and r.done.is_set()
    msgs = []
    for e, spc in ((JaxServingEngine(s["jmodel"], s["params"], slots=1,
                                     max_len=MAX_LEN),
                    JaxSamplingParams), (_engine(s["model"]),
                                         SamplingParams)):
        with pytest.raises(ValueError) as err:
            e.submit([1, 2], spc(**ADAPTER))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "without tenancy=" in msgs[1]
    with pytest.raises(ValueError, match="does not page"):
        eng.load_adapter("acme", "x", {"gate_proj": s["weights"]["q_proj"]})
    with pytest.raises(ValueError, match="do not fit"):
        eng.load_adapter("acme", "x", {"fc_in": s["weights"]["q_proj"]})
    with pytest.raises(RuntimeError, match="without tenancy"):
        _engine(s["model"]).load_adapter("a", "b", s["weights"])


def test_full_arena_waits_and_slot_cap_throttles(gpt):
    """One adapter page for two tenants: the second waits at admission
    (counted once) and completes; a tenant capped at one slot never holds
    two, and every request completes."""
    s = gpt
    plane = TenantPlane(max_adapters=2, r=4)
    eng = _engine(s["model"], slots=2, tenancy=plane)
    eng.load_adapter("a", "x", s["weights"], scaling=s["scale"])
    eng.load_adapter("b", "x", s["weights"], scaling=s["scale"])
    pa, pb = _prompts(256, (5, 7), 9)
    ra = eng.submit(pa, SamplingParams(max_tokens=8, tenant="a",
                                       adapter="x"))
    rb = eng.submit(pb, SamplingParams(max_tokens=4, tenant="b",
                                       adapter="x"))
    eng.run_until_drained()
    assert ra.tokens == _gen(s["mmodel"], pa, 8)
    assert rb.tokens == _gen(s["mmodel"], pb, 4)
    assert plane.ledgers["adapter_waits"] == {"b": 1}

    plane = TenantPlane(max_adapters=3, r=4)
    plane.qos.configure("slow", max_slots=1)
    eng = _engine(s["model"], tenancy=plane)
    reqs = [eng.submit(p, SamplingParams(max_tokens=4, tenant="slow"))
            for p in _prompts(256, (4, 4, 4), 8)]
    peak = 0
    while eng.has_work():
        eng.step()
        peak = max(peak, sum(1 for r in eng._slot_req
                             if r is not None and r.sampling.tenant))
    assert peak == 1 and all(r.status == "done" for r in reqs)
    assert plane.ledgers["throttled"][("slow", "slots")] >= 1
    assert plane.ledgers["admitted"] == {"slow": 3}


def test_budget_subtracts_the_arena():
    """``hbm_budget_bytes`` with tenancy sizes the KV arena from the
    budget less ``size_adapter_arena`` (JAX's ledger), and refuses an
    arena of more than half the budget with JAX's message."""
    from hetu_tpu_torch.engine.memory import size_adapter_arena
    cfg = LlamaConfig.tiny()
    model = LlamaLMHeadModel(cfg, device="cpu")
    budget = 4e6
    arena = size_adapter_arena(cfg, r=4, max_adapters=4)
    eng = _engine(model, slots=None, hbm_budget_bytes=budget,
                  tenancy=TenantPlane(max_adapters=4, r=4))
    ref = _engine(model, slots=None, hbm_budget_bytes=budget - arena)
    plain = _engine(model, slots=None, hbm_budget_bytes=budget)
    assert eng.pool.slots == ref.pool.slots < plain.pool.slots
    with pytest.raises(ValueError, match="more than half"):
        _engine(model, slots=None, hbm_budget_bytes=1.9 * arena,
                tenancy=TenantPlane(max_adapters=4, r=4))
