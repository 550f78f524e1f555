"""The port's serving engine with speculative decoding (the verify lane,
the n-gram and the model draftsmen) against ``hetu_tpu``'s, on the CPU.

Both engines serve the same weights (``params_from_jax``) under the same
schedule: the greedy tokens and each request's ``drafted``/``accepted``
must be JAX's, and the tokens one-shot ``generate``'s — for the n-gram
draftsman, a hostile one, depths 1, 3 and 4, budgets that clamp depths
mid-batch, the int8 arena, preemption (``tests/test_spec_qos.py:602``)
and a move between engines. The model draftsman's greedy drafts equal
JAX's ``ModelDraftsman``'s call for call. Each lane, and the draft step,
is captured exactly once. Sampled speculation (the port's own PRNG rule)
commits more than one token a slot-step and replays across arrival
orders.
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
from hetu_tpu.serving import speculative as jax_spec

from hetu_tpu_torch.engine import trace_counts
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel, generate,
    params_from_jax,
)
from hetu_tpu_torch.serving import SamplingParams, ServingEngine
from hetu_tpu_torch.serving import speculative as spec

torch.set_num_threads(2)

MAX_LEN = 32
CHUNK = 8
KEYS = ("serving_decode", "serving_prefill", "serving_draft_step")


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, jcfg, jcls, cfg, cls in (
            ("gpt", JaxGPTConfig, JaxGPT, GPTConfig, GPTLMHeadModel),
            ("llama", JaxLlamaConfig, JaxLlama, LlamaConfig,
             LlamaLMHeadModel)):
        jmodel = jcls(jcfg.tiny())
        params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
        model = cls(cfg.tiny(), device="cpu")
        model.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, params), cfg.tiny()))
        out[name] = (jmodel, params, model)
    return out


def _corpus(vocab, seed=0):
    """Repetitive prompts (the n-gram draftsman's case) and random ones
    (``tests/test_spec_qos.py`` ``_corpus``)."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(1, vocab, (4,)).tolist()
    return [pat * 4, rng.integers(1, vocab, (7,)).tolist(),
            pat * 3 + pat[:2], rng.integers(1, vocab, (11,)).tolist(),
            pat * 2]


def _ref(model, prompt, n, cache_dtype=None):
    out = generate(model, [prompt], max_new_tokens=n, device="cpu",
                   cache_dtype=cache_dtype)
    return out[0, len(prompt):].tolist()


def _engine(model, **kw):
    kw = dict(dict(slots=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
                   device="cpu"), **kw)
    return ServingEngine(model, **kw)


def _deltas(before):
    now = trace_counts()
    return {k: now.get(k, 0) - before.get(k, 0) for k in KEYS}


def _ledgers(reqs):
    return [(r.drafted, r.accepted) for r in reqs]


@pytest.fixture(scope="module")
def jax_spec_run(models):
    """One JAX ``ServingEngine(spec_depth=3)`` run over the corpus."""
    jmodel, params, _ = models["gpt"]
    eng = JaxServingEngine(jmodel, params, slots=2, max_len=MAX_LEN,
                           prefill_chunk=CHUNK, spec_depth=3)
    reqs = [eng.submit(p, JaxSamplingParams(max_tokens=6))
            for p in _corpus(256)]
    eng.run_until_drained()
    return reqs


def test_greedy_tokens_and_ledgers_match_jax(models, jax_spec_run):
    """The port's spec engine commits JAX's tokens with JAX's per-request
    drafted/accepted counts, equal to one-shot ``generate`` (both
    packages'); reversed arrivals and a hostile draftsman (every draft
    wrong) leave the tokens as they are, and nothing re-captures."""
    jmodel, params, model = models["gpt"]
    prompts = _corpus(256)
    want = [list(r.tokens) for r in jax_spec_run]
    for p, w in zip(prompts, want):
        out = jax_generate(jmodel, params, jnp.asarray(p, jnp.int32)[None],
                           max_new_tokens=6, max_len=MAX_LEN)
        assert np.asarray(out[0, len(p):]).tolist() == w
        assert _ref(model, p, 6) == w
    before = trace_counts()
    eng = _engine(model, spec_depth=3)
    assert _deltas(before) == {"serving_decode": 1, "serving_prefill": 1,
                               "serving_draft_step": 0}
    sp = SamplingParams(max_tokens=6)
    reqs = [eng.submit(p, sp) for p in prompts]
    eng.run_until_drained()
    assert [list(r.tokens) for r in reqs] == want
    assert _ledgers(reqs) == _ledgers(jax_spec_run)
    stats = eng.spec_stats
    assert stats["drafted"] == sum(r.drafted for r in reqs) > 0
    assert stats["accepted"] == sum(r.accepted for r in reqs) > 0
    assert stats["sampled_accepted"] == stats["resampled"] == 0
    assert [r.result()["timing"]["drafted"] for r in reqs] \
        == [r.drafted for r in reqs]
    assert eng.generate_many(list(reversed(prompts)), sp) \
        == list(reversed(want))

    class Hostile:
        host_only = True
        surfaces_q = True

        def reset(self, *a):
            pass

        def extend(self, *a):
            pass

        def propose(self, slot, k):
            return [0] * k           # token 0 is never emitted here

    eng._draftsman = Hostile()
    accepted = eng.spec_stats["accepted"]
    assert eng.generate_many(prompts, sp) == want
    assert eng.spec_stats["accepted"] == accepted
    assert _deltas(before) == {"serving_decode": 1, "serving_prefill": 1,
                               "serving_draft_step": 0}
    assert {k: g.captures for k, g in eng.lanes.items()} \
        == {"decode": 1, "prefill": 1}


VARIANTS = {
    # name: (model, engine kwargs, per-request max_tokens, cache dtype)
    "depth1": ("gpt", dict(spec_depth=1), [6] * 5, None),
    "depth4": ("gpt", dict(spec_depth=4), [6] * 5, None),
    # budgets that clamp the depth differently per slot, in one batch
    "mixed_budgets": ("gpt", dict(spec_depth=4, slots=3), [2, 9, 5, 3, 12],
                      None),
    "int8": ("gpt", dict(spec_depth=3, cache_dtype=torch.int8), [5] * 5,
             torch.int8),
    "llama_int8": ("llama", dict(spec_depth=3, cache_dtype=torch.int8),
                   [6] * 5, torch.int8),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_spec_variants_equal_generate(models, name):
    """Depths 1 and 4, budgets that clamp depths mid-batch, the int8
    arena (GPT and Llama): greedy tokens equal ``generate`` from the same
    cache dtype, and drafts land."""
    mname, kw, budgets, cache_dtype = VARIANTS[name]
    model = models[mname][2]
    vocab = model.cfg.vocab_size
    prompts = _corpus(vocab, seed=2)
    eng = _engine(model, **kw)
    reqs = [eng.submit(p, SamplingParams(max_tokens=m))
            for p, m in zip(prompts, budgets)]
    eng.run_until_drained()
    for r, p, m in zip(reqs, prompts, budgets):
        assert list(r.tokens) == _ref(model, p, m, cache_dtype), name
    assert eng.spec_stats["accepted"] > 0
    assert 1.0 + eng.spec_stats["accepted"] / eng.spec_stats["slot_steps"] \
        > 1.0


def test_commit_stops_at_eos_mid_run(models):
    """An EOS among a slot's committed tokens ends the request there: the
    tokens after it are dropped and the ledgers count only what was kept,
    as JAX's (``hetu_tpu/serving/engine.py:2270-2280``)."""
    jmodel, params, model = models["gpt"]
    prompts = _corpus(256)
    eos = 58                               # mid-run in the first request
    jeng = JaxServingEngine(jmodel, params, slots=2, max_len=MAX_LEN,
                            prefill_chunk=CHUNK, spec_depth=3)
    jreqs = [jeng.submit(p, JaxSamplingParams(max_tokens=8, eos_id=eos))
             for p in prompts]
    jeng.run_until_drained()
    eng = _engine(model, spec_depth=3)
    reqs = [eng.submit(p, SamplingParams(max_tokens=8, eos_id=eos))
            for p in prompts]
    eng.run_until_drained()
    assert [list(r.tokens) for r in reqs] == [list(r.tokens) for r in jreqs]
    assert _ledgers(reqs) == _ledgers(jreqs)
    full = _ref(model, prompts[0], 8)
    assert list(reqs[0].tokens) == full[:full.index(eos) + 1]
    assert len(reqs[0].tokens) < 8


def _preempt_schedule(eng, sp_cls, vocab):
    """``tests/test_spec_qos.py:602``: a repetitive batch request decodes
    in the one slot when an interactive one arrives."""
    rng = np.random.default_rng(3)
    pat = rng.integers(1, vocab, (4,)).tolist()
    lo_p, hi_p = pat * 4, rng.integers(1, vocab, (8,)).tolist()
    lo = eng.submit(lo_p, sp_cls(max_tokens=12, priority=2))
    for _ in range(4):
        eng.step()
    hi = eng.submit(hi_p, sp_cls(max_tokens=4, priority=0))
    eng.run_until_drained()
    return (lo, lo_p), (hi, hi_p)


def test_preemption_with_speculation_matches_jax(models):
    """Speculation and preemption in one engine: the batch request is
    preempted, spilled and resumed with no prefill; both requests' tokens
    equal ``generate`` and the JAX engine's, with JAX's preemptions and
    drafted/accepted counts; one capture a lane."""
    jmodel, params, model = models["gpt"]
    jeng = JaxServingEngine(jmodel, params, slots=1, max_len=MAX_LEN,
                            prefill_chunk=CHUNK, spec_depth=3)
    jlo, jhi = _preempt_schedule(jeng, JaxSamplingParams, 256)
    before = trace_counts()
    eng = _engine(model, slots=1, spec_depth=3)
    (lo, lo_p), (hi, hi_p) = _preempt_schedule(eng, SamplingParams, 256)
    assert lo.preemptions == jlo[0].preemptions >= 1
    assert lo.resumed_blocks == lo.spilled_blocks >= 1
    assert lo.timing()["prefill_chunks"] == 2
    assert list(lo.tokens) == list(jlo[0].tokens) == _ref(model, lo_p, 12)
    assert list(hi.tokens) == list(jhi[0].tokens) == _ref(model, hi_p, 4)
    assert _ledgers([lo, hi]) == _ledgers([jlo[0], jhi[0]])
    assert lo.accepted > 0
    assert eng.spill_arena.blocks_held == 0
    assert _deltas(before)["serving_decode"] == 1


def test_evict_resume_with_speculation(models):
    """A speculating request evicted from one engine resumes on another
    with no prefill, re-seeds its n-gram index with its whole history and
    ends with ``generate``'s tokens."""
    model = models["gpt"][2]
    prompt = _corpus(256, seed=4)[0]
    sp = SamplingParams(max_tokens=12)
    a, b = _engine(model, spec_depth=3), _engine(model, spec_depth=3)
    req = a.submit(prompt, sp)
    while len(req.tokens) < 4:
        a.step()
    entry = a.evict_request(req)
    assert entry is not None and req.status == "evicted"
    moved = b.submit(prompt, sp, resume=entry)
    b.run_until_drained()
    assert moved.timing()["prefill_chunks"] == 0
    assert list(moved.tokens) == _ref(model, prompt, 12)
    assert b._draftsman._seq[0][:len(prompt)] == prompt
    assert moved.accepted > 0


def _feed(seqs):
    """A draft call's inputs for the histories ``seqs``: each slot's
    target position is its last token's."""
    pos = np.array([len(s) - 1 if s else 0 for s in seqs], np.int64)
    active = np.array([s is not None for s in seqs])
    return [s if s else None for s in seqs], pos, active


@pytest.mark.parametrize("target_vocab", [256, 200])
def test_model_draftsman_drafts_match_jax(models, target_vocab):
    """The port's ``ModelDraftsman`` (engine-sized blocks, contiguous
    identity tables) and JAX's (one wide block a slot) on the same
    weights: call for call, the same draft lengths and, where a slot
    drafts, the same greedy drafts, through catch-up (a 14-token prompt
    takes ceil(14/4) calls), a slot that sits a call out and a reset;
    also for a target whose vocabulary is smaller than the draft
    model's (draft logits past it masked, q over the target's)."""
    jmodel, params, model = models["gpt"]
    K = 3
    jd = jax_spec.ModelDraftsman(jmodel, params, slots=2, max_len=MAX_LEN,
                                 spec_depth=K, target_vocab=target_vocab)
    before = trace_counts()
    pd = spec.ModelDraftsman(model, slots=2, max_len=MAX_LEN, spec_depth=K,
                             block_size=16, target_vocab=target_vocab)
    assert _deltas(before)["serving_draft_step"] == 1
    assert pd.table_width == 3 and pd.caches[0].shape[1] == 7
    rng = np.random.default_rng(9)
    seqs = [_corpus(256)[0][:14], rng.integers(1, 256, 5).tolist()]
    drafted = 0
    for it in range(12):
        if it == 7:
            seqs[1] = rng.integers(1, 256, 6).tolist()
            jd.reset(1, seqs[1])
            pd.reset(1, seqs[1])
        cur = [s if not (it == 5 and r == 0) else None
               for r, s in enumerate(seqs)]
        s_in, pos, active = _feed(cur)
        budget = np.full(2, K, np.int64)
        budget[1] = 2
        jt, jl, _ = jd.propose_all(s_in, pos, active, budget)
        pt, pl, q = pd.propose_all(s_in, pos, active, budget)
        assert q.shape == (2, K, target_vocab)
        assert int(pt.max()) < target_vocab
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_array_equal(pd.draft_pos, jd.draft_pos)
        for r in range(2):
            if pl[r]:
                drafted += 1
                assert pt[r].tolist() == np.asarray(jt)[r].tolist()
                assert torch.equal(q[r].argmax(-1), pt[r])
        for r in range(2):
            if cur[r] is not None:
                # commit the first draft (or a random token) and one more
                nxt = int(pt[r, 0]) if pl[r] else int(rng.integers(1, 256))
                seqs[r] = seqs[r] + [nxt, int(rng.integers(1, 256))]
    assert drafted >= 8


def test_model_draftsman_engine_matches_jax(models):
    """Self-drafting (the target drafts for itself, as ``bench.py`` and
    ``tests/test_spec_qos.py`` do): tokens equal ``generate`` and JAX's
    engine's, per-request drafted/accepted equal JAX's, acceptance above
    0.8; the draft step and each lane captured once."""
    jmodel, params, model = models["gpt"]
    prompts = _corpus(256, seed=4)[:3]
    jeng = JaxServingEngine(jmodel, params, slots=2, max_len=MAX_LEN,
                            prefill_chunk=CHUNK, spec_depth=3,
                            draft_model=jmodel, draft_params=params)
    jreqs = [jeng.submit(p, JaxSamplingParams(max_tokens=8))
             for p in prompts]
    jeng.run_until_drained()
    before = trace_counts()
    eng = _engine(model, spec_depth=3, draft_model=model)
    reqs = [eng.submit(p, SamplingParams(max_tokens=8)) for p in prompts]
    eng.run_until_drained()
    assert _deltas(before) == {"serving_decode": 1, "serving_prefill": 1,
                               "serving_draft_step": 1}
    assert [list(r.tokens) for r in reqs] \
        == [list(r.tokens) for r in jreqs] \
        == [_ref(model, p, 8) for p in prompts]
    assert _ledgers(reqs) == _ledgers(jreqs)
    st = eng.spec_stats
    assert st["drafted"] > 0 and st["accepted"] / st["drafted"] > 0.8
    with pytest.raises(ValueError, match="draft_model without spec_depth"):
        _engine(model, draft_model=model)


@pytest.mark.parametrize("draft", ["model", "ngram"])
def test_sampled_speculation_replays_and_speculates(models, draft):
    """Sampled requests (T 0.7 and 1.0, per-request seeds) through the
    rejection-sampling verify: tokens in range and two runs in swapped
    arrival orders token-identical; self-drafting (q = p, the acceptance
    ceiling) commits more than one token a slot-step. The n-gram
    draftsman's drafts are rarely the flat random target's picks, so it
    is held to drafting at all."""
    model = models["gpt"][2]
    prompts = _corpus(256, seed=6)
    kw = dict(spec_depth=3)
    if draft == "model":
        kw["draft_model"] = model
    sps = [SamplingParams(max_tokens=10, temperature=(0.7, 1.0)[i % 2],
                          seed=100 + i) for i in range(len(prompts))]
    eng = _engine(model, **kw)
    outs = eng.generate_many(prompts, sps)
    st = dict(eng.spec_stats)
    assert all(0 <= t < 256 for o in outs for t in o)
    assert st["drafted"] > 0
    if draft == "model":
        assert st["sampled_accepted"] > 0
        assert 1.0 + st["accepted"] / st["slot_steps"] > 1.0
    again = _engine(model, **kw).generate_many(prompts[::-1], sps[::-1])
    assert again[::-1] == outs


def test_sampled_request_without_drafts_matches_spec_off(models):
    """A sampled request that never gets a draft (a draftsman that
    proposes nothing) draws the spec-off engine's tokens at its seed."""
    model = models["gpt"][2]
    prompts = _corpus(256, seed=8)
    sps = [SamplingParams(max_tokens=6, temperature=0.9, top_k=20,
                          seed=7 + i) for i in range(len(prompts))]
    want = _engine(model).generate_many(prompts, sps)

    class Silent:
        host_only = True
        surfaces_q = True

        def reset(self, *a):
            pass

        def extend(self, *a):
            pass

        def propose(self, slot, k):
            return []

    eng = _engine(model, spec_depth=3)
    eng._draftsman = Silent()
    assert eng.generate_many(prompts, sps) == want
    assert eng.spec_stats["drafted"] == 0


def test_sampled_speculation_refuses_a_draftsman_without_q(models):
    model = models["gpt"][2]
    eng = _engine(model, spec_depth=2)

    class NoQ:
        host_only = True

    eng._draftsman = NoQ()
    with pytest.raises(spec.SpeculativeConfigError, match="surfaces_q"):
        eng.submit([1, 2, 3], SamplingParams(temperature=0.5))
    eng.submit([1, 2, 3], SamplingParams())       # greedy needs no q


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_depth_zero_is_the_one_row_verify_lane(models, name):
    """``spec_depth=0`` runs the same verify lane at one row a slot: the
    decode operands of the one-row decode step (no row mask), no
    draftsman, one capture a lane, and ``generate``'s greedy tokens."""
    model = models[name][2]
    before = trace_counts()
    eng = _engine(model)
    assert eng._draftsman is None and "dec_rows" not in eng._ops
    assert eng._ops["dec_tok"].shape == (2, 1)
    assert eng._ops["dec_pos"].shape == (2, 1)
    prompts = _corpus(model.cfg.vocab_size, seed=3)
    outs = eng.generate_many(prompts, SamplingParams(max_tokens=6))
    assert outs == [_ref(model, p, 6) for p in prompts]
    assert eng.spec_stats["drafted"] == 0
    # the prefill commits each first token, a slot-step each later one
    assert eng.spec_stats["slot_steps"] == sum(len(o) - 1 for o in outs)
    assert _deltas(before) == {"serving_decode": 1, "serving_prefill": 1,
                               "serving_draft_step": 0}
