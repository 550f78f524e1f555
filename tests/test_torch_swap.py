"""The port's ``swap_params``, its version-tagged prefix cache and the
engine's background loop against ``hetu_tpu``'s, on the CPU.

``GPTConfig.tiny`` on two ``hetu_tpu`` weight sets (keys 0 and 1) carried
over by ``params_from_jax``. A swap copies the new weights into the
model's own tensors: the captured lanes are never re-captured, the stale
prefix is flushed, and the tokens after it equal JAX ``generate`` under
the new weights; a busy engine and a mismatched mapping are refused with
every weight bit-unchanged. The prefix cache follows ``hetu_tpu``'s on
the same insert/match/swap sequence. The loop (``start``) serves as
``step`` does, under the policy the lanes were captured under, and a
step that raises surfaces in ``result`` and ``stop``. Every wait has a
deadline and every loop stops in ``finally``.
"""

import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import generate as jax_generate
from hetu_tpu.serving import kv_pool as jax_kv_pool
from hetu_tpu.serving import prefix_cache as jax_prefix_cache

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.core import BF16_FULL, autocast
from hetu_tpu_torch.engine import trace_counts
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from hetu_tpu_torch.serving import SamplingParams, ServingEngine
from hetu_tpu_torch.serving import kv_pool, prefix_cache

torch.set_num_threads(2)

MAX_LEN, CHUNK, BLOCK, NEW = 32, 8, 8, 4
WAIT_S = 20.0


@pytest.fixture(scope="module")
def gpt():
    jmodel = JaxGPT(JaxGPTConfig.tiny())
    p0 = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    p1 = jmodel.init(jax.random.key(1), dtype=jnp.float32)
    cfg = GPTConfig.tiny()
    s0 = params_from_jax(jax.tree.map(np.asarray, p0), cfg)
    s1 = params_from_jax(jax.tree.map(np.asarray, p1), cfg)
    return jmodel, (p0, p1), (s0, s1)


def _model(gpt):
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    model.load_state_dict(gpt[2][0])
    return model


def _engine(model, **kw):
    kw = {"slots": 2, "max_len": MAX_LEN, "prefill_chunk": CHUNK,
          "block_size": BLOCK, "device": "cpu", **kw}
    return ServingEngine(model, **kw)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        1, GPTConfig.tiny().vocab_size, n).tolist()


def _ref(gpt, which, prompt, new=NEW):
    jmodel, params, _ = gpt
    return np.asarray(jax_generate(
        jmodel, params[which], jnp.asarray([prompt], jnp.int32),
        max_new_tokens=new))[0, len(prompt):].tolist()


def _snapshot(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _unchanged(model, snap):
    return all(torch.equal(p, snap[n]) for n, p in model.named_parameters())


def _captures(eng):
    return {k: g.captures for k, g in eng.lanes.items()}


# -- the version-tagged prefix cache --------------------------------------------


def test_prefix_cache_versions_match_jax():
    """The same insert / match / set_version sequence on the port's cache
    and ``hetu_tpu``'s: the same matches, flushed blocks, cached blocks
    and block refcounts at every step."""
    bs, n_blocks = 4, 32
    caches = []
    for kp, pc in ((kv_pool, prefix_cache),
                   (jax_kv_pool, jax_prefix_cache)):
        blocks = kp.BlockManager(n_blocks)
        caches.append((blocks, pc.PrefixCache(bs, blocks)))
    rng = np.random.default_rng(0)
    sys_p = rng.integers(1, 50, 9).tolist()
    seqs = [sys_p + rng.integers(1, 50, n).tolist() for n in (5, 7, 3)]

    def run(blocks, cache):
        log = []
        tables = []
        for v, seq in ((0, seqs[0]), (0, seqs[1]), (1, seqs[2]),
                       (1, seqs[0]), (3, seqs[1])):
            log.append(("set", cache.set_version(v)))
            log.append(("match", cache.match(seq)))
            table = [blocks.alloc() for _ in range(-(-len(seq) // bs))]
            tables.append(table)
            log.append(("insert", cache.insert(seq, table)))
            log.append(("state", cache.cached_blocks, cache.flushes,
                        cache.weight_version, blocks.free_blocks,
                        [int(r) for r in blocks.refs]))
        log.append(("again", cache.set_version(3)))
        log.append(("final", cache.set_version(4), cache.cached_blocks))
        return log

    mine, theirs = (run(*c) for c in caches)
    assert mine == theirs
    assert any(e[0] == "set" and e[1] > 0 for e in mine), "nothing flushed"


# -- swap_params -----------------------------------------------------------------


def test_swap_flushes_stale_prefix_cache(gpt):
    """Twin of ``tests/test_router.py`` ``test_swap_flushes_stale_prefix_
    cache``: after a swap the old weights' cached prefix never serves,
    the same prompt re-caches under the new generation, the tokens equal
    JAX ``generate`` under the new weights, and the lanes are never
    re-captured."""
    model = _model(gpt)
    eng = _engine(model)
    before = trace_counts()
    prompt = _prompt(20, 4)                 # > block_size: cacheable
    sp = SamplingParams(max_tokens=NEW)
    r1 = eng.submit(prompt, sp)
    eng.run_until_drained()
    r2 = eng.submit(prompt, sp)
    eng.run_until_drained()
    assert r2.cached_tokens > 0
    assert list(r2.tokens) == list(r1.tokens) == _ref(gpt, 0, prompt)
    info = eng.swap_params(gpt[2][1])
    assert info["version"] == 1 and info["flushed_blocks"] > 0
    assert eng.weight_version == eng.pool.weight_version == 1
    assert eng.prefix_cache.weight_version == 1
    r3 = eng.submit(prompt, sp)
    eng.run_until_drained()
    assert r3.cached_tokens == 0, "stale prefix served after swap"
    assert r3.weight_version == 1
    assert list(r3.tokens) == _ref(gpt, 1, prompt)
    r4 = eng.submit(prompt, sp)
    eng.run_until_drained()
    assert r4.cached_tokens > 0
    assert list(r4.tokens) == list(r3.tokens)
    assert trace_counts() == before and _captures(eng) == \
        {"decode": 1, "prefill": 1}


def test_swap_on_busy_engine_raises(gpt):
    """Twin of ``test_swap_on_busy_engine_raises``: a swap on an engine
    with work in flight raises and leaves every weight bit-unchanged;
    drained, the same swap succeeds."""
    model = _model(gpt)
    eng = _engine(model)
    eng.submit(_prompt(9, 6), SamplingParams(max_tokens=6))
    eng.step()                                   # admitted, mid-flight
    snap = _snapshot(model)
    with pytest.raises(RuntimeError, match="drain"):
        eng.swap_params(gpt[2][1])
    assert _unchanged(model, snap) and eng.weight_version == 0
    eng.run_until_drained()
    assert eng.swap_params(gpt[2][1])["version"] == 1
    assert eng.pool.weight_version == 1
    assert not _unchanged(model, snap)


def _bad_mappings(s1):
    names = list(s1)
    last = names[-1]
    yield "missing", {k: v for k, v in s1.items() if k != last}
    yield "unknown", {**s1, "blocks.0.attn.extra": s1[last]}
    yield "shape", {**s1, last: s1[last][..., :1]}
    yield "dtype", {**s1, last: s1[last].double()}
    yield "not_a_tensor", {**s1, last: s1[last].numpy()}


@pytest.mark.parametrize("case", [c for c, _ in _bad_mappings(
    {"a.weight": torch.zeros(2, 2)})])
def test_swap_mismatched_mapping_raises_before_any_write(gpt, case):
    """A mapping with a missing or unknown name, or a tensor of another
    shape or dtype (the last name, so every other one would have been
    written first) raises ValueError and writes nothing."""
    model = _model(gpt)
    eng = _engine(model)
    bad = dict(_bad_mappings(gpt[2][1]))[case]
    snap = _snapshot(model)
    with pytest.raises(ValueError, match="swap_params"):
        eng.swap_params(bad)
    assert _unchanged(model, snap)
    assert eng.weight_version == 0 and eng.pool.weight_version == 0


def test_swap_and_back_replays_bit_equal(gpt):
    """Swap to the second weights and back (version 2): the same requests
    served one at a time before the first swap and after the second give
    the same tokens, and no lane is re-captured."""
    model = _model(gpt)
    eng = _engine(model, slots=3)
    prompts = [_prompt(n, 30 + n) for n in (6, 11, 17)]
    sp = SamplingParams(max_tokens=NEW)

    def one_at_a_time():
        return [eng.generate_many([p], sp)[0] for p in prompts]

    first = one_at_a_time()
    assert first == [_ref(gpt, 0, p) for p in prompts]
    before = trace_counts()
    eng.swap_params(gpt[2][1])
    swapped = eng.generate_many(prompts, sp)
    assert swapped == [_ref(gpt, 1, p) for p in prompts]
    assert swapped != first
    info = eng.swap_params({k: v.clone() for k, v in gpt[2][0].items()})
    assert info["version"] == 2 and info["flushed_blocks"] > 0
    assert one_at_a_time() == first
    assert trace_counts() == before


def test_swap_lands_between_loop_iterations(gpt):
    """With the loop running: a swap while a request is in flight is
    refused with the weights unchanged; once drained it lands between two
    iterations, and the loop serves the new weights."""
    model = _model(gpt)
    eng = _engine(model)
    prompt = _prompt(6, 7)
    sp = SamplingParams(max_tokens=24)
    eng.start()
    try:
        snap = _snapshot(model)
        req = eng.submit(prompt, sp)
        assert req.status != "rejected"
        with pytest.raises(RuntimeError, match="drain"):
            eng.swap_params(gpt[2][1])
        assert _unchanged(model, snap)
        assert eng.result(req, timeout=WAIT_S)["tokens"] \
            == _ref(gpt, 0, prompt, 24)
        eng.swap_params(gpt[2][1])
        r2 = eng.submit(prompt, SamplingParams(max_tokens=NEW))
        assert eng.result(r2, timeout=WAIT_S)["tokens"] \
            == _ref(gpt, 1, prompt)
        assert r2.weight_version == 1
    finally:
        eng.stop()


def test_swap_counts_flushed_blocks():
    telemetry.reset()
    telemetry.enable(True)
    try:
        model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu", seed=0)
        eng = _engine(model)
        eng.generate_many([_prompt(17, 3)], SamplingParams(max_tokens=2))
        state = {n: p.detach().clone()
                 for n, p in model.named_parameters()}
        flushed = eng.swap_params(state)["flushed_blocks"]
        assert flushed == 2
        assert telemetry.get_registry().counter(
            "serving_prefix_flushed_total").value() == flushed
    finally:
        telemetry.enable(False)
        telemetry.reset()


# -- the engine's lifecycle verbs ------------------------------------------------


def test_cancel_queued_releases_a_preempted_spill(gpt):
    """``cancel_queued`` takes a preempted request (queued for resume) out
    with its spill: the engine's arena lets it go, the request keeps the
    entry, and a second engine resumes it to JAX ``generate``'s tokens."""
    model = _model(gpt)
    eng = ServingEngine(model, slots=1, max_len=MAX_LEN,
                        prefill_chunk=CHUNK, device="cpu")
    lo_p, hi_p = _prompt(20, 8), _prompt(8, 9)
    lo = eng.submit(lo_p, SamplingParams(max_tokens=8, priority=2))
    while len(lo.tokens) < 2:
        eng.step()
    hi = eng.submit(hi_p, SamplingParams(max_tokens=4, priority=0))
    eng.step()
    assert lo.status == "preempted" and eng.spill_arena.blocks_held > 0
    assert eng.cancel_queued({lo.id, 999}) == [lo]
    assert lo.status == "cancelled" and lo.spill is not None
    assert eng.spill_arena.blocks_held == 0
    eng.run_until_drained()
    assert list(hi.tokens) == _ref(gpt, 0, hi_p)
    other = ServingEngine(model, slots=1, max_len=MAX_LEN,
                          prefill_chunk=CHUNK, device="cpu")
    moved = other.submit(lo_p, SamplingParams(max_tokens=8),
                         resume=lo.spill)
    other.run_until_drained()
    assert moved.resumed_blocks >= 1
    assert list(moved.tokens) == _ref(gpt, 0, lo_p, 8)
    assert eng.cancel_queued() == [] and not eng.has_work()


def test_load_and_trace_ids(gpt):
    eng = _engine(_model(gpt))
    reqs = [eng.submit(_prompt(5, i), SamplingParams(max_tokens=3))
            for i in range(3)]
    assert eng.load == 3
    tagged = eng.submit(_prompt(5, 9), SamplingParams(max_tokens=3),
                        traceparent="00ab12cd34ef-1234abcd")
    junk = eng.submit(_prompt(5, 9), SamplingParams(max_tokens=3),
                      traceparent="not-a-token")
    assert tagged.trace_id == "00ab12cd34ef"
    assert tagged.traceparent == "00ab12cd34ef-1234abcd"
    assert len(junk.trace_id) == 12 and junk.traceparent is None
    assert len({r.trace_id for r in reqs}) == 3
    eng.step()
    assert eng.load == 5
    eng.run_until_drained()
    assert eng.load == 0
    assert tagged.result()["timing"]["trace_id"] == "00ab12cd34ef"
    assert list(tagged.result()["timing"])[0] == "trace_id"


# -- the background loop ---------------------------------------------------------


def test_generate_many_with_loop_equals_without(gpt):
    model = _model(gpt)
    prompts = [_prompt(n, 40 + n) for n in (3, 9, 14, 20, 6)]
    sp = SamplingParams(max_tokens=5)
    want = _engine(model).generate_many(prompts, sp)
    eng = _engine(model)
    eng.start()
    try:
        assert eng.generate_many(prompts, sp) == want
        assert eng.lane_iters["decode"] > 0
    finally:
        eng.stop()
    assert eng._thread is None
    assert want == [_ref(gpt, 0, p, 5) for p in prompts]


def test_bf16_loop_steps_under_the_build_policy():
    """An engine built under ``autocast(BF16_FULL)`` and started from a
    thread under the default policy serves what ``step`` serves under the
    build policy, with no capture after construction (a loop stepping
    under FP32 would re-capture both lanes)."""
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu",
                           dtype=torch.bfloat16, seed=0)
    prompts = [_prompt(n, 50 + n) for n in (4, 11, 19)]
    sp = SamplingParams(max_tokens=5)
    with autocast(BF16_FULL):
        want = _engine(model).generate_many(prompts, sp)
        eng = _engine(model)
    before = trace_counts()
    eng.start()
    try:
        assert eng.generate_many(prompts, sp) == want
    finally:
        eng.stop()
    assert trace_counts() == before
    assert _captures(eng) == {"decode": 1, "prefill": 1}
    assert eng.lanes["decode"].policy == BF16_FULL


def test_loop_error_surfaces_in_result_and_stop(gpt):
    """A step that raises ends the loop: the pending request's ``result``
    raises the error (no hang), and so does ``stop``."""
    eng = _engine(_model(gpt))

    def broken():
        raise ValueError("planted replay failure")

    eng.lanes["decode"].replay = broken
    eng.start()
    try:
        req = eng.submit(_prompt(5, 1), SamplingParams(max_tokens=4))
        with pytest.raises(RuntimeError, match="serving loop died"):
            eng.result(req, timeout=WAIT_S)
        assert not req.done.is_set()
    finally:
        with pytest.raises(RuntimeError, match="planted replay failure"):
            eng.stop()
    assert eng._thread is None


def test_concurrent_submits_under_a_short_switch_interval(gpt):
    """More client threads than cores submit while the loop steps, with
    the interpreter switching threads every 10 µs: every request gets a
    distinct id and exactly the tokens it gets alone, and the engine
    drains (a lost update to the queue, the id counter or a slot would
    break one of these)."""
    model = _model(gpt)
    prompts = [_prompt(3 + i % 9, 60 + i) for i in range(24)]
    sp = SamplingParams(max_tokens=NEW)
    want = _engine(model).generate_many(prompts, sp)
    eng = _engine(model)
    got: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        def client(k):
            for i in range(k, len(prompts), 8):
                req = eng.submit(prompts[i], sp)
                got[i] = (req.id, eng.result(req, timeout=WAIT_S)["tokens"])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S * 2)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert sorted(i for i, _ in got.values()) == list(range(len(prompts)))
    assert [got[i][1] for i in range(len(prompts))] == want
    assert eng.load == 0 and not eng.has_work()
