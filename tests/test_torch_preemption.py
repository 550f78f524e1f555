"""The port's QoS preemption — the class shares, the preemption victim,
requeue at the head, the resume plan, the host spill arena and the
engine's spill, resume and evict paths — against ``hetu_tpu``'s, on the CPU.

- Host logic: one seeded trace of mixed-priority requests (the deficit
  selection, ``peek_candidate``, ``preemption_victim``,
  ``requeue_preempted``, spill resumes) must admit the same requests into
  the same slots and blocks in both packages; the spill arena's ledgers
  must match JAX's over the same put/pop sequence. The single cases mirror
  ``tests/test_spec_qos.py:241-383`` and ``tests/test_fleet_kv.py:70-157``.
- The slice: both engines serve the same weights (``params_from_jax``)
  under the same submission schedule. A batch request decoding when an
  interactive one arrives is preempted, spilled and resumed: the same
  victims at the same iterations, the same block counts, the same tokens
  (equal to one-shot ``generate``), the same prefill chunks and the
  ``preempted → admit → resumed`` trail, and every arena tensor keeps its
  address. The spilled KV agrees with JAX's ``SpillEntry.data`` (fp32:
  atol 1e-6; int8: code for code, scales at rtol 1e-5).
- A sampled victim resumes to the tokens it draws unpreempted; a request
  evicted from one engine resumes on another with no prefill.
"""

import threading

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
from hetu_tpu.serving import kv_pool as jax_kv_pool
from hetu_tpu.serving import prefix_cache as jax_prefix_cache
from hetu_tpu.serving import scheduler as jax_scheduler

from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel, generate,
    params_from_jax,
)
from hetu_tpu_torch.serving import SamplingParams, ServingEngine
from hetu_tpu_torch.serving import kv_pool, prefix_cache, scheduler
from hetu_tpu_torch.serving.kv_pool import (
    HostSpillArena, SpillEntry, SpillStore,
)

torch.set_num_threads(2)

JAX_MODS = (jax_kv_pool, jax_prefix_cache, jax_scheduler)
PORT_MODS = (kv_pool, prefix_cache, scheduler)


def _mk(sch, i, plen, max_tokens=4, priority=1):
    return sch.Request(id=i, prompt=np.arange(1, plen + 1, dtype=np.int32),
                       sampling=sch.SamplingParams(max_tokens=max_tokens,
                                                   priority=priority),
                       submit_s=0.0)


# ---------------------------------------------------------------------------
# host logic: the QoS scheduler
# ---------------------------------------------------------------------------

def _sched(mods, slots, n_blocks, block_size, **kw):
    kvp, pcm, sch = mods
    blocks = kvp.BlockManager(n_blocks)
    return sch.Scheduler(slots, 64, blocks=blocks,
                         prefix_cache=pcm.PrefixCache(block_size, blocks),
                         block_size=block_size, **kw)


def test_single_class_stays_exact_fcfs():
    sched = _sched(PORT_MODS, 2, 9, 16)
    for i in range(4):
        assert sched.submit(_mk(scheduler, i, 4))
    a = sched.next_admission()
    b = sched.next_admission()
    assert (a[0].id, b[0].id) == (0, 1)
    assert sched.next_admission() is None      # no free slot
    sched.release(a[1], table=a[0].admit["table"])
    assert sched.next_admission()[0].id == 2


def test_deficit_weighted_classes():
    sched = _sched(PORT_MODS, 1, 64, 4)
    for i in range(8):
        assert sched.submit(_mk(scheduler, i, 4, priority=0))
    for i in range(8, 16):
        assert sched.submit(_mk(scheduler, i, 4, priority=2))
    order = []
    for _ in range(12):
        req, slot = sched.next_admission()
        order.append(req.sampling.priority)
        sched.release(slot, table=req.admit["table"])
    assert order[0] == 0
    assert 2 in order[:8]
    both = order[:10]
    assert both.count(0) >= 3 * both.count(2) >= 3
    sched2 = _sched(PORT_MODS, 1, 64, 4)
    for i, pr in enumerate([2, 0, 2, 0]):
        sched2.submit(_mk(scheduler, i, 4, priority=pr))
    req, _ = sched2.next_admission()
    assert (req.id, req.sampling.priority) == (1, 0)


def test_preemption_victim_selection():
    sched = _sched(PORT_MODS, 2, 16, 4)
    cand = _mk(scheduler, 0, 4, priority=0)
    v1, v2 = (_mk(scheduler, 1, 4, priority=2),
              _mk(scheduler, 2, 4, priority=2))
    v1.tokens = [7, 8, 9]
    v2.tokens = [7]
    assert sched.preemption_victim(cand, [(0, v1), (1, v2)]) == 1
    same = _mk(scheduler, 3, 4, priority=2)
    assert sched.preemption_victim(same, [(0, v1), (1, v2)]) is None
    hi = _mk(scheduler, 4, 4, priority=0)
    assert sched.preemption_victim(_mk(scheduler, 5, 4, priority=1),
                                   [(0, hi)]) is None


def _admission_order(mods, priorities):
    sched = _sched(mods, 1, 64, 4)
    for i, pr in enumerate(priorities):
        sched.submit(_mk(mods[2], i, 4, priority=pr))
    order = []
    while (adm := sched.next_admission()) is not None:
        order.append(adm[0].id)
        sched.release(adm[1], table=adm[0].admit["table"])
    return order, dict(sched._credit)


@pytest.mark.parametrize("priorities", [[2, 0] * 6, [3, 1, 0, 2, 1, 0] * 3],
                         ids=["two_classes", "four_classes"])
def test_class_shares_match_jax(priorities):
    """The ``2^-c`` shares admit backlogged classes in JAX's order and
    leave JAX's credits."""
    got = _admission_order(PORT_MODS, priorities)
    assert got == _admission_order(JAX_MODS, priorities)
    assert sorted(got[0]) == list(range(len(priorities)))


def test_requeue_preempted_resumes_before_class_peers():
    sched = _sched(PORT_MODS, 1, 16, 4)
    sched.submit(_mk(scheduler, 0, 4, priority=1))
    sched.submit(_mk(scheduler, 1, 4, priority=1))
    victim = _mk(scheduler, 9, 4, priority=1)
    victim.tokens = [3]
    sched.requeue_preempted(victim)
    assert victim.status == "preempted"
    assert sched.next_admission()[0].id == 9


def _trace(mods, seed):
    """Drive a scheduler over one seeded trace: mixed-priority arrivals
    with a shared system prompt, a tight arena, and at every round the
    engine's preemption planner (``peek_candidate`` → ``preemption_
    victim`` over the running requests; the victim's blocks are released
    and it is requeued with a spill marker, so it comes back through the
    resume plan). Returns the log of every decision."""
    kvp, pcm, sch = mods
    blocks = kvp.BlockManager(30)
    cache = pcm.PrefixCache(4, blocks)
    sched = sch.Scheduler(4, 64, blocks=blocks, prefix_cache=cache,
                          block_size=4)
    rng = np.random.default_rng(seed)
    system = rng.integers(1, 100, 9).tolist()
    log, running, nid = [], {}, 0
    for rnd in range(40):
        for _ in range(int(rng.integers(0, 3)) if rnd < 25 else 0):
            tail = rng.integers(1, 100, int(rng.integers(1, 10))).tolist()
            prompt = system + tail if nid % 2 else tail
            req = sch.Request(
                id=nid, prompt=np.asarray(prompt, np.int32),
                sampling=sch.SamplingParams(
                    max_tokens=int(rng.integers(2, 9)),
                    priority=int(rng.integers(0, 3))), submit_s=0.0)
            nid += 1
            log.append(("submit", req.id, sched.submit(req)))
        while (adm := sched.next_admission()) is not None:
            req, slot = adm
            plan = req.admit
            log.append(("admit", req.id, slot, list(plan["table"]),
                        plan["first_uncached"], plan.get("resume", False),
                        blocks.free_blocks))
            if not plan.get("resume"):
                cache.insert(req.prompt.tolist(), plan["table"])
            req.spill = None
            running[slot] = req
        cand = sched.peek_candidate()
        if cand is not None:
            victim = sched.preemption_victim(
                cand, sorted(running.items()))
            log.append(("peek", cand.id, sched.blocks_needed(cand), victim))
            if victim is not None:
                req = running.pop(victim)
                sched.release(victim, table=req.admit["table"])
                req.spill = "spilled"
                sched.requeue_preempted(req)
                sched.preemptions_total += 1
        for slot, req in sorted(running.items()):
            req.tokens.append(rnd)
            if len(req.tokens) >= req.sampling.max_tokens:
                del running[slot]
                sched.release(slot, table=req.admit["table"])
                log.append(("finish", req.id))
    log.append(("totals", sched.preemptions_total, sched.evictions_total,
                dict(sched._credit)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_qos_trace_matches_jax(seed):
    want = _trace(JAX_MODS, seed)
    got = _trace(PORT_MODS, seed)
    assert got == want
    kinds = [e[0] for e in got]
    assert kinds.count("admit") > kinds.count("submit") // 2
    assert any(e[0] == "admit" and e[5] for e in got)       # resumes
    assert got[-1][1] >= 1 and got[-1][2] >= 1   # preemptions, evictions


# ---------------------------------------------------------------------------
# host logic: the spill arena
# ---------------------------------------------------------------------------

def _entry(mod, req_id, nb, *, ver=0, bs=16, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((2, nb, bs, 2, 4)).astype(np.float32)
              for _ in range(2)]
    data = tuple(arrays) if mod is jax_kv_pool \
        else tuple(torch.from_numpy(a) for a in arrays)
    return mod.SpillEntry(req_id=req_id, data=data, n_blocks=nb,
                          block_size=bs, pos=8, last_tok=3, tokens=[3],
                          weight_version=ver)


def _ledgers(arena):
    return (arena.blocks_held, arena.spilled_total, arena.resumed_total,
            len(arena))


def _arena_run(mod):
    """One put/pop/can_fit sequence over a bounded arena, then over an
    unbounded one. Returns the ledgers after every operation and the ids
    each pop returned."""
    out = []
    arena = mod.HostSpillArena(max_blocks=3)
    out.append(("fit", arena.can_fit(3), arena.can_fit(4)))
    arena.put(_entry(mod, 0, 2))
    out.append(_ledgers(arena))
    try:
        arena.put(_entry(mod, 1, 2))
    except ValueError as e:
        out.append(("full", str(e)))
    arena.put(_entry(mod, 1, 1))
    out.append(("pop", arena.pop(0).req_id, _ledgers(arena)))
    out.append(("pop", arena.pop(1, resumed=False).req_id, _ledgers(arena)))
    out.append(("unbounded", mod.HostSpillArena(None).can_fit(10 ** 9)))
    host = mod.HostSpillArena()
    for rid, nb in ((1, 2), (2, 2), (3, 2), (9, 6)):
        host.put(_entry(mod, rid, nb, seed=rid))
        out.append(("put", rid, _ledgers(host)))
    out.append(("has", 1 in host, 5 in host, host.get(1).req_id,
                host.get(5)))
    for rid in (1, 9, 3, 5):
        got = host.pop(rid, resumed=rid != 3)
        out.append(("pop", rid, None if got is None else got.n_blocks,
                    _ledgers(host)))
    try:
        host.put(_entry(mod, 2, 1))
    except ValueError as e:
        out.append(("again", str(e)))
    lone = mod.HostSpillArena(max_blocks=2)
    lone.put(_entry(mod, 1, 2))
    out.append(("lone", lone.can_fit(1)))
    return out


def test_spill_arena_ledgers_match_jax():
    want, got = _arena_run(jax_kv_pool), _arena_run(kv_pool)
    assert got == want
    assert ("full", "spill arena full: 2 + 2 blocks exceed max_blocks=3") \
        in got


def test_spill_arena_keeps_the_pages():
    host = HostSpillArena(max_blocks=6)
    for rid in (1, 2, 3):
        host.put(_entry(kv_pool, rid, 2, seed=rid))
    assert not host.can_fit(1)
    got = host.pop(1)
    assert host.can_fit(2) and host.resumed_total == 2
    ref = _entry(kv_pool, 1, 2, seed=1)
    assert all(torch.equal(a, b) for a, b in zip(got.data, ref.data))
    assert got.nbytes() == 2 * 2 * 2 * 16 * 2 * 4 * 4


def test_spill_store_takes_and_coalesces():
    """First-fit runs of consecutive blocks, each seen in the arena's
    layout; released runs merge, so a freed range is taken again."""
    caches = (torch.zeros((2, 9, 4, 2, 3), dtype=torch.int8),
              torch.zeros((2, 9, 4, 2)))
    store = SpillStore(caches, 6, pin=False)
    assert store.nbytes() == 6 * (2 * 4 * 2 * 3 + 2 * 4 * 2 * 4)
    a, b = store.take(3), store.take(2)
    assert [t.shape for t in a] == [(2, 3, 4, 2, 3), (2, 3, 4, 2)]
    assert all(t.is_contiguous() for t in a + b)
    assert store.take(2) is None                  # one block left
    for i, t in enumerate(a + b):
        t.fill_(i + 1)
    assert all(bool((t == i + 1).all()) for i, t in enumerate(a + b))
    assert store.owns(a) and not store.owns(tuple(t.clone() for t in a))
    store.release(a)
    again = store.take(3)
    assert again[0].data_ptr() == a[0].data_ptr()
    store.release(b)
    store.release(again)
    assert store.take(6) is not None and store.take(1) is None


def test_spill_entry_compatibility_gates():
    class Pool:
        block_size = 16
        caches = (torch.zeros((2, 9, 16, 2, 4)),
                  torch.zeros((2, 9, 16, 2, 4)))

    e = _entry(kv_pool, 0, 2, ver=3)
    assert e.compatible_with(Pool(), 3)
    assert not e.compatible_with(Pool(), 4)      # weight version moved

    class Pool8(Pool):
        block_size = 8
    assert not e.compatible_with(Pool8(), 3)     # layout mismatch

    class PoolQ(Pool):
        caches = (torch.zeros((2, 9, 16, 2, 4), dtype=torch.int8),) * 4
    assert not e.compatible_with(PoolQ(), 3)     # dtype/leaf mismatch


# ---------------------------------------------------------------------------
# the slice: both engines preempt, spill and resume alike
# ---------------------------------------------------------------------------

MODELS = {"gpt": (JaxGPTConfig, JaxGPT, GPTConfig, GPTLMHeadModel),
          "llama": (JaxLlamaConfig, JaxLlama, LlamaConfig, LlamaLMHeadModel)}

#: (model, cache, engine kwargs, batch (prompt, max_tokens) list, steps
#: before the interactive arrivals, interactive list)
SCHEDULES = {
    # tests/test_spec_qos.py:550: one slot, the arrival finds it taken
    "one_slot": ("gpt", "fp32", dict(slots=1, max_len=32, prefill_chunk=8),
                 [(10, 16)], 6, [(8, 4)]),
    # more slots than worst cases: one arrival admits into free blocks,
    # the next finds no slot and preempts; a queued batch request waits
    # behind the requeued victim
    "oversubscribed": ("gpt", "fp32",
                       dict(slots=3, max_len=32, prefill_chunk=8,
                            block_size=8, kv_blocks=9),
                       [(10, 12), (9, 12), (11, 12)], 4, [(6, 4), (5, 4)]),
    "llama_int8": ("llama", "int8", dict(slots=1, max_len=32,
                                         prefill_chunk=8),
                   [(10, 16)], 6, [(8, 4)]),
    # a bounded host arena: the port parks the bytes in its spill store;
    # two arrivals preempt both batch requests, parked side by side
    "bounded_store": ("gpt", "fp32",
                      dict(slots=2, max_len=32, prefill_chunk=8,
                           block_size=8, kv_blocks=9,
                           spill_host_budget_bytes=1e6),
                      [(10, 12), (9, 12)], 4, [(6, 4), (5, 4)]),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jcfg_cls, jcls, cfg_cls, cls) in MODELS.items():
        jmodel = jcls(jcfg_cls.tiny())
        params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
        cfg = cfg_cls.tiny()
        model = cls(cfg, device="cpu")
        model.load_state_dict(
            params_from_jax(jax.tree.map(np.asarray, params), cfg))
        out[name] = (jmodel, params, model)
    return out


def _generate(model, prompt, n, cache_dtype=None):
    """One-shot greedy ``generate``: the ``n`` new tokens."""
    out = generate(model, [prompt], max_new_tokens=n, device="cpu",
                   cache_dtype=cache_dtype)
    return out[0, len(prompt):].tolist()


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def _drive(eng, sp_cls, batch, n_before, urgent, vocab):
    """Submit the batch requests (priority 2), step ``n_before`` times,
    submit the interactive ones (priority 0), step to drain. Returns the
    requests, a per-iteration log of what each request went through and
    the first spill entry of each victim (taken while it is queued, with
    a copy of its data: a spill store reuses the bytes after the
    resume)."""
    lo = [eng.submit(p, sp_cls(max_tokens=m, priority=2)) for p, m in
          zip(_prompts(vocab, [n for n, _ in batch], 1),
              [m for _, m in batch])]
    reqs = list(lo)
    log, spills, it = [], {}, 0

    def step():
        nonlocal it
        eng.step()
        it += 1
        log.append([(r.id, r.status, len(r.tokens), r.preemptions,
                     r.spilled_blocks, r.resumed_blocks) for r in reqs])
        for r in reqs:
            if r.spill is not None and r.id not in spills:
                spills[r.id] = (it, r.spill,
                                [np.array(d) for d in r.spill.data])

    for _ in range(n_before):
        step()
    reqs += [eng.submit(p, sp_cls(max_tokens=m, priority=0)) for p, m in
             zip(_prompts(vocab, [n for n, _ in urgent], 2),
                 [m for _, m in urgent])]
    while eng.has_work():
        step()
    return reqs, log, spills


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_preempt_spill_resume_matches_jax_engine(models, case):
    name, cache, kw, batch, n_before, urgent = SCHEDULES[case]
    jmodel, params, model = models[name]
    vocab = model.cfg.vocab_size
    jeng = JaxServingEngine(
        jmodel, params, prefill_attn="flash",
        cache_dtype=jnp.int8 if cache == "int8" else jnp.float32, **kw)
    jreqs, jlog, jspills = _drive(jeng, JaxSamplingParams, batch, n_before,
                                  urgent, vocab)
    eng = ServingEngine(model, device="cpu",
                        cache_dtype=torch.int8 if cache == "int8" else None,
                        **kw)
    ptrs = [c.data_ptr() for c in eng.pool.caches]
    reqs, log, spills = _drive(eng, SamplingParams, batch, n_before, urgent,
                               vocab)

    # the same victims at the same iterations, the same block counts and
    # tokens, every step of the way
    assert log == jlog
    victims = [r for r in reqs if r.preemptions]
    assert victims and sorted(spills) == sorted(jspills)
    for r, jr in zip(reqs, jreqs):
        assert r.tokens == jr.tokens
        assert r.timing()["prefill_chunks"] == jr.timing()["prefill_chunks"]
        assert [p for p, _, _ in r.events] == [p for p, _, _ in jr.events]
        assert r.tokens == _generate(model, r.prompt.tolist(),
                                     r.sampling.max_tokens,
                                     eng.pool.cache_dtype)
    for r in victims:
        # zero prefill on resume: the original chunks only, and the trail
        # preempted -> admit -> resumed with no prefill between
        plen = len(r.prompt)
        assert r.timing()["prefill_chunks"] == -(-plen // kw["prefill_chunk"])
        phases = [p for p, _, _ in r.events]
        i = phases.index("preempted")
        assert phases[i:i + 3] == ["preempted", "admit", "resumed"]
        assert r.resumed_blocks == r.spilled_blocks >= 1
        t = r.timing()
        assert t["resumed"] and t["preemptions"] == r.preemptions
    # the spilled KV agrees with JAX's, leaf for leaf
    for rid, (it, entry, data) in spills.items():
        jit_, jentry, jdata = jspills[rid]
        assert it == jit_ and entry.n_blocks == jentry.n_blocks
        assert (entry.pos, entry.last_tok) == (jentry.pos, jentry.last_tok)
        for i, (a, b) in enumerate(zip(data, jdata)):
            assert a.shape == b.shape and a.dtype == b.dtype
            if cache == "int8" and i % 2 == 0:
                np.testing.assert_array_equal(a, b)
            elif cache == "int8":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # the arena was written in place and drained; the ledgers agree
    assert [c.data_ptr() for c in eng.pool.caches] == ptrs
    arena, jarena = eng.spill_arena, jeng.spill_arena
    assert arena.blocks_held == 0 == jarena.blocks_held
    assert (arena.spilled_total, arena.resumed_total) \
        == (jarena.spilled_total, jarena.resumed_total) != (0, 0)
    assert eng.scheduler.preemptions_total \
        == jeng.scheduler.preemptions_total >= 1
    assert eng.blocks.free_blocks + sum(
        1 for b in range(1, eng.blocks.n_blocks)
        if eng.blocks.refs[b] > 0) == eng.blocks.n_blocks - 1
    assert not eng.has_work() and not eng.scheduler.queue


@pytest.mark.parametrize("budget", [None, 1e6], ids=["fresh", "store"])
def test_resume_writes_the_arena_in_place(models, budget):
    """The resume's scatter lands in the tensors the lanes captured: the
    restored blocks equal the host copy (fresh buffers, or the spill
    store's) and the blocks before the spill, over the victim's ``pos``
    rows, every leaf."""
    _, _, model = models["llama"]
    eng = ServingEngine(model, slots=1, max_len=32, prefill_chunk=8,
                        cache_dtype=torch.int8, device="cpu",
                        spill_host_budget_bytes=budget)
    caches = eng.pool.caches
    ptrs = [c.data_ptr() for c in caches]
    lo_p, hi_p = _prompts(model.cfg.vocab_size, [12, 6], 4)
    lo = eng.submit(lo_p, SamplingParams(max_tokens=12, priority=2))
    for _ in range(5):
        eng.step()
    nb = -(-int(eng._pos[0]) // eng.pool.block_size)
    before = [c[:, eng._bt[0, :nb]].clone() for c in caches]
    eng.submit(hi_p, SamplingParams(max_tokens=2, priority=0))
    eng.step()
    entry = lo.spill
    assert entry is not None and entry.n_blocks == nb
    assert (budget is not None) == (eng.spill_store is not None
                                    and eng.spill_store.owns(entry.data))
    for a, b in zip(entry.data, before):
        assert torch.equal(a, b)
    while lo.status != "decode":
        eng.step()
    rows = entry.pos
    for c, src, old in zip(caches, entry.data, before):
        now = c[:, eng._bt[0, :nb]].flatten(1, 2)[:, :rows]
        assert torch.equal(now, src.flatten(1, 2)[:, :rows])
        assert torch.equal(now, old.flatten(1, 2)[:, :rows])
    assert [c.data_ptr() for c in caches] == ptrs
    eng.run_until_drained()
    assert lo.tokens == _generate(model, lo_p, 12, torch.int8)


def test_spill_store_holds_parked_blocks(models):
    """With a bounded host arena a preempted request's bytes live in the
    engine's spill store; evicting it while queued hands out a copy of
    them and gives the blocks back, as does a resume."""
    _, _, model = models["gpt"]
    lo_p, hi_p = _prompts(model.cfg.vocab_size, [20, 8], 10)
    eng = ServingEngine(model, slots=1, max_len=32, prefill_chunk=8,
                        spill_host_budget_bytes=1e6, device="cpu")
    store = eng.spill_store
    assert store.max_blocks == eng.pool.n_blocks - 1
    lo_sp = SamplingParams(max_tokens=8, priority=2)
    hi_sp = SamplingParams(max_tokens=4, priority=0)
    for evict in (True, False):
        lo = eng.submit(lo_p, lo_sp)
        _step_until(eng, lambda: len(lo.tokens) >= 3)
        eng.submit(hi_p, hi_sp)
        eng.step()
        data = lo.spill.data
        assert lo.status == "preempted" and store.owns(data)
        if evict:
            kept = [d.clone() for d in data]
            entry = eng.evict_request(lo)
            assert not store.owns(entry.data)
            assert all(torch.equal(x, y) for x, y in zip(entry.data, kept))
        assert store._free == [(0, store.max_blocks)] or not evict
        eng.run_until_drained()
        assert store._free == [(0, store.max_blocks)]
    assert lo.status == "done" and lo.resumed_blocks == lo.spilled_blocks
    assert lo.tokens == _generate(model, lo_p, lo_sp.max_tokens)
    assert ServingEngine(model, slots=1, max_len=32, device="cpu",
                         preempt=False,
                         spill_host_budget_bytes=1e6).spill_store is None


def test_sampled_victim_resumes_its_draws(models):
    """A sampled request (its own generator) preempted mid-decode draws
    the same tokens as the same request unpreempted."""
    _, _, model = models["gpt"]
    lo_p, hi_p = _prompts(model.cfg.vocab_size, [10, 8], 5)
    sp = SamplingParams(max_tokens=16, priority=2, temperature=0.9,
                        top_k=20, seed=7)
    runs = {}
    for preempt in (True, False):
        eng = ServingEngine(model, slots=1, max_len=32, prefill_chunk=8,
                            device="cpu", preempt=preempt)
        lo = eng.submit(lo_p, sp)
        for _ in range(6):
            eng.step()
        eng.submit(hi_p, SamplingParams(max_tokens=4, priority=0))
        eng.run_until_drained()
        assert lo.preemptions == int(preempt)
        runs[preempt] = lo.tokens
    assert runs[True] == runs[False]
    assert len(set(runs[True])) > 1


def test_evict_and_resume_on_another_engine(models):
    """``evict_request`` on engine A, ``submit(..., resume=entry)`` on
    engine B: JAX's tokens, no prefill on B. An entry B cannot take (a
    moved weight version) degrades to a fresh replay, same tokens."""
    jmodel, params, model = models["gpt"]
    prompt = _prompts(model.cfg.vocab_size, [13], 6)[0]
    want = np.asarray(jax_generate(
        jmodel, params, jnp.asarray([prompt], jnp.int32),
        max_new_tokens=12))[0, len(prompt):].tolist()
    kw = dict(slots=2, max_len=32, prefill_chunk=8, device="cpu")
    a = ServingEngine(model, **kw)
    req = a.submit(prompt, SamplingParams(max_tokens=12))
    for _ in range(5):
        a.step()
    assert req.status == "decode" and 1 < len(req.tokens) < 12
    entry = a.evict_request(req)
    assert req.status == "evicted" and not req.done.is_set()
    assert entry.n_blocks == -(-entry.pos // a.pool.block_size)
    assert not a.has_work() and a.blocks.blocks_in_use == \
        sum(1 for b in range(1, a.blocks.n_blocks)
            if a.blocks.refs[b] > 0)
    b = ServingEngine(model, **kw)
    moved = b.submit(prompt, SamplingParams(max_tokens=12), resume=entry)
    b.run_until_drained()
    assert moved.tokens == want
    assert moved.timing()["prefill_chunks"] == 0
    assert moved.resumed_blocks == entry.n_blocks
    stale = SpillEntry(**{**entry.__dict__, "weight_version": 1})
    c = ServingEngine(model, **kw)
    fresh = c.submit(prompt, SamplingParams(max_tokens=12), resume=stale)
    c.run_until_drained()
    assert fresh.tokens == want and fresh.timing()["prefill_chunks"] == 2
    assert fresh.resumed_blocks == 0


def _step_until(eng, cond, limit=100):
    for _ in range(limit):
        if cond():
            return
        eng.step()
    raise AssertionError("condition not reached")


def test_evict_queued_and_prefilling_requests(models):
    """A fresh queued or prefilling request has no KV worth moving; a
    preempted one still queued carries its spill out (not counted as a
    resume here), while one left alone resumes to ``generate``'s tokens;
    a held lock makes ``evict_request`` give up after
    ``lock_timeout_s``."""
    _, _, model = models["gpt"]
    lo_p, hi_p, other = _prompts(model.cfg.vocab_size, [20, 8, 9], 8)
    eng = ServingEngine(model, slots=1, max_len=32, prefill_chunk=8,
                        device="cpu")
    lo_sp = SamplingParams(max_tokens=8, priority=2)
    hi_sp = SamplingParams(max_tokens=4, priority=0)
    lo = eng.submit(lo_p, lo_sp)
    queued = eng.submit(other, SamplingParams(max_tokens=4, priority=2))
    assert len(eng.scheduler.queue) == 2
    assert eng.evict_request(queued) is None and queued.status == "evicted"
    eng.step()                                    # lo's first chunk
    assert lo.status == "prefill"
    assert eng.evict_request(lo) is None and lo.status == "evicted"
    assert eng.blocks.blocks_in_use == 0 and not eng.has_work()

    def preempted_victim():
        lo = eng.submit(lo_p, lo_sp)
        _step_until(eng, lambda: len(lo.tokens) >= 2)
        hi = eng.submit(hi_p, hi_sp)
        eng.step()
        assert lo.status == "preempted" and lo.spill is not None
        assert eng.spill_arena.blocks_held == lo.spill.n_blocks
        return lo, hi

    lo, hi = preempted_victim()
    entry = eng.evict_request(lo)
    assert entry is not None and entry is lo.spill
    assert eng.spill_arena.blocks_held == 0
    assert eng.spill_arena.resumed_total == 0
    eng.run_until_drained()
    assert hi.status == "done" and lo.status == "evicted"
    lo, hi = preempted_victim()               # left to resume here
    eng.run_until_drained()
    assert (hi.status, lo.status) == ("done", "done")
    assert lo.resumed_blocks == lo.spilled_blocks >= 1
    assert lo.tokens == _generate(model, lo_p, lo_sp.max_tokens)

    late = eng.submit(other, SamplingParams(max_tokens=4, priority=2))
    held, release = threading.Event(), threading.Event()

    def hold():
        with eng._lock:
            held.set()
            release.wait(5)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(5)
        assert eng.evict_request(late, lock_timeout_s=0.01) is None
        assert late.status == "queued"           # untouched: no lock
    finally:
        release.set()
        t.join(5)
    assert not t.is_alive()
    assert eng.evict_request(late, lock_timeout_s=1.0) is None
    assert late.status == "evicted" and not eng.has_work()


def test_uniform_priority_never_preempts(models):
    """With preemption on (the default), traffic of one class keeps the
    run-to-completion guarantee: nothing is spilled."""
    _, _, model = models["gpt"]
    prompts = _prompts(model.cfg.vocab_size, [10, 8, 12, 6], 9)
    eng = ServingEngine(model, slots=1, max_len=32, prefill_chunk=8,
                        device="cpu")
    out = eng.generate_many(prompts, SamplingParams(max_tokens=5))
    assert eng.scheduler.preemptions_total == 0
    assert eng.spill_arena.spilled_total == 0
    for p, toks in zip(prompts, out):
        assert toks == _generate(model, p, 5)
