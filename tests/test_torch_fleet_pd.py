"""The port's prefill/decode split against ``hetu_tpu``'s, on the CPU.

The scheduler's side decision for decision: a handoff request is priced
at its prompt and one token, and classes share admissions, as
``hetu_tpu``'s scheduler does on the same requests. The engine's side
(``GPTConfig.tiny`` fp32 with ``hetu_tpu``'s weights, ``slots=2,
max_len=32, prefill_chunk=8``): ``submit(handoff=True)`` parks the
request after its first token (status ``"prefilled"``, no load, its
blocks held), ``prefill_only`` returns its KV, and a decode engine
resumes it to JAX ``generate``'s tokens. Through a Router with a
prefill-role and a decode-role replica every request is handed over once
(``fleet_pd_handoffs_total``), its tokens equal JAX's and the colocated
fleet's, and each replica captured each lane once. Every wait has a
deadline; no assertion reads a clock.
"""

import time

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
from hetu_tpu.serving import scheduler as jax_scheduler

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from hetu_tpu_torch.serving import (
    Router, SamplingParams, ServingEngine, kv_pool, prefix_cache, scheduler,
    spill_from_wire, spill_to_wire,
)

torch.set_num_threads(2)

MAX_LEN, CHUNK = 32, 8
#: the deadline of every wait in this file
WAIT_S = 60.0

JAX_MODS = (jax_kv_pool, jax_prefix_cache, jax_scheduler)
PORT_MODS = (kv_pool, prefix_cache, scheduler)


# -- the scheduler -----------------------------------------------------------------


def _sched(mods, slots, n_blocks, block_size, **kw):
    kvp, pcm, sch = mods
    blocks = kvp.BlockManager(n_blocks)
    return sch.Scheduler(slots, 64, blocks=blocks,
                         prefix_cache=pcm.PrefixCache(block_size, blocks),
                         block_size=block_size, **kw)


def _req(sch, i, plen, max_tokens=8, priority=1, handoff=False):
    return sch.Request(id=i, prompt=np.arange(1, plen + 1, dtype=np.int32),
                       sampling=sch.SamplingParams(max_tokens=max_tokens,
                                                   priority=priority),
                       submit_s=0.0, handoff=handoff)


@pytest.mark.parametrize("handoff", [False, True])
def test_handoff_pricing_matches_jax(handoff):
    """A handoff request reserves P + 1 rows, not P + max_tokens: the
    blocks each admission takes, the requests that admit into a small
    arena and the preemption price equal ``hetu_tpu``'s."""
    runs = []
    for mods in (JAX_MODS, PORT_MODS):
        sched = _sched(mods, 4, 9, 4)
        reqs = [_req(mods[2], i, plen, max_tokens=12, handoff=handoff)
                for i, plen in enumerate((3, 7, 4, 9))]
        for r in reqs:
            assert sched.submit(r)
        admitted = []
        while (adm := sched.next_admission()) is not None:
            admitted.append((adm[0].id, list(adm[0].admit["table"])))
        runs.append((admitted, [sched.blocks_needed(r) for r in reqs],
                     sched.blocks.free_blocks))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("priorities", [[2, 0, 1] * 5, [1] * 6,
                                        [0, 0, 3, 1, 3, 2, 0, 1]])
def test_class_selection_matches_jax(priorities):
    """The deficit-weighted class selection (``2^-priority`` shares) a
    handoff fleet's prefill tier runs: the admission order and the
    credits left equal ``hetu_tpu``'s."""
    runs = []
    for mods in (JAX_MODS, PORT_MODS):
        sched = _sched(mods, 1, 64, 4)
        for i, pr in enumerate(priorities):
            sched.submit(_req(mods[2], i, 4, priority=pr, handoff=bool(i % 2)))
        order = []
        while (adm := sched.next_admission()) is not None:
            order.append(adm[0].id)
            sched.release(adm[1], table=adm[0].admit["table"])
        runs.append((order, dict(sched._credit)))
    assert runs[0] == runs[1]


# -- engines -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt():
    jmodel = JaxGPT(JaxGPTConfig.tiny())
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = GPTConfig.tiny()
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    return jmodel, params, model.eval()


_REFS: dict = {}


def _refs(gpt, prompts, new=4):
    """JAX ``generate``'s greedy tokens; prompts of one length go as one
    batch (memoized)."""
    todo: dict = {}
    for p in prompts:
        if (tuple(p), new) not in _REFS:
            todo.setdefault(len(p), set()).add(tuple(p))
    for n, group in todo.items():
        group = sorted(group)
        out = np.asarray(jax_generate(
            gpt[0], gpt[1], jnp.asarray(group, jnp.int32),
            max_new_tokens=new, max_len=MAX_LEN))
        for p, row in zip(group, out):
            _REFS[(p, new)] = row[n:].tolist()
    return [_REFS[(tuple(p), new)] for p in prompts]


def _engine(model):
    return ServingEngine(model, slots=2, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, device="cpu")


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).tolist() for n in lens]


def test_handoff_parks_after_the_first_token(gpt):
    """``submit(handoff=True)`` prefills and parks: status ``prefilled``,
    the first token, no load and no work left, the blocks still held;
    its eviction carries the prompt's KV and the trace context, and a
    decode engine resumes it (over the wire format) to JAX's tokens."""
    _, _, model = gpt
    pre, dec = _engine(model), _engine(model)
    prompt = _prompts([13], seed=3)[0]
    sp = SamplingParams(max_tokens=6)
    req = pre.submit(prompt, sp, handoff=True)
    assert req.handoff
    deadline = time.monotonic() + WAIT_S
    while req.status != "prefilled":
        assert time.monotonic() < deadline
        pre.step()
    assert len(req.tokens) == 1 and not req.done.is_set()
    assert pre.load == 0 and not pre.has_work()
    assert pre.blocks.blocks_in_use >= 1
    assert not pre.step()                 # a parked slot is no work
    entry = pre.evict_request(req)
    assert req.status == "evicted"
    assert entry.pos == len(prompt) and entry.tokens == list(req.tokens)
    assert entry.n_blocks == 1 and entry.traceparent is not None
    assert telemetry.parse_traceparent(entry.traceparent)[0] \
        == req.trace_id
    r2 = dec.submit(prompt, sp, resume=spill_from_wire(spill_to_wire(entry)))
    assert r2.trace_id == req.trace_id        # the trace travels
    dec.run_until_drained()
    assert list(r2.tokens) == _refs(gpt, [prompt], 6)[0]
    assert r2.resumed_blocks == 1
    with pytest.raises(ValueError, match="handoff"):
        pre.submit(prompt, sp, handoff=True, resume=entry)


def test_prefill_only_returns_the_kv(gpt):
    """``prefill_only`` steps an idle engine itself and returns the
    evicted entry; a request that ends with its first token returns
    None and its result."""
    _, _, model = gpt
    pre, dec = _engine(model), _engine(model)
    prompt = _prompts([9], seed=4)[0]
    req, entry = pre.prefill_only(prompt, SamplingParams(max_tokens=5),
                                  timeout_s=WAIT_S)
    assert entry is not None and req.status == "evicted"
    r2 = dec.submit(prompt, SamplingParams(max_tokens=5), resume=entry)
    dec.run_until_drained()
    assert list(r2.tokens) == _refs(gpt, [prompt], 5)[0]
    one, none = pre.prefill_only(prompt, SamplingParams(max_tokens=1),
                                 timeout_s=WAIT_S)
    assert none is None and one.status == "done"
    assert list(one.tokens) == _refs(gpt, [prompt], 5)[0][:1]
    assert not pre.has_work() and pre.blocks.blocks_in_use \
        == pre.prefix_cache.cached_blocks


def test_pd_split_matches_colocated(gpt):
    """A prefill-role and a decode-role replica behind one Router: every
    request is handed over exactly once with its KV (the decode replica
    resumes it, no prefill there), the tokens equal JAX's and a colocated
    fleet's, and each replica captured each lane once."""
    _, _, model = gpt
    prompts = _prompts([5, 11, 3, 8, 6, 9, 12, 4], seed=1)
    sp = SamplingParams(max_tokens=4)
    want = _refs(gpt, prompts)
    telemetry.reset()
    telemetry.enable(True)
    split = Router(poll_s=0.001)
    split.register("pre", _engine(model), role="prefill")
    split.register("dec", _engine(model), role="decode")
    colo = Router(poll_s=0.001)
    colo.register("r0", _engine(model))
    colo.register("r1", _engine(model))
    try:
        reqs = [split.submit(p, sp) for p in prompts]
        for r in reqs:
            assert r.done.wait(WAIT_S), f"request #{r.id} lost"
        assert [r.status for r in reqs] == ["done"] * len(reqs)
        assert [list(r.tokens) for r in reqs] == want
        assert all(r.replica == "dec" for r in reqs)
        assert all(r.result()["timing"]["resumed"] for r in reqs)
        reg = telemetry.get_registry()
        assert reg.counter("fleet_pd_handoffs_total").value() \
            == len(prompts)
        assert reg.counter("fleet_kv_stream_blocks_total").value() \
            >= len(prompts)
        assert reg.counter("router_dispatch_reason_total").value(
            reason="pd_prefill") == len(prompts)
        assert split.requeues_total == 0
        dec = split._replicas["dec"].engine
        assert dec.lane_iters["decode"] > 0
        assert colo.generate_many(prompts, sp) == want
        for router in (split, colo):
            for h in router._replicas.values():
                assert {k: g.captures for k, g in h.engine.lanes.items()} \
                    == {"decode": 1, "prefill": 1}
        # with the prefill tier gone, requests run colocated on decode
        split.drain("pre", timeout_s=WAIT_S)
        assert split.generate_many(prompts[:2], sp) == want[:2]
        assert reg.counter("fleet_pd_handoffs_total").value() \
            == len(prompts)
    finally:
        split.stop()
        colo.stop()
        telemetry.enable(False)
        telemetry.reset()
