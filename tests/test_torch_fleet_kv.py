"""The port's fleet-global KV plane against ``hetu_tpu``'s, on the CPU.

Host side, decision for decision on the same inputs: the host spill
arena (placement, lookups, ledgers, refusals), ``KVReplicaStore`` assembly from the same shipment docs (bit
for bit), its tombstones and LRU cap, and ``FleetPrefixDirectory``
through one sequence of publish, lookup, flush and cap operations. The
wire: a spill with its generator state and trace context, bf16 and int8
arrays, and ``hetu_tpu``'s arrays read by the port.

Engines (``GPTConfig.tiny`` fp32, ``hetu_tpu``'s weights through
``params_from_jax``, ``slots=2, max_len=32, prefill_chunk=8``): a prefix
exported from one port engine and imported into another serves a prompt
with JAX ``generate``'s tokens from its cache; an entry of another weight
version, or one imported after a swap, is refused; a decode replicated
into a store resumes on a peer with the same tokens; a Router pulls a
prefix across replicas and recovers a killed replica's request from its
buddy's store. Every wait has a deadline; no assertion reads a clock.
"""

import json
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import generate as jax_generate
from hetu_tpu.serving import fleet as jax_fleet
from hetu_tpu.serving import kv_pool as jax_kv_pool
from hetu_tpu.serving import router as jax_router

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from hetu_tpu_torch.serving import (
    FleetPrefixDirectory, HostSpillArena, KVReplicaStore, Router,
    SamplingParams, ServingEngine, SpillEntry, spill_from_wire,
    spill_to_wire,
)
from hetu_tpu_torch.serving.fleet import (
    array_from_wire, array_to_wire, repl_doc_to_wire,
)

torch.set_num_threads(2)

BS = 4                                  # the toy arena's block size
MAX_LEN, CHUNK = 32, 8
#: the deadline of every wait in this file
WAIT_S = 60.0


def _data(nb, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, nb, BS, 2, 3)).astype(np.float32)


def _pair_entry(req_id, nb, seed=0, wv=0):
    """The same spill as a ``hetu_tpu`` entry (numpy) and a port entry
    (torch)."""
    d = _data(nb, seed)
    kw = dict(req_id=req_id, n_blocks=nb, block_size=BS, pos=nb * BS,
              last_tok=1, tokens=list(range(nb * BS)), weight_version=wv)
    return (jax_kv_pool.SpillEntry(data=(d,), **kw),
            SpillEntry(data=(torch.from_numpy(d.copy()),), **kw))


def _arena_state(a) -> dict:
    return {"held": a.blocks_held, "host": sorted(a._entries),
            "len": len(a), "spilled": a.spilled_total,
            "resumed": a.resumed_total}


# -- the host spill arena -------------------------------------------------------

#: one sequence of operations on the host spill arena
ARENA_OPS = [("put", 1, 2), ("put", 2, 2), ("put", 3, 2), ("put", 4, 1),
             ("get", 1), ("get", 3), ("contains", 1), ("pop", 1, True),
             ("put", 5, 3), ("pop", 2, False), ("put", 6, 6),
             ("put", 5, 1), ("can_fit", 9), ("pop", 6, True),
             ("pop", 4, True), ("pop", 99, True)]


@pytest.mark.parametrize("max_blocks", [None, 6])
def test_spill_arena_matches_jax(max_blocks):
    """The arena's placement, lookups, ledgers and refusals (full, or
    already spilled) equal ``hetu_tpu``'s, op by op."""
    jx = jax_kv_pool.HostSpillArena(max_blocks)
    mine = HostSpillArena(max_blocks)
    for op in ARENA_OPS:
        got = []
        for arena, k in ((jx, 0), (mine, 1)):
            if op[0] == "put":
                entry = _pair_entry(op[1], op[2], seed=op[1])[k]
                try:
                    arena.put(entry)
                    got.append("ok")
                except ValueError as e:
                    got.append(f"refused: {e}")
            elif op[0] == "pop":
                e = arena.pop(op[1], resumed=op[2])
                got.append(None if e is None else (e.req_id, e.n_blocks))
            elif op[0] == "get":
                e = arena.get(op[1])
                got.append(None if e is None else e.req_id)
            elif op[0] == "contains":
                got.append(op[1] in arena)
            else:
                got.append(arena.can_fit(op[1]))
        assert got[0] == got[1], op
        assert _arena_state(jx) == _arena_state(mine), op


def test_spill_arena_keeps_the_bytes_and_the_trace():
    """An entry parked and popped back is the same entry, bit for bit,
    with its trace context."""
    host = HostSpillArena(4)
    _, e1 = _pair_entry(1, 2, seed=1)
    e1.traceparent = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    host.put(e1)
    host.put(_pair_entry(2, 2, seed=2)[1])
    assert not host.can_fit(1) and host.blocks_held == 4
    back = host.pop(1)
    assert back is e1 and host.resumed_total == 2
    assert back.traceparent == e1.traceparent
    assert torch.equal(back.data[0], torch.from_numpy(_data(2, 1)))


# -- the buddy store --------------------------------------------------------------


def _shipment(full, start, n, *, pos, tid="t1", last_tok=17):
    """One replication doc in ``hetu_tpu``'s format (its array_to_wire)."""
    return json.loads(json.dumps({
        "trace_id": tid, "origin": "r0", "req_id": 3, "weight_version": 0,
        "block_size": BS, "pos": pos, "last_tok": last_tok,
        "tokens": [1, 2], "start": start, "key_state": None,
        "traceparent": f"00-{'ab' * 16}-{'cd' * 8}-01",
        "data": [jax_fleet.array_to_wire(full[:, start:start + n])]}))


def _same_fetch(a, b) -> None:
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.n_blocks, a.pos, a.last_tok, a.tokens, a.weight_version,
            a.block_size, a.traceparent) == \
        (b.n_blocks, b.pos, b.last_tok, b.tokens, b.weight_version,
         b.block_size, b.traceparent)
    for x, y in zip(a.data, b.data):
        assert x.dtype == y.numpy().dtype
        assert np.array_equal(x, y.numpy())


def test_replica_store_assembles_like_jax():
    """Both stores take the same shipment docs; each fetch equals
    ``hetu_tpu``'s bit for bit, partial coverage fetches None in both,
    and a tombstone drops the trace in both."""
    full = _data(3, 3)
    jx, mine = jax_fleet.KVReplicaStore(), KVReplicaStore()
    docs = [("put", _shipment(full, 0, 2, pos=2 * BS)),
            ("fetch", "t1"),
            ("put", _shipment(full, 1, 2, pos=3 * BS - 1)),
            ("fetch", "t1"),
            ("put", _shipment(full, 2, 1, pos=2 * BS + 1, tid="t2")),
            ("fetch", "t2"),
            ("put", {"drop": "t1"}), ("fetch", "t1")]
    for op, arg in docs:
        if op == "put":
            jx.put(arg)
            mine.put(arg)
        else:
            _same_fetch(jx.fetch(arg), mine.fetch(arg))
        assert jx.blocks_held == mine.blocks_held
        assert ("t1" in jx, "t2" in jx) == ("t1" in mine, "t2" in mine)


def test_replica_store_lru_cap_like_jax():
    full = _data(1, 4)
    jx = jax_fleet.KVReplicaStore(max_traces=2)
    mine = KVReplicaStore(max_traces=2)
    for tid in ("a", "b", "a", "c", "d", "a"):
        doc = _shipment(full, 0, 1, pos=BS, tid=tid)
        jx.put(doc)
        mine.put(doc)
        assert [t for t in "abcd" if t in jx] \
            == [t for t in "abcd" if t in mine], tid


def test_replica_store_takes_tensors_and_wire_alike():
    """An in-process origin ships host tensors; ``repl_doc_to_wire``
    gives the KVREPL form of the same doc; both stores fetch the same
    bits and generator state."""
    full = torch.from_numpy(_data(2, 6))
    gen = torch.Generator().manual_seed(3)
    doc = {"trace_id": "t7", "origin": "r0", "req_id": 4,
           "weight_version": 2, "block_size": BS, "pos": 2 * BS - 1,
           "last_tok": 9, "tokens": [9], "start": 0,
           "gen_state": gen.get_state(), "traceparent": None,
           "data": [full]}
    a, b = KVReplicaStore(), KVReplicaStore()
    a.put(doc)
    b.put(json.loads(json.dumps(repl_doc_to_wire(doc))))
    x, y = a.fetch("t7"), b.fetch("t7")
    assert torch.equal(x.data[0], y.data[0]) and torch.equal(x.data[0],
                                                              full)
    assert torch.equal(x.gen_state, y.gen_state)
    assert (x.pos, x.tokens, x.weight_version) \
        == (y.pos, y.tokens, y.weight_version) == (2 * BS - 1, [9], 2)
    assert repl_doc_to_wire({"drop": "t7"}) == {"drop": "t7"}


# -- the wire ------------------------------------------------------------------------


def test_spill_wire_carries_generator_state_and_trace():
    gen = torch.Generator().manual_seed(5)
    torch.rand(7, generator=gen)
    _, entry = _pair_entry(7, 2, seed=7)
    entry.gen_state = gen.get_state()
    entry.traceparent = f"00-{'ab' * 16}-{'cd' * 8}-01"
    back = spill_from_wire(json.loads(json.dumps(spill_to_wire(entry))))
    assert torch.equal(back.gen_state, entry.gen_state)
    assert back.traceparent == entry.traceparent
    assert torch.equal(back.data[0], entry.data[0])
    again = torch.Generator()
    again.set_state(back.gen_state)
    assert torch.equal(torch.rand(3, generator=again),
                       torch.rand(3, generator=gen))
    bare = spill_from_wire(spill_to_wire(_pair_entry(8, 1)[1]))
    assert bare.gen_state is None and bare.traceparent is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.float32])
def test_array_wire_is_lossless(dtype):
    t = (torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(1))
         * 50).to(dtype)
    back = array_from_wire(json.loads(json.dumps(array_to_wire(t))))
    assert back.dtype == dtype and torch.equal(back, t)


def test_jax_arrays_read_by_the_port():
    a = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    q = np.arange(-6, 6, dtype=np.int8).reshape(3, 4)
    for x in (a, q):
        back = array_from_wire(jax_fleet.array_to_wire(x))
        assert np.array_equal(back.numpy(), x)
        assert np.array_equal(jax_fleet.array_from_wire(array_to_wire(x)),
                              x)


# -- the fleet prefix directory --------------------------------------------------------

TOKS = list(range(100, 140))             # 40 tokens: 2 blocks of 16

DIRECTORY_OPS = [
    ("publish", "r0", TOKS, 16, 1), ("lookup", TOKS),
    ("lookup", TOKS[:16] + [999] * 24), ("lookup", [1, 2, 3]),
    ("lookup", TOKS[:15]), ("publish", "r1", TOKS[:16], 16, 1),
    ("lookup", TOKS), ("publish", "r1", list(range(200, 232)), 16, 0),
    ("flush", None, 1), ("lookup", list(range(200, 232))),
    ("publish", "r2", list(range(300, 312)), 4, 1),
    ("lookup", list(range(300, 312)) + [5]), ("drop", "r0"),
    ("lookup", TOKS), ("publish", "r0", list(range(16)), 16, 2),
    ("publish", "r1", list(range(50, 66)), 16, 2),
    ("publish", "r2", list(range(80, 96)), 16, 2),
    ("lookup", list(range(16))), ("lookup", list(range(80, 96))),
    ("flush", "r1", None), ("lookup", list(range(50, 66)))]


@pytest.mark.parametrize("cap", [4096, 6])
def test_prefix_directory_matches_jax(cap):
    jx = jax_router.FleetPrefixDirectory(cap)
    mine = FleetPrefixDirectory(cap)
    for op in DIRECTORY_OPS:
        outs = []
        for d in (jx, mine):
            if op[0] == "publish":
                outs.append(d.publish(op[1], op[2], block_size=op[3],
                                      weight_version=op[4]))
            elif op[0] == "lookup":
                outs.append(d.lookup(op[1]))
            elif op[0] == "flush":
                outs.append(d.flush_stale(replica=op[1],
                                          below_version=op[2]))
            else:
                outs.append(d.drop_replica(op[1]))
        assert outs[0] == outs[1], op
        assert (len(jx), jx.published_total, jx.flushed_total) \
            == (len(mine), mine.published_total, mine.flushed_total), op


# -- engines --------------------------------------------------------------------------


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


def _ref(gpt, prompt, new=4):
    """JAX ``generate``'s greedy tokens (memoized)."""
    jmodel, params, _ = gpt
    key = (tuple(prompt), new)
    if key not in _REFS:
        out = jax_generate(jmodel, params, jnp.asarray([prompt], jnp.int32),
                           max_new_tokens=new, max_len=MAX_LEN)
        _REFS[key] = np.asarray(out)[0, len(prompt):].tolist()
    return _REFS[key]


def _engine(model, **kw):
    return ServingEngine(model, slots=2, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, device="cpu", **kw)


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def test_export_import_across_engines(gpt):
    """A whole-block prefix exported from one engine and imported (over
    the wire format) into another serves a prompt from the cache with
    JAX's tokens; an entry of another weight version, or one imported
    after the importer swapped, is refused; neither lane re-captures."""
    _, _, model = gpt
    e1, e2 = _engine(model), _engine(model)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 256, 16).tolist()
    p1 = shared + [3, 5]
    sp = SamplingParams(max_tokens=4)
    assert e1.generate_many([p1], sp) == [_ref(gpt, p1)]
    entry = e1.export_prefix(shared)
    assert entry is not None and entry.n_blocks == 1
    assert entry.tokens == shared and entry.weight_version == 0
    assert e2.import_prefix(spill_from_wire(spill_to_wire(entry)))
    r = e2.submit(p1, sp)
    e2.run_until_drained()
    assert list(r.tokens) == _ref(gpt, p1)
    assert r.timing()["cached_tokens"] >= 16
    assert e1.export_prefix([7, 7, 7]) is None          # a miss
    stale = e1.export_prefix(shared)
    stale.weight_version = 99
    assert not e2.import_prefix(stale)
    e3 = _engine(model)
    e3.swap_params(dict(model.named_parameters()))       # version 1
    assert not e3.import_prefix(e1.export_prefix(shared))
    for eng in (e1, e2, e3):
        assert {k: g.captures for k, g in eng.lanes.items()} \
            == {"decode": 1, "prefill": 1}


def test_replicated_decode_resumes_on_a_peer(gpt):
    """A decode replicated into a store resumes on another engine with
    JAX's tokens and ``resumed`` set; once the request has finished, the
    next cadence tombstones it. The cadences run here, between steps."""
    _, _, model = gpt
    e1, e2 = _engine(model), _engine(model)
    store = KVReplicaStore()
    # the background cadence sleeps for an hour: this test runs them
    e1.configure_replication(store.put, origin="e1", cadence_s=3600.0)
    prompt = np.random.default_rng(4).integers(1, 256, 18).tolist()
    sp = SamplingParams(max_tokens=8)
    r = e1.submit(prompt, sp)
    while len(r.tokens) < 3:
        e1.step()
    e1._replicate_once()
    got = store.fetch(r.trace_id)
    assert got is not None and got.pos == len(prompt) + 2
    assert got.tokens == list(r.tokens) and got.n_blocks == 2
    e1.run_until_drained()
    assert list(r.tokens) == _ref(gpt, prompt, 8)
    e1._replicate_once()
    assert r.trace_id not in store
    e1.configure_replication(None)
    e1.stop()
    r2 = e2.submit(prompt, sp, resume=got)
    e2.run_until_drained()
    assert list(r2.tokens) == _ref(gpt, prompt, 8)
    assert r2.timing()["resumed"] is True


def test_router_pull_and_buddy_recovery(gpt):
    """A Router pulls a shared prefix onto the replica a request lands on
    (the owner drained) with JAX's tokens from the cache; then a replica
    killed mid-decode whose arena cannot be read (its eviction raises)
    has its request recovered from the buddy's store: the same tokens,
    ``resumed`` set, the recovery counted."""
    _, _, model = gpt
    telemetry.reset()
    telemetry.enable(True)
    router = Router(poll_s=0.001, kv_pull=True, replicate_kv=True,
                    replicate_cadence_s=0.002)
    router.register("r0", _engine(model))
    router.register("r1", _engine(model))
    try:
        sp = SamplingParams(max_tokens=4)
        rng = np.random.default_rng(0)
        shared = rng.integers(1, 256, 16).tolist()
        p1, p2 = shared + [3, 5], shared + [7, 9, 11]
        r = router.submit(p1, sp)
        assert r.done.wait(WAIT_S) and r.status == "done"
        assert list(r.tokens) == _ref(gpt, p1)
        owner = r.replica
        _wait(lambda: len(router._directory) >= 1, "the directory")
        router.drain(owner, timeout_s=WAIT_S)
        r2 = router.submit(p2, sp)
        assert r2.done.wait(WAIT_S) and r2.status == "done"
        assert list(r2.tokens) == _ref(gpt, p2) and r2.replica != owner
        reg = telemetry.get_registry()
        assert reg.counter("fleet_kv_pull_blocks_total").value() >= 1
        assert r2.result()["timing"]["cached_tokens"] >= 16
        router.resume(owner)

        _wait(lambda: len(router._buddy_of) == 2, "the buddies")
        p3 = rng.integers(1, 256, 10).tolist()
        for h in router._replicas.values():      # slow every step
            real = h.engine.step
            h.engine.step = (lambda o=real: (time.sleep(0.01), o())[1])
        r3 = router.submit(p3, SamplingParams(max_tokens=20))

        def shipped():
            if r3.inner is None or r3.replica is None:
                return False
            buddy = router._buddy_of.get(r3.replica)
            return bool(buddy) and r3.inner.status == "decode" \
                and r3.trace_id in \
                router._replicas[buddy].engine.kv_replica_store
        _wait(shipped, "a shipment to the buddy")
        victim = router._replicas[r3.replica]

        def unreachable(*a, **k):
            raise RuntimeError("arena unreachable")
        victim.engine.evict_request = unreachable
        router.kill_replica(victim.name)
        assert r3.done.wait(WAIT_S) and r3.status == "done", r3.error
        assert list(r3.tokens) == _ref(gpt, p3, 20)
        tim = r3.result()["timing"]
        assert tim["resumed"] is True and tim["resumed_blocks"] >= 1
        assert reg.counter("fleet_kv_recoveries_total").value() >= 1
        assert router.requeues_total >= 1
    finally:
        router.stop()
        telemetry.enable(False)
        telemetry.reset()
