"""The port's online serving front end against ``hetu_tpu``'s, on the CPU.

``GPTConfig.tiny`` with ``hetu_tpu``'s weights carried over by
``params_from_jax`` is served by the port's ``ServingEngine`` (fp32,
greedy) behind the port's ``ServingServer`` on a free local port (0),
its background loop running. Tokens through every client mode (GENERATE,
SUBMIT + RESULT, ``generate_stream``) must equal JAX ``generate``
exactly; the port's client must work against ``hetu_tpu``'s server and
the other way round, with the same tokens and the same RESULT keys. The
wire codec, the verb tuples, the verb not ported yet (SWAPWEIGHTS), the
verbs the fleet brings, the engine verbs and the auth gate are checked
against ``hetu_tpu``'s. Every wait has a
deadline and every server and loop stops in ``finally``.
"""

import dataclasses
import socket
import time
import urllib.parse

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import generate as jax_generate
from hetu_tpu.rpc import py_server as jax_py_server
from hetu_tpu.rpc.client import CoordinatorClient as JaxClient
from hetu_tpu.serving import ServingEngine as JaxServingEngine
from hetu_tpu.serving import server as jax_server

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, generate, params_from_jax,
)
from hetu_tpu_torch.rpc import CoordinatorClient, py_server
from hetu_tpu_torch.serving import ServingEngine, ServingServer, server

torch.set_num_threads(2)

SLOTS, MAX_LEN, CHUNK, BLOCK, NEW = 3, 64, 8, 8, 6
#: the deadline of every socket read and every wait in this file
WAIT_S = 20.0


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxGPT(JaxGPTConfig.tiny())
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = GPTConfig.tiny()
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, model


def _prompts(vocab, lens=(5, 9, 13, 20, 3, 11), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


_REFS: dict = {}


def _jax_ref(jmodel, params, prompt, new=NEW, eos_id=None):
    """JAX ``generate``'s tokens for one prompt, cut after an EOS (the
    engine stops there; ``generate`` fills the rest). Memoized: each
    new prompt length compiles JAX's generate anew."""
    key = (tuple(prompt), new, eos_id)
    if key not in _REFS:
        out = np.asarray(jax_generate(
            jmodel, params, jnp.asarray([prompt], jnp.int32),
            max_new_tokens=new, eos_id=eos_id))[0, len(prompt):].tolist()
        if eos_id is not None and eos_id in out:
            out = out[:out.index(eos_id) + 1]
        _REFS[key] = out
    return _REFS[key]


def _engine(model, **kw):
    return ServingEngine(model, slots=SLOTS, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, block_size=BLOCK,
                         device="cpu", **kw)


@pytest.fixture()
def served(pair):
    """The port's engine behind the port's server, loop running."""
    _, _, model = pair
    srv = ServingServer(_engine(model), 0)
    srv.start()
    srv.wait_ready()
    try:
        yield srv
    finally:
        srv.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the wire ------------------------------------------------------------------

PAYLOADS = [
    {"prompt": [1, 2, 3]},
    {"prompt": [7], "temperature": 0.7, "top_k": 5, "top_p": 0.9,
     "eos_id": 2, "max_tokens": 3, "priority": 0, "tenant": "a",
     "adapter": "x", "idem": "k1"},
    {"prompt": [4, 5], "eos_id": None, "max_tokens": "9", "top_k": 2.0},
]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_payload_codec_and_sampling_match_jax(payload):
    tok = server.encode_payload(payload)
    assert tok == jax_server.encode_payload(payload)
    assert " " not in tok
    assert server.decode_payload(tok) == jax_server.decode_payload(tok)
    mine = dataclasses.asdict(server.sampling_from_payload(payload))
    theirs = dataclasses.asdict(jax_server.sampling_from_payload(payload))
    assert mine == theirs


def test_serving_verb_tuples_match_jax():
    assert server.SERVING_COMMANDS == jax_server.SERVING_COMMANDS
    assert py_server._SERVING_VERBS == jax_py_server._SERVING_VERBS
    assert py_server._SERVING_VERBS == server.SERVING_COMMANDS
    assert set(server.NOT_PORTED) < set(server.SERVING_COMMANDS)


@pytest.mark.parametrize("verb", server.NOT_PORTED)
def test_verb_not_ported_answers_one_line(pair, verb):
    """Each verb whose module is not ported answers one fixed line, in
    process and over the wire, and the server keeps serving."""
    _, _, model = pair
    eng = _engine(model)
    want = f"ERR {verb} not ported"
    assert server.handle_serving_command(eng, verb, ["x"]) == want
    srv = py_server.PyCoordinatorServer(0, serving=eng)
    srv.start()
    try:
        cli = CoordinatorClient(srv.port, timeout=WAIT_S)
        assert cli._cmd(f"{verb} x") == want
        assert cli.ping()
        cli.close()
    finally:
        srv.stop()


#: the verbs the in-process fleet brings (answered since the router, the
#: prefill/decode handoff and the fleet KV plane were ported)
PORTED_FLEET_VERBS = ("FLEET", "DRAIN", "RESUME", "FLEETMETRICS", "PREFILL",
                      "KVEXPORT", "KVIMPORT", "KVREPL", "KVFETCH",
                      "KVBUDDY")


def _verb_case(pair, verb):
    """(serving object, argument line, answer check, clean-up) for one
    ported verb. The check reads the real answer and may run twice (in
    process, then over the wire)."""
    from hetu_tpu_torch.serving import (
        KVReplicaStore, Router, SamplingParams,
    )
    from hetu_tpu_torch.serving.fleet import array_to_wire
    from hetu_tpu_torch.telemetry import parse_prometheus
    jmodel, params, model = pair
    enc = server.encode_payload
    prompt = _prompts(model.cfg.vocab_size, (20,), seed=31)[0]

    def val(ans):
        assert ans.startswith("VAL "), ans
        return server.decode_payload(ans[4:])

    if verb in ("FLEET", "DRAIN", "RESUME", "FLEETMETRICS"):
        router = Router(poll_s=0.001)
        router.register("r0", _engine(model), start=False)
        if verb == "FLEET":
            def check(ans):
                doc = val(ans)
                assert set(doc["replicas"]) == {"r0"} and doc["live"] in (
                    0, 1) and doc["requeues_total"] == 0
            return router, "", check, router.stop
        if verb == "DRAIN":
            def check(ans):
                assert val(ans) == {"requeued": 0}
                assert router.fleet_status()["replicas"]["r0"]["state"] \
                    == "draining"
            return router, "r0", check, router.stop
        if verb == "RESUME":
            router.drain("r0")

            def check(ans):
                assert ans == "OK"
                assert router.fleet_status()["live"] == 1
            return router, "r0", check, router.stop

        def check(ans):
            text = urllib.parse.unquote(ans[4:])
            assert ans.startswith("VAL ")
            assert parse_prometheus(text) is not None
            assert text.startswith("# fleet federation")
        return router, "", check, router.stop
    eng = _engine(model)
    sp = SamplingParams(max_tokens=NEW)
    if verb == "PREFILL":
        def check(ans):
            doc = val(ans)
            assert doc["done"] is False and len(doc["tokens"]) == 1
            other = _engine(model)
            r = other.submit(prompt, sp,
                             resume=server.spill_from_wire(doc["spill"]))
            other.run_until_drained()
            assert list(r.tokens) == _jax_ref(jmodel, params, prompt)
        return eng, enc({"prompt": prompt, "max_tokens": NEW}), check, None
    if verb in ("KVEXPORT", "KVIMPORT"):
        eng.generate_many([prompt], sp)
        entry = eng.export_prefix(prompt)
        if verb == "KVEXPORT":
            def check(ans):
                got = server.spill_from_wire(val(ans)["spill"])
                assert got.n_blocks == len(prompt) // BLOCK
                assert got.tokens == prompt[:got.n_blocks * BLOCK]
                for a, b in zip(got.data, entry.data):
                    assert torch.equal(a, b)
            return eng, enc({"tokens": prompt}), check, None
        fresh = _engine(model)

        def check(ans):
            assert val(ans) == {"ok": True}
            r = fresh.submit(prompt, sp)
            fresh.run_until_drained()
            assert r.cached_tokens >= BLOCK
            assert list(r.tokens) == _jax_ref(jmodel, params, prompt)
        return fresh, enc({"spill": server.spill_to_wire(entry)}), check, \
            None
    block = torch.arange(2 * 1 * BLOCK * 3, dtype=torch.float32).reshape(
        2, 1, BLOCK, 3)
    doc = {"trace_id": "t9", "origin": "x", "req_id": 1,
           "weight_version": 0, "block_size": BLOCK, "pos": BLOCK - 1,
           "last_tok": 5, "tokens": [5], "start": 0,
           "data": [array_to_wire(block)]}
    if verb == "KVREPL":
        def check(ans):
            assert ans == "OK" and "t9" in eng.kv_replica_store
            assert torch.equal(eng.kv_replica_store.fetch("t9").data[0],
                               block)
        return eng, enc(doc), check, None
    if verb == "KVFETCH":
        eng.kv_replica_store.put(doc)

        def check(ans):
            got = server.spill_from_wire(val(ans)["spill"])
            assert got.pos == BLOCK - 1 and got.tokens == [5]
            assert torch.equal(got.data[0], block)
        return eng, enc({"trace_id": "t9"}), check, None
    buddy = ServingServer(_engine(model), 0)
    buddy.start()
    buddy.wait_ready()

    def check(ans):
        assert ans == "OK" and eng._repl_sink is not None
        eng._repl_sink(doc)           # the sink ships KVREPL to the buddy
        assert "t9" in buddy.engine.kv_replica_store
        assert isinstance(buddy.engine.kv_replica_store, KVReplicaStore)

    def done():
        eng.configure_replication(None)
        eng.stop()
        buddy.stop()
    return eng, enc({"host": "127.0.0.1", "port": buddy.port,
                     "origin": "r0", "cadence_s": 3600.0}), check, done


@pytest.mark.parametrize("verb", PORTED_FLEET_VERBS)
def test_fleet_verb_answers(pair, verb):
    """Each verb the fleet brings gives its real answer, in process and
    over the wire, and the server keeps serving; on a serving object
    without the surface it needs, it answers ``hetu_tpu``'s refusal
    line."""
    serving, arg, check, done = _verb_case(pair, verb)
    try:
        check(server.handle_serving_command(serving, verb, [arg]))
        srv = py_server.PyCoordinatorServer(0, serving=serving)
        srv.start()
        try:
            cli = CoordinatorClient(srv.port, timeout=WAIT_S)
            check(cli._cmd(f"{verb} {arg}".strip()))
            assert cli.ping()
            assert cli.rank("w0") == 0
            cli.close()
        finally:
            srv.stop()
    finally:
        if done is not None:
            done()

    class _Bare:
        _requests_by_id: dict = {}
    bare = _Bare()
    assert server.handle_serving_command(bare, verb, ["x"]) \
        == jax_server.handle_serving_command(bare, verb, ["x"])


def test_healthz_not_ported_and_metrics(pair):
    _, _, model = pair
    srv = py_server.PyCoordinatorServer(0, serving=_engine(model))
    srv.start()
    try:
        cli = CoordinatorClient(srv.port, timeout=WAIT_S)
        telemetry.reset()                # no earlier trip degrades it
        doc = cli.healthz()
        assert doc["status"] == "ok" and doc["watchdog_trips"] == 0
        assert doc["serving"]["loop_running"] is False
        assert isinstance(cli.metrics_text(), str)
        # the coordinator role is intact beside the serving verbs
        assert cli.rank("w0") == 0 and cli.rank("w1") == 1
        cli.put("k", {"a": 1})
        assert cli.get("k") == {"a": 1}
        cli.heartbeat("w0")
        assert cli.status(5000)[0] == ["w0"]
        cli.close()
    finally:
        srv.stop()


def test_line_auth_gate(pair):
    """A tokened server closes a connection that skips AUTH or sends a
    wrong token; PING stays open; the right token serves."""
    _, _, model = pair
    srv = ServingServer(_engine(model), 0, token="sekrit")
    srv.start()
    try:
        bare = CoordinatorClient(srv.port, timeout=WAIT_S, token="")
        assert bare.ping()
        assert bare._cmd("RANK w") == "ERR auth required"
        bare.close()
        with pytest.raises(ConnectionError, match="auth failed"):
            CoordinatorClient(srv.port, timeout=WAIT_S, token="wrong")
        cli = CoordinatorClient(srv.port, timeout=WAIT_S, token="sekrit")
        assert cli.serving_generate([1, 2, 3], max_tokens=2)["status"] \
            == "done"
        cli.close()
    finally:
        srv.stop()


# -- serving through the wire --------------------------------------------------


def test_rpc_serving_roundtrip(pair, served):
    """Twin of ``tests/test_serving.py`` ``test_rpc_serving_roundtrip``:
    GENERATE, SUBMIT + RESULT poll, and an admission rejection that comes
    back as a protocol error."""
    jmodel, params, _ = pair
    cli = CoordinatorClient(served.port, timeout=WAIT_S)
    try:
        assert cli.ping()
        prompt = _prompts(GPTConfig.tiny().vocab_size, (6,), seed=6)[0]
        want = _jax_ref(jmodel, params, prompt, 5)
        r = cli.serving_generate(prompt, max_tokens=5)
        assert r["status"] == "done" and r["tokens"] == want
        rid = cli.serving_submit(prompt, max_tokens=5)
        deadline = time.monotonic() + WAIT_S
        r = None
        while r is None and time.monotonic() < deadline:
            r = cli.serving_result(rid, timeout_ms=100)
        assert r is not None and r["tokens"] == want
        with pytest.raises(RuntimeError, match="rejected"):
            cli.serving_submit(list(range(1, MAX_LEN + 2)), max_tokens=4)
        assert cli._cmd(f"RESULT {rid}") == "ERR unknown request id"
    finally:
        cli.close()


@pytest.mark.parametrize("mode", ["generate", "submit", "stream"])
def test_tokens_equal_jax_generate(pair, served, mode):
    """Every client mode gives JAX ``generate``'s greedy tokens exactly,
    with an EOS cutting some requests short."""
    jmodel, params, _ = pair
    vocab = GPTConfig.tiny().vocab_size
    prompts = _prompts(vocab)
    full = [_jax_ref(jmodel, params, p) for p in prompts]
    # an EOS that some request samples early: it ends that request
    # before its budget
    eos = next(t for toks in full for i, t in enumerate(toks)
               if 1 <= i <= NEW - 2 and t not in toks[:i])
    cli = CoordinatorClient(served.port, timeout=WAIT_S)
    try:
        for p in prompts:
            want = _jax_ref(jmodel, params, p, eos_id=eos)
            if mode == "generate":
                doc = cli.serving_generate(p, max_tokens=NEW, eos_id=eos)
                got = doc["tokens"]
            elif mode == "submit":
                info = cli.serving_submit_info(p, max_tokens=NEW,
                                               eos_id=eos)
                doc = cli.serving_result(info["id"],
                                         timeout_ms=int(WAIT_S * 1e3))
                assert doc["timing"]["trace_id"] == info["trace_id"]
                got = doc["tokens"]
            else:
                evs = list(cli.generate_stream(p, max_tokens=NEW,
                                               eos_id=eos,
                                               event_timeout_s=WAIT_S))
                got = [t for ev in evs for t in ev["tokens"]]
                doc = evs[-1]["result"]
                assert evs[-1]["done"] and doc["tokens"] == got
            assert got == want, (p, got, want)
            assert doc["status"] == "done"
        assert any(len(_jax_ref(jmodel, params, p, eos_id=eos)) < NEW
                   for p in prompts), "the EOS never cut a request short"
    finally:
        cli.close()


def test_engine_verbs(pair):
    """ESTATUS, CANCELQ, EVICT and STOPENGINE over the wire, on an engine
    whose loop is not running (the test steps it)."""
    _, _, model = pair
    eng = _engine(model)
    srv = py_server.PyCoordinatorServer(0, serving=eng)
    srv.start()
    cli = CoordinatorClient(srv.port, timeout=WAIT_S)
    try:
        vocab = model.cfg.vocab_size
        ids = [cli.serving_submit(p, max_tokens=NEW)
               for p in _prompts(vocab, (5, 9, 13, 20))]
        st = cli.serving_estatus()
        assert st["load"] == 4 and st["depth"] == 4 and st["has_work"]
        assert st["weight_version"] == 0 and st["block_size"] == BLOCK
        eng.step()                     # 3 slots admit, one stays queued
        st = cli.serving_estatus()
        assert st["depth"] == 1 and st["occupancy"] == 1.0
        moved = cli.serving_cancel_queued(ids)["cancelled"]
        assert [m["id"] for m in moved] == [ids[3]]
        assert moved[0]["spill"] is None
        while eng._prefilling:
            eng.step()
        ev = cli.serving_evict(ids[0])
        assert ev["status"] == "evicted" and ev["spill"] is not None
        entry = server.spill_from_wire(ev["spill"])
        assert entry.req_id == ids[0] and entry.n_blocks >= 1
        assert cli._cmd(f"RESULT {ids[0]}") == "ERR unknown request id"
        eng.run_until_drained()
        assert cli.serving_result(ids[1], timeout_ms=1000)["status"] \
            == "done"
        eng.start()
        cli.serving_stop_engine()
        assert eng._thread is None
    finally:
        cli.close()
        srv.stop()
        eng.stop()


def test_spill_wire_roundtrip(pair):
    """An evicted request's spill survives the wire bit for bit and
    resumes on a second engine to the undisturbed tokens."""
    jmodel, params, model = pair
    prompt = _prompts(model.cfg.vocab_size, (9,), seed=8)[0]
    eng = _engine(model)
    from hetu_tpu_torch.serving import SamplingParams
    req = eng.submit(prompt, SamplingParams(max_tokens=NEW))
    while len(req.tokens) < 3:
        eng.step()
    entry = eng.evict_request(req)
    wire = server.spill_to_wire(entry)
    back = server.spill_from_wire(server.decode_payload(
        server.encode_payload(wire)))
    for a, b in zip(entry.data, back.data):
        assert a.dtype == b.dtype and torch.equal(a, b)
    other = _engine(model)
    r2 = other.submit(prompt, SamplingParams(max_tokens=NEW), resume=back)
    other.run_until_drained()
    assert r2.resumed_blocks >= 1
    assert list(r2.tokens) == _jax_ref(jmodel, params, prompt)


# -- both ways: the port's server and client against hetu_tpu's ----------------


def test_jax_client_against_port_server(pair, served):
    jmodel, params, _ = pair
    cli = JaxClient(served.port, timeout=WAIT_S)
    try:
        for p in _prompts(GPTConfig.tiny().vocab_size, (7, 12)):
            want = _jax_ref(jmodel, params, p)
            doc = cli.serving_generate(p, max_tokens=NEW)
            assert doc["tokens"] == want
            rid = cli.serving_submit(p, max_tokens=NEW)
            assert cli.serving_result(rid, timeout_ms=int(WAIT_S * 1e3)
                                      )["tokens"] == want
            evs = list(cli.generate_stream(p, max_tokens=NEW,
                                           event_timeout_s=WAIT_S))
            assert [t for e in evs for t in e["tokens"]] == want
    finally:
        cli.close()


def test_port_client_against_jax_server(pair):
    """The port's client drives ``hetu_tpu``'s ``ServingServer`` (same
    weights): the same tokens and the same RESULT keys as the port's
    server gives."""
    jmodel, params, model = pair
    jeng = JaxServingEngine(jmodel, params, slots=SLOTS, max_len=MAX_LEN,
                            prefill_chunk=CHUNK, block_size=BLOCK,
                            prefill_attn="flash")
    jsrv = jax_server.ServingServer(jeng, _free_port())
    psrv = ServingServer(_engine(model), 0)
    jsrv.start()
    psrv.start()
    jsrv.wait_ready()
    try:
        jcli = CoordinatorClient(jsrv.coordinator.port, timeout=WAIT_S)
        pcli = CoordinatorClient(psrv.port, timeout=WAIT_S)
        for p in _prompts(model.cfg.vocab_size, (7, 12)):
            want = _jax_ref(jmodel, params, p)
            a = jcli.serving_generate(p, max_tokens=NEW)
            b = pcli.serving_generate(p, max_tokens=NEW)
            assert a["tokens"] == b["tokens"] == want
            assert set(a) == set(b)
            assert set(a["timing"]) == set(b["timing"])
            evs = list(jcli.generate_stream(p, max_tokens=NEW,
                                            event_timeout_s=WAIT_S))
            assert [t for e in evs for t in e["tokens"]] == want
        jcli.close()
        pcli.close()
    finally:
        psrv.stop()
        jsrv.stop()


# -- the oracle: generate's max_len / eos_id / pad_id / prompt_lens ------------


GEN_CASES = {
    "max_len": dict(max_len=30),
    "eos": "eos",
    "eos_pad": "eos_pad",
    "ragged": dict(prompt_lens=[7, 4, 2], max_len=20),
    "ragged_eos_pad": "ragged_eos_pad",
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_options_match_jax(pair, case):
    jmodel, params, model = pair
    rng = np.random.default_rng(0)
    ids = rng.integers(1, model.cfg.vocab_size, (3, 7))
    plain = generate(model, ids, max_new_tokens=NEW, device="cpu").numpy()
    # an EOS that a row samples after its first token (the fill then
    # covers a real tail), else the first token of row 0
    eos = next((int(t) for row in plain[:, 7:] for i, t in enumerate(row)
                if 1 <= i <= NEW - 2 and t != row[0]), int(plain[0, 7]))
    kw = GEN_CASES[case]
    if kw == "eos":
        kw = dict(eos_id=eos)
    elif kw == "eos_pad":
        kw = dict(eos_id=eos, pad_id=0)
    elif kw == "ragged_eos_pad":
        kw = dict(prompt_lens=[7, 4, 2], eos_id=eos, pad_id=0)
    jkw = {k: (jnp.asarray(v) if k == "prompt_lens" else v)
           for k, v in kw.items()}
    want = np.asarray(jax_generate(jmodel, params, jnp.asarray(ids),
                                   max_new_tokens=NEW, **jkw))
    got = generate(model, ids, max_new_tokens=NEW, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_ragged_rows_match_alone(pair):
    """A right-padded ragged batch gives each row the tokens of its prompt
    generated alone (the pad KV is never attended)."""
    _, _, model = pair
    rng = np.random.default_rng(1)
    lens = [5, 8, 3]
    batch = np.zeros((3, 8), np.int64)
    for r, n in enumerate(lens):
        batch[r, :n] = rng.integers(1, model.cfg.vocab_size, n)
    out = generate(model, batch, max_new_tokens=NEW, device="cpu",
                   prompt_lens=lens, max_len=16)
    for r, n in enumerate(lens):
        alone = generate(model, batch[r:r + 1, :n], max_new_tokens=NEW,
                         device="cpu", max_len=16)
        assert out[r, 8:].tolist() == alone[0, n:].tolist()


def test_generate_max_len_refuses_overflow(pair):
    from hetu_tpu_torch.models import PromptTooLongError
    _, _, model = pair
    with pytest.raises(PromptTooLongError, match="max_len"):
        generate(model, [[1, 2, 3, 4]], max_new_tokens=6, max_len=8,
                 device="cpu")
