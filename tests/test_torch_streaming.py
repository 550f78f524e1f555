"""The port's token streaming against ``hetu_tpu``'s, on the CPU.

Twins of ``tests/test_streaming.py``, served by the port's real engine
(``GPTConfig.tiny`` on ``hetu_tpu``'s weights, fp32 greedy) instead of a
stub: the frame codec, the bounded idempotency map, stream-submit with
its trailing result, one listener for line and stream clients,
subscribe-at-offset, a slow subscriber dropped to polling, idempotent
stream joins, the auth gate, ``generate_stream`` (incremental, socket
kill and resume, poll fallback), the tokens against JAX ``generate`` with
no re-capture, and the end events of an eviction and a cancel. Tests
whose timing matters step the engine from a paced thread of their own;
the rest run the engine's loop. Every wait has a deadline and every
server, loop and thread stops in ``finally``.
"""

import contextlib
import io
import socket
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import generate as jax_generate
from hetu_tpu.rpc.stream import read_frame as jax_read_frame

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.engine import trace_counts
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from hetu_tpu_torch.rpc import CoordinatorClient, PyCoordinatorServer
from hetu_tpu_torch.rpc.stream import (
    MAX_FRAME, StreamChannel, read_frame, write_frame,
)
from hetu_tpu_torch.serving import SamplingParams, ServingEngine
from hetu_tpu_torch.serving.scheduler import Request
from hetu_tpu_torch.serving.server import IdemMap

torch.set_num_threads(2)

SLOTS, MAX_LEN, CHUNK, BLOCK = 3, 64, 8, 8
WAIT_S = 20.0


@pytest.fixture()
def tele():
    telemetry.reset()
    telemetry.enable(True)
    try:
        yield telemetry.get_registry()
    finally:
        telemetry.enable(False)
        telemetry.reset()


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxGPT(JaxGPTConfig.tiny())
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = GPTConfig.tiny()
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, model


_REFS: dict = {}


def _ref(pair, prompt, new):
    """JAX ``generate``'s greedy tokens (memoized)."""
    jmodel, params, _ = pair
    key = (tuple(prompt), new)
    if key not in _REFS:
        _REFS[key] = np.asarray(jax_generate(
            jmodel, params, jnp.asarray([prompt], jnp.int32),
            max_new_tokens=new))[0, len(prompt):].tolist()
    return _REFS[key]


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        1, GPTConfig.tiny().vocab_size, n).tolist()


def _engine(model):
    return ServingEngine(model, slots=SLOTS, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, block_size=BLOCK,
                         device="cpu")


@contextlib.contextmanager
def _serve(serving, token=""):
    srv = PyCoordinatorServer(0, serving=serving, token=token)
    srv.start()
    try:
        yield srv.port
    finally:
        srv.stop()


@contextlib.contextmanager
def _loop(eng):
    eng.start()
    try:
        yield eng
    finally:
        eng.stop()


@contextlib.contextmanager
def _paced(eng, step_s):
    """Step ``eng`` from a thread of this test, one iteration every
    ``step_s``: a stream slow enough to act on mid-request."""
    stop = threading.Event()

    def run():
        while not stop.is_set():
            eng.step()
            stop.wait(step_s)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        yield eng
    finally:
        stop.set()
        t.join(WAIT_S)
        assert not t.is_alive()


def _collect():
    """An event sink + waiter: returns (sink, events, done_event)."""
    events, done = [], threading.Event()

    def sink(fr):
        events.append(fr)
        if fr.get("k") != "ev" or fr.get("done") or fr.get("end"):
            done.set()
    return sink, events, done


def _tokens_of(events):
    out = []
    for fr in events:
        if fr.get("k") == "ev":
            assert int(fr["off"]) == len(out), \
                f"offset gap: {fr['off']} != {len(out)}"
            out.extend(int(t) for t in fr["toks"])
    return out


# -- the wire ------------------------------------------------------------------


def test_frame_roundtrip_and_corruption():
    """Twin of ``test_streaming.py`` ``test_frame_roundtrip_and_corruption``:
    length-framed compact JSON survives a round trip (and reads back
    through ``hetu_tpu``'s reader byte for byte); corrupt length prefixes
    raise instead of allocating garbage."""
    buf = io.BytesIO()
    lock = threading.Lock()
    frames = [{"k": "ev", "sid": 3, "off": 0, "toks": [1, 2, 3]},
              {"k": "pong", "sid": 9},
              {"k": "res", "sid": 1, "line": "VAL x" * 100}]
    for fr in frames:
        write_frame(buf, lock, fr, direction="tx")
    raw = buf.getvalue()
    buf.seek(0)
    for fr in frames:
        assert read_frame(buf, direction="rx") == fr
    assert read_frame(buf, direction="rx") is None     # clean EOF
    theirs = io.BytesIO(raw)
    for fr in frames:
        assert jax_read_frame(theirs, direction="rx") == fr
    bad = io.BytesIO((1 << 30).to_bytes(4, "big") + b"{}")
    with pytest.raises(ValueError):
        read_frame(bad, direction="rx")
    bad = io.BytesIO((10).to_bytes(4, "big") + b"{}")
    with pytest.raises(ValueError):
        read_frame(bad, direction="rx")
    bad = io.BytesIO((2).to_bytes(4, "big") + b"[]")
    with pytest.raises(ValueError, match="not an object"):
        read_frame(bad, direction="rx")
    with pytest.raises(ValueError, match="too large"):
        write_frame(io.BytesIO(), lock, {"k": "x" * (MAX_FRAME + 1)},
                    direction="tx")


def test_idem_map_ttl_and_lru_eviction(tele):
    """Twin of ``test_idem_map_ttl_and_lru_eviction``: finished entries
    expire after the TTL, the cap evicts least-recently-used (done
    first), hits refresh recency and deadline, in-flight entries survive
    preferentially, and evictions are counted."""
    m = IdemMap(max_entries=3, ttl_s=10.0)

    def req(done=True):
        r = Request(id=0, prompt=np.zeros(1, np.int32),
                    sampling=SamplingParams(), submit_s=0.0)
        if done:
            r.done.set()
        return r

    a, b, c = req(), req(), req()
    m.put("a", a, now=0.0)
    m.put("b", b, now=1.0)
    m.put("c", c, now=2.0)
    assert len(m) == 3
    assert m.get("b", now=5.0) is b     # deadline now 15
    m.prune(now=11.5)
    assert m.get("a", now=11.5) is None and m.get("b", now=11.5) is b
    assert tele.counter("serving_idem_evictions_total").value(
        reason="ttl") >= 1
    m.put("d", req(), now=11.9)
    m.put("e", req(), now=11.9)
    assert len(m) == 3 and m.get("c", now=11.9) is None
    assert tele.counter("serving_idem_evictions_total").value(
        reason="cap") >= 1
    live = req(done=False)
    m2 = IdemMap(max_entries=2, ttl_s=10.0)
    m2.put("live", live, now=0.0)
    m2.put("d1", req(), now=0.0)
    m2.put("d2", req(), now=0.0)
    assert m2.get("live", now=0.0) is live
    assert m2.get("d1", now=0.0) is None


def test_stream_auth_gate(pair):
    """Twin of ``test_stream_auth_gate``: a tokened server rejects a bad
    stream hello and accepts the right token."""
    with _serve(_engine(pair[2]), token="sekrit") as port:
        with pytest.raises(ConnectionError):
            StreamChannel(port, token="wrong")
        ch = StreamChannel(port, token="sekrit")
        try:
            assert ch.request("PING") == "PONG"
        finally:
            ch.close()


# -- stream sessions on the real engine ----------------------------------------


def test_stream_submit_pushes_tokens_then_result(pair, tele):
    """Twin of ``test_stream_submit_pushes_tokens_then_result``: one
    ``stream`` frame submits and subscribes; tokens arrive at monotonic
    offsets and the final frame folds the full result, equal to a RESULT
    poll and to JAX ``generate``."""
    eng = _engine(pair[2])
    prompt = _prompt(9, 1)
    with _loop(eng), _serve(eng) as port:
        cli = CoordinatorClient(port, timeout=WAIT_S)
        ch = StreamChannel(port)
        try:
            sink, events, done = _collect()
            ack = ch.stream_submit(cli._serving_payload(
                prompt, max_tokens=6, idem="sk1"), sink=sink)
            assert ack["id"] == 0 and len(ack["trace"]) == 12
            assert done.wait(WAIT_S), "terminal frame never arrived"
            want = _ref(pair, prompt, 6)
            assert _tokens_of(events) == want
            last = events[-1]
            assert last["done"] and last["result"]["tokens"] == want
            assert last["result"]["status"] == "done"
            assert last["result"]["timing"]["trace_id"] == ack["trace"]
            doc = cli.serving_result(ack["id"], timeout_ms=2000)
            assert doc["tokens"] == want
            assert tele.counter("serving_stream_tokens_total").value() \
                == len(want)
        finally:
            ch.close()
            cli.close()


def test_mixed_line_and_stream_clients_one_listener(pair):
    """Twin of ``test_mixed_line_and_stream_clients_one_listener``: a
    framed channel and line-protocol clients share one listener, and the
    one-shot verbs multiplex over the channel too."""
    eng = _engine(pair[2])
    p1, p2 = _prompt(5, 2), _prompt(7, 3)
    with _loop(eng), _serve(eng) as port:
        cli = CoordinatorClient(port, timeout=WAIT_S)
        ch = StreamChannel(port)
        try:
            assert ch.request("PING") == "PONG"
            assert ch.request("RANK nope").startswith("ERR")
            sink, events, done = _collect()
            ch.stream_submit(cli._serving_payload(p1, max_tokens=4,
                                                  idem="m1"), sink=sink)
            doc = cli.serving_generate(p2, max_tokens=3, idem_key="m2")
            assert doc["tokens"] == _ref(pair, p2, 3)
            assert done.wait(WAIT_S)
            assert _tokens_of(events) == _ref(pair, p1, 4)
            assert eng._next_id == 2
            line = ch.request(f"RESULT 0 {int(WAIT_S * 1e3)}")
            assert line.startswith("VAL ")
            cli2 = CoordinatorClient(port, timeout=WAIT_S)
            assert cli2.ping()
            cli2.close()
        finally:
            ch.close()
            cli.close()


def test_subscribe_at_offset_replays_exactly_the_tail(pair, tele):
    """Twin of ``test_subscribe_at_offset_replays_exactly_the_tail``: a
    subscriber that holds k tokens passes ``off=k`` and receives exactly
    the rest; an unknown id is dropped, not hung."""
    eng = _engine(pair[2])
    prompt = _prompt(6, 4)
    with _serve(eng) as port:
        cli = CoordinatorClient(port, timeout=WAIT_S)
        ch = StreamChannel(port)
        try:
            rid = cli.serving_submit(prompt, max_tokens=8)
            req = eng._requests_by_id[rid]
            while len(req.tokens) < 3:        # a prefix commits
                eng.step()
            have = len(req.tokens)
            sink, events, done = _collect()
            ch.subscribe(rid, offset=have, sink=sink)
            eng.run_until_drained()
            assert done.wait(WAIT_S)
            toks = []
            for fr in events:
                if fr.get("k") == "ev":
                    assert int(fr["off"]) == have + len(toks)
                    toks.extend(int(t) for t in fr["toks"])
            want = _ref(pair, prompt, 8)
            assert toks == want[have:]
            assert cli.serving_result(rid, timeout_ms=2000)["tokens"] \
                == want
            assert tele.counter("serving_stream_subscribes_total").value(
                mode="resume") == 1
            sink2, events2, done2 = _collect()
            ch.subscribe(9999, sink=sink2)
            assert done2.wait(WAIT_S)
            assert events2[-1]["k"] == "drop" \
                and events2[-1]["reason"] == "unknown_request"
        finally:
            ch.close()
            cli.close()


def test_slow_subscriber_drops_to_poll_not_stall(pair, tele):
    """Twin of ``test_slow_subscriber_drops_to_poll_not_stall``: a
    consumer that never drains overflows its bounded queue, is dropped
    (counted), the engine keeps committing, and the request stays
    poll-able."""
    eng = _engine(pair[2])
    prompt = _prompt(5, 5)
    req = eng.submit(prompt, SamplingParams(max_tokens=20))
    sub = eng.stream_subscribe(req, max_queue=2)
    assert eng.run_until_drained() >= 20
    assert sub.dropped, "overflowing subscription never marked dropped"
    assert not eng._stream_subs, "a dropped subscription is still fed"
    assert tele.counter(
        "serving_stream_subscriber_drops_total").value() == 1
    assert req.result()["tokens"] == _ref(pair, prompt, 20)


def test_stream_submit_idempotency_joins_original(pair):
    """Twin of ``test_stream_submit_idempotency_joins_original``: a
    duplicate ``stream`` frame joins the original request and both
    subscribers see its tokens."""
    eng = _engine(pair[2])
    prompt = _prompt(8, 6)
    with _serve(eng) as port:
        cli = CoordinatorClient(port, timeout=WAIT_S)
        ch = StreamChannel(port)
        try:
            payload = cli._serving_payload(prompt, max_tokens=5,
                                           idem="dup1")
            s1, e1, d1 = _collect()
            s2, e2, d2 = _collect()
            a1 = ch.stream_submit(payload, sink=s1)
            a2 = ch.stream_submit(payload, sink=s2)
            assert a1["id"] == a2["id"]
            assert eng._next_id == 1, "duplicate stream frame queued twice"
            with _loop(eng):
                assert d1.wait(WAIT_S) and d2.wait(WAIT_S)
            want = _ref(pair, prompt, 5)
            assert e1[-1]["result"]["tokens"] == want
            assert e2[-1]["result"]["tokens"] == want
        finally:
            ch.close()
            cli.close()


# -- the client's generate_stream ----------------------------------------------


def test_client_generate_stream_incremental_and_trailing_result(pair):
    """Twin of ``test_client_generate_stream_incremental_and_trailing_
    result``: tokens arrive over several events, the last carries the
    full result with its timing, equal to the blocking GENERATE."""
    eng = _engine(pair[2])
    prompt = _prompt(11, 7)
    with _paced(eng, 0.02), _serve(eng) as port:
        cli = CoordinatorClient(port, timeout=WAIT_S)
        try:
            events = list(cli.generate_stream(prompt, max_tokens=6,
                                              event_timeout_s=WAIT_S))
            toks = [t for ev in events for t in ev["tokens"]]
            assert toks == _ref(pair, prompt, 6)
            assert len(events) >= 2, "tokens arrived in one lump"
            assert events[-1]["done"] and not any(
                ev["done"] for ev in events[:-1])
            res = events[-1]["result"]
            assert res["tokens"] == toks and res["status"] == "done"
            assert "timing" in res
            doc = cli.serving_generate(prompt, max_tokens=6)
            assert doc["tokens"] == toks
        finally:
            cli.close()


@pytest.mark.parametrize("stepper", ["paced", "loop"])
def test_client_generate_stream_reconnects_at_offset(pair, stepper):
    """Twins of ``test_client_generate_stream_reconnects_at_offset`` and
    ``test_stream_socket_kill_resumes_real_engine``: kill the SOCKET mid
    generation; the generator reconnects, resubscribes at the offset it
    holds, and the output equals JAX ``generate`` with no token lost or
    repeated and no second submission."""
    eng = _engine(pair[2])
    prompt = _prompt(10, 8)
    steps = _paced(eng, 0.03) if stepper == "paced" else _loop(eng)
    with steps, _serve(eng) as port:
        cli = CoordinatorClient(port, timeout=WAIT_S)
        try:
            got, killed = [], []
            for ev in cli.generate_stream(prompt, max_tokens=24,
                                          event_timeout_s=WAIT_S):
                got.extend(ev["tokens"])
                if not killed and got:
                    killed.append(True)
                    cli._stream._sock.shutdown(socket.SHUT_RDWR)
            assert killed
            assert got == _ref(pair, prompt, 24)
            assert eng._next_id == 1, "reconnect resubmitted the request"
        finally:
            cli.close()


class _NoStream:
    """The engine's submit/result surface without ``stream_subscribe``:
    a server that cannot push."""

    def __init__(self, eng):
        self._eng = eng
        self._requests_by_id = eng._requests_by_id

    def submit(self, *a, **kw):
        return self._eng.submit(*a, **kw)

    def result(self, *a, **kw):
        return self._eng.result(*a, **kw)


def test_client_generate_stream_falls_back_to_poll(pair, tele):
    """Twin of ``test_client_generate_stream_falls_back_to_poll``: a
    server that cannot stream drops the subscription ("unsupported"), and
    the generator still delivers every token through the counted RESULT
    poll fallback."""
    eng = _engine(pair[2])
    prompt = _prompt(6, 9)
    with _loop(eng), _serve(_NoStream(eng)) as port:
        cli = CoordinatorClient(port, timeout=WAIT_S)
        try:
            events = list(cli.generate_stream(prompt, max_tokens=5,
                                              event_timeout_s=WAIT_S))
            toks = [t for ev in events for t in ev["tokens"]]
            want = _ref(pair, prompt, 5)
            assert toks == want and events[-1]["done"]
            assert events[-1]["result"]["tokens"] == want
            assert tele.counter("serving_stream_fallbacks_total").value(
                reason="client_poll") == 1
        finally:
            cli.close()


def test_stream_matches_oneshot_no_recapture(pair, tele):
    """Twin of ``test_stream_matches_oneshot_bitwise_one_compile``:
    streamed tokens equal the blocking GENERATE and JAX ``generate``, and
    a subscriber costs no capture (the pump is host work after the
    commit)."""
    eng = _engine(pair[2])
    before = trace_counts()
    with _loop(eng), _serve(eng) as port:
        cli = CoordinatorClient(port, timeout=WAIT_S)
        try:
            for n, seed in ((5, 10), (9, 11), (3, 12)):
                p = _prompt(n, seed)
                events = list(cli.generate_stream(p, max_tokens=6,
                                                  event_timeout_s=WAIT_S))
                streamed = [t for ev in events for t in ev["tokens"]]
                assert events[-1]["result"]["tokens"] == streamed
                assert streamed == cli.serving_generate(
                    p, max_tokens=6)["tokens"] == _ref(pair, p, 6)
        finally:
            cli.close()
    assert trace_counts() == before
    assert {k: g.captures for k, g in eng.lanes.items()} \
        == {"decode": 1, "prefill": 1}
    assert tele.counter("serving_stream_subscribes_total").value(
        mode="new") == 3


def test_mixed_streaming_and_polling_clients_real_engine(pair):
    """Twin of ``test_mixed_streaming_and_polling_clients_real_engine``:
    a streaming and a polling client on one engine both complete with the
    tokens each prompt gives alone."""
    eng = _engine(pair[2])
    p1, p2 = _prompt(6, 13), _prompt(4, 14)
    outs = {}
    with _loop(eng), _serve(eng) as port:
        cli_s = CoordinatorClient(port, timeout=WAIT_S)
        cli_p = CoordinatorClient(port, timeout=WAIT_S)
        try:
            def stream():
                evs = list(cli_s.generate_stream(p1, max_tokens=6,
                                                 event_timeout_s=WAIT_S))
                outs["s"] = [t for ev in evs for t in ev["tokens"]]

            def poll():
                outs["p"] = cli_p.serving_generate(
                    p2, max_tokens=6)["tokens"]

            ts = threading.Thread(target=stream)
            tp = threading.Thread(target=poll)
            ts.start(), tp.start()
            ts.join(WAIT_S), tp.join(WAIT_S)
            assert not ts.is_alive() and not tp.is_alive()
            assert outs["s"] == _ref(pair, p1, 6)
            assert outs["p"] == _ref(pair, p2, 6)
        finally:
            cli_s.close()
            cli_p.close()


# -- out-of-band exits ---------------------------------------------------------


@pytest.mark.parametrize("exit_", ["evict", "cancel"])
def test_out_of_band_exit_ends_the_stream(pair, exit_):
    """An evicted (decoding) or cancelled (queued) request closes its
    subscriptions with an ``end`` event naming its status, after the
    tokens it had committed."""
    eng = _engine(pair[2])
    reqs = [eng.submit(_prompt(5, 20 + i), SamplingParams(max_tokens=10))
            for i in range(SLOTS + 1)]
    victim = reqs[0] if exit_ == "evict" else reqs[-1]
    sub = eng.stream_subscribe(victim)
    while len(reqs[0].tokens) < 2:
        eng.step()
    if exit_ == "evict":
        assert eng.evict_request(victim) is not None
    else:
        assert eng.cancel_queued({victim.id}) == [victim]
    events = []
    while (ev := sub.get(timeout=0.0)) is not None:
        events.append(ev)
    assert sub.closed and not eng._stream_subs
    assert events[-1]["end"] == ("evicted" if exit_ == "evict"
                                 else "cancelled")
    toks = [t for ev in events for t in ev["toks"]]
    assert toks == list(victim.tokens)
    eng.run_until_drained()
    assert not eng.has_work()
    deadline = time.monotonic() + WAIT_S
    assert all(r.done.wait(max(0.0, deadline - time.monotonic()))
               for r in reqs if r is not victim)
