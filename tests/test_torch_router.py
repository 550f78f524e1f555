"""The port's in-process serving fleet (``serving/router.py``,
``rpc/launcher.py``) against ``hetu_tpu``'s, on the CPU.

``GPTConfig.tiny`` fp32 with ``hetu_tpu``'s weights (``params_from_jax``),
replicas at ``slots=2, max_len=32, prefill_chunk=8`` as
``tests/test_router.py`` builds them. The fleet is a routing transform,
not a numerical one: greedy tokens equal JAX ``generate`` whichever
replica serves, across a replica's death (requeue, no loss, no
duplicate), across a rolling weight push (each request's tokens under
the weights of its own version, none rejected, never zero live
replicas) and across a drain (a request submitted to the engine itself
still finishes). The dispatch decisions equal ``hetu_tpu``'s Router on
the same prompts, replica sets and loads. The Router serves the line
protocol (the fleet verbs, HEALTHZ with the fleet), the launcher brings a
fleet up behind a front door, and the port's rollout loop closes the
train→serve cycle. Every wait has a deadline; no assertion reads a
clock.
"""

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
from hetu_tpu.rpc.client import CoordinatorClient as JaxClient
from hetu_tpu.serving import router as jax_router

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from hetu_tpu_torch.rpc import (
    CoordinatorClient, PyCoordinatorServer, launch_serving_fleet,
)
from hetu_tpu_torch.serving import (
    Router, SamplingParams, ServingEngine, WeightPublisher,
    materialize_params,
)

torch.set_num_threads(2)

MAX_LEN, CHUNK = 32, 8
#: the deadline of every wait in this file
WAIT_S = 60.0


@pytest.fixture(scope="module")
def gpt():
    jmodel = JaxGPT(JaxGPTConfig.tiny())
    params0 = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    params1 = jmodel.init(jax.random.key(7), dtype=jnp.float32)
    states = [params_from_jax(jax.tree.map(np.asarray, p), GPTConfig.tiny())
              for p in (params0, params1)]
    return jmodel, (params0, params1), states


def _model(gpt, version=0):
    """A port model holding ``hetu_tpu``'s weights of ``version``: each
    replica of a pushed fleet has its own (a swap writes in place)."""
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    model.load_state_dict(gpt[2][version])
    return model.eval()


def _engine(model):
    return ServingEngine(model, slots=2, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, device="cpu")


def _fleet(gpt, n=2, own_models=False, **router_kw):
    router = Router(poll_s=0.001, **router_kw)
    shared = None if own_models else _model(gpt)
    for i in range(n):
        router.register(f"r{i}", _engine(shared or _model(gpt)))
    return router


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).tolist() for n in lens]


_REFS: dict = {}


def _refs(gpt, prompts, new=4, version=0):
    """JAX ``generate``'s greedy tokens for each prompt under
    ``hetu_tpu``'s weights of ``version``: prompts of one length go as
    one batch (memoized)."""
    todo: dict = {}
    for p in prompts:
        if (tuple(p), new, version) not in _REFS:
            todo.setdefault(len(p), set()).add(tuple(p))
    for n, group in todo.items():
        group = sorted(group)
        out = np.asarray(jax_generate(
            gpt[0], gpt[1][version], jnp.asarray(group, jnp.int32),
            max_new_tokens=new, max_len=MAX_LEN))
        for p, row in zip(group, out):
            _REFS[(p, new, version)] = row[n:].tolist()
    return [_REFS[(tuple(p), new, version)] for p in prompts]


def _ref(gpt, prompt, new=4, version=0):
    return _refs(gpt, [prompt], new, version)[0]


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


@pytest.fixture(scope="module")
def fleet(gpt):
    """Two live replicas on one model: the read-mostly tests share it."""
    router = _fleet(gpt)
    yield router
    router.stop()


# -- dispatch --------------------------------------------------------------------


def test_router_dispatch_parity(gpt, fleet):
    """Greedy tokens equal JAX ``generate`` whichever replica serves, in
    either submission order, and a burst of distinct prompts reaches
    both replicas."""
    prompts = _prompts([5, 11, 3, 8, 6, 9])
    sp = SamplingParams(max_tokens=4)
    want = _refs(gpt, prompts)
    before = {n: h.dispatched for n, h in fleet._replicas.items()}
    assert fleet.generate_many(prompts, sp) == want
    st = fleet.fleet_status()
    assert st["live"] == 2
    assert all(r["dispatched"] > before[n]
               for n, r in st["replicas"].items()), st["replicas"]
    assert fleet.generate_many(list(reversed(prompts)), sp) \
        == list(reversed(want))


def test_shared_prefix_lands_on_one_replica(gpt, fleet):
    """Requests sharing a prompt prefix, submitted one at a time on an
    idle fleet, land on the replica ``hetu_tpu``'s Router picks for them
    (rendezvous over the same names), whose prefix cache then serves
    them; the tokens equal JAX's."""
    rng = np.random.default_rng(3)
    head = rng.integers(1, 256, 16).tolist()
    prompts = [head + rng.integers(1, 256, 4).tolist() for _ in range(6)]
    jr = jax_router.Router()
    want_name = jr._affinity_pick(
        prompts[0], [_Stub(n) for n in sorted(fleet._replicas)]).name
    sp = SamplingParams(max_tokens=4)
    outs, served, cached = [], set(), []
    for p in prompts:
        r = fleet.submit(p, sp)
        assert r.done.wait(WAIT_S), f"request #{r.id} lost"
        outs.append(list(r.tokens))
        served.add(r.replica)
        cached.append(r.result()["timing"]["cached_tokens"])
    assert served == {want_name}
    assert all(c >= 16 for c in cached[1:]), cached
    assert outs == _refs(gpt, prompts)


class _Stub:
    """A replica as ``_pick_locked`` sees it: a name, a state, a role, a
    load and a TTFT EWMA."""

    def __init__(self, name, load=0, ttft=None, state="live", role="both"):
        self.name, self.load, self.ttft_ewma_s = name, load, ttft
        self.state, self.role = state, role
        self.engine = None


def _pick(router, handles, prompt, tier="decode"):
    router._replicas = {h.name: h for h in handles}
    got = router._pick_locked(prompt, tier=tier)
    return None if got is None else (got[0].name, got[1])


@pytest.mark.parametrize("names", [("r0", "r1"), ("r0", "r1", "r2"),
                                   ("a", "b", "c", "d", "e")])
def test_affinity_pick_matches_jax(names):
    """The rendezvous pick over many prompts and replica sets, and the
    whole ``_pick_locked`` decision (affinity within the slack, least
    loaded past it, TTFT and name tie-breaks, roles, drained replicas)
    equal ``hetu_tpu``'s Router's on the same inputs."""
    rng = np.random.default_rng(len(names))
    prompts = [rng.integers(0, 50000, int(n)).tolist()
               for n in rng.integers(1, 40, 60)]
    jr, mine = jax_router.Router(kv_pull=False), Router(kv_pull=False)
    for p in prompts:
        live = [_Stub(n) for n in names]
        assert jr._affinity_pick(p, live).name \
            == mine._affinity_pick(p, live).name
    for i, p in enumerate(prompts):
        loads = rng.integers(0, 6, len(names))
        ttft = rng.choice([None, 0.01, 0.02], len(names))
        states = rng.choice(["live", "live", "draining"], len(names))
        roles = rng.choice(["both", "both", "prefill", "decode"],
                           len(names))
        handles = [_Stub(n, int(ld), t, str(s), str(r))
                   for n, ld, t, s, r in zip(names, loads, ttft, states,
                                             roles)]
        for tier in ("decode", "prefill"):
            assert _pick(jr, handles, p, tier) \
                == _pick(mine, handles, p, tier), (i, tier)


# -- death, drain, push -------------------------------------------------------------


def test_replica_kill_requeues_without_loss_or_dup(gpt):
    """A replica dying with requests in flight loses nothing: its
    undelivered requests go to the peer and each finishes exactly once
    with JAX's tokens; the dead replica takes no more traffic."""
    router = _fleet(gpt)
    try:
        prompts = _prompts([5, 11, 3, 8, 6, 9, 4, 7], seed=1)
        sp = SamplingParams(max_tokens=4)
        want = _refs(gpt, prompts)
        reqs = [router.submit(p, sp) for p in prompts]
        with router._lock:
            victim = max(router._replicas.values(),
                         key=lambda h: len(h.inflight)).name
        router.kill_replica(victim)
        for r in reqs:
            assert r.done.wait(WAIT_S), f"request #{r.id} lost"
        assert [r.status for r in reqs] == ["done"] * len(reqs)
        assert [list(r.tokens) for r in reqs] == want
        assert router.requeues_total > 0
        st = router.fleet_status()
        assert st["replicas"][victim]["state"] == "dead"
        assert st["live"] == 1
        assert router.generate_many(prompts[:2], sp) == want[:2]
        assert router.fleet_status()["replicas"][victim]["dispatched"] \
            == st["replicas"][victim]["dispatched"]
    finally:
        router.stop()


def test_rolling_weight_push_zero_downtime(gpt):
    """A rolling push of ``hetu_tpu``'s second weights under a trickle:
    no request rejected or lost, never zero live replicas, each request's
    tokens JAX's under the weights of its own version, every replica at
    the pushed version afterwards and serving its tokens, no lane
    re-captured, and the push's bytes counted as the replicas' copies."""
    telemetry.reset()
    telemetry.enable(True)
    router = _fleet(gpt, own_models=True)
    try:
        publisher = WeightPublisher(router)
        sp = SamplingParams(max_tokens=4)
        prompts = _prompts([5, 11, 3, 8], seed=2)
        assert router.generate_many(prompts, sp) == _refs(gpt, prompts)
        trickle, floor, stop = [], [], threading.Event()

        def sampler():
            while not stop.is_set():
                floor.append(router.fleet_status()["live"])
                time.sleep(0.0005)

        def submitter():
            rng = np.random.default_rng(5)
            while not stop.is_set() and len(trickle) < 24:
                p = rng.integers(1, 256, 5).tolist()
                trickle.append(router.submit(p, sp))
                time.sleep(0.002)

        threads = [threading.Thread(target=sampler),
                   threading.Thread(target=submitter)]
        for t in threads:
            t.start()
        report = publisher.publish(gpt[2][1])
        stop.set()
        for t in threads:
            t.join()
        for r in trickle:
            assert r.done.wait(WAIT_S), f"request #{r.id} lost in the push"
        assert [r.status for r in trickle] == ["done"] * len(trickle)
        assert min(floor) >= 1, "no live replica during the push"
        assert {r.weight_version for r in trickle} <= {0, 1}
        for version in (0, 1):
            mine = [r for r in trickle if r.weight_version == version]
            assert [list(r.tokens) for r in mine] == _refs(
                gpt, [r.prompt for r in mine], 4, version)
        assert report["version"] == 1
        assert [p["replica"] for p in report["replicas"]] == ["r0", "r1"]
        st = router.fleet_status()
        assert st["weight_versions"] == [1] and st["live"] == 2
        assert router.generate_many(prompts, sp) \
            == _refs(gpt, prompts, 4, 1)
        for h in router._replicas.values():
            assert {k: g.captures for k, g in h.engine.lanes.items()} \
                == {"decode": 1, "prefill": 1}
        reg = telemetry.get_registry()
        nbytes = sum(p.numel() * p.element_size()
                     for p in router._replicas["r0"].engine.model
                     .parameters())
        assert reg.counter("weight_push_bytes_total").value(
            transport="reshard") == 2 * nbytes
        assert reg.counter("weight_pushes_total").value() == 1
        # a second push, versions chosen by the publisher
        assert publisher.publish(_model(gpt, 0))["version"] == 2
        assert router.generate_many(prompts[:1], sp) \
            == [_ref(gpt, prompts[0])]
    finally:
        router.stop()
        telemetry.enable(False)
        telemetry.reset()


def test_drain_preserves_direct_engine_requests(gpt, fleet):
    """A drain pulls back only the queued requests the router owns: one
    submitted to the replica's engine directly still finishes."""
    h = fleet._replicas["r0"]
    prompt = _prompts([6], seed=13)[0]
    direct = h.engine.submit(prompt, SamplingParams(max_tokens=4))
    fleet.drain("r0", timeout_s=WAIT_S)
    try:
        assert direct.done.wait(WAIT_S), "direct request orphaned"
        assert direct.status == "done"
        assert list(direct.tokens) == _ref(gpt, prompt)
        assert fleet.fleet_status()["replicas"]["r0"]["state"] \
            == "draining"
    finally:
        fleet.resume("r0")


def test_swap_params_takes_the_publishers_version(gpt):
    eng = _engine(_model(gpt))
    assert eng.swap_params(gpt[2][1], version=7)["version"] == 7
    assert eng.weight_version == eng.pool.weight_version == 7
    assert eng.swap_params(gpt[2][0])["version"] == 8


def test_publisher_and_launcher_guards(gpt, fleet):
    with pytest.raises(ValueError, match="distributed checkpoint"):
        WeightPublisher(fleet, transport="dist_ckpt")
    with pytest.raises(ValueError, match="transport"):
        WeightPublisher(fleet, transport="carrier_pigeon")
    with pytest.raises(ValueError, match="not ported"):
        launch_serving_fleet(lambda i: None, 2, remote=True)
    with pytest.raises(ValueError, match="role"):
        fleet.register("rx", None, role="sideways")

    class _Remote:
        remote = True
    with pytest.raises(ValueError, match="remote"):
        fleet.register("rx", _Remote())
    model = _model(gpt)
    named = dict(model.named_parameters())
    assert materialize_params(model).keys() == named.keys()
    assert all(materialize_params(named)[k] is v for k, v in named.items())
    with pytest.raises(TypeError):
        materialize_params(42)


# -- the wire ------------------------------------------------------------------------


@pytest.mark.parametrize("client", ["port", "jax"])
def test_fleet_verbs_over_line_protocol(gpt, fleet, client):
    """A coordinator serving a Router answers SUBMIT, RESULT and GENERATE
    across the fleet and FLEET, DRAIN, RESUME and FLEETMETRICS; HEALTHZ
    carries the fleet; each package's client reads it."""
    telemetry.reset()
    telemetry.enable(True)
    srv = PyCoordinatorServer(0, serving=fleet)
    srv.start()
    srv.wait_ready()
    cls = CoordinatorClient if client == "port" else JaxClient
    cli = cls(srv.port, timeout=WAIT_S)
    try:
        prompt = _prompts([6], seed=8)[0]
        r = cli.serving_generate(prompt, max_tokens=4)
        assert r["status"] == "done" and r["tokens"] == _ref(gpt, prompt)
        assert r["replica"] in ("r0", "r1")
        assert r["timing"]["attempts"] == 1
        rid = cli.serving_submit(prompt, max_tokens=4)
        out, deadline = None, time.monotonic() + WAIT_S
        while out is None:
            assert time.monotonic() < deadline
            out = cli.serving_result(rid, timeout_ms=100)
        assert out["tokens"] == r["tokens"]
        st = cli.fleet_status()
        assert st["live"] == 2 and set(st["replicas"]) == {"r0", "r1"}
        assert cli.fleet_drain("r1")["requeued"] >= 0
        assert cli.fleet_status()["replicas"]["r1"]["state"] == "draining"
        hz = cli.healthz()
        assert hz["serving"]["live"] == 1 and "fleet" in hz
        cli.fleet_resume("r1")
        assert cli.fleet_status()["replicas"]["r1"]["state"] == "live"
        assert "router_requests_total" in cli.fleet_metrics_text()
    finally:
        cli.close()
        srv.stop()
        telemetry.enable(False)
        telemetry.reset()


def test_launch_serving_fleet_front_door(gpt):
    """``launch_serving_fleet(build_engine, 2, port=0)``: a free port, the
    replicas registered in order with their loops running, GENERATE
    across them, FLEETMETRICS with each replica's series, and ``stop``
    stopping every loop."""
    model = _model(gpt)
    built = []

    def build(i):
        built.append(_engine(model))
        return built[-1]

    telemetry.reset()
    telemetry.enable(True)
    fleet = launch_serving_fleet(build, 2, port=0)
    try:
        assert fleet.port and fleet.replicas == ["r0", "r1"]
        assert all(e._thread is not None for e in built)
        cli = CoordinatorClient(fleet.port, timeout=WAIT_S)
        prompts = _prompts([5, 7, 9, 4], seed=21)
        for p, want in zip(prompts, _refs(gpt, prompts)):
            assert cli.serving_generate(p, max_tokens=4)["tokens"] == want
        fleet.router._tick()
        text = cli.fleet_metrics_text()
        for name in ("r0", "r1"):
            assert f'replica="{name}"' in text
        cli.close()
    finally:
        fleet.stop()
        telemetry.enable(False)
        telemetry.reset()
    assert all(e._thread is None for e in built)


def test_rollout_loop_closes_the_cycle():
    """The port's rollout loop: rollouts through the fleet feed the SFT
    trainer, whose weights go back into the fleet under a trickle, with
    nothing lost, at versions 1 then 2, with finite losses."""
    from hetu_tpu_torch.workloads import run_rollout_loop
    out = run_rollout_loop(rounds=2, n_replicas=2, prompts_per_round=6,
                           max_tokens=6, steps_per_round=2, trickle=3,
                           device="cpu")
    telemetry.enable(False)
    telemetry.reset()
    assert out["zero_downtime"], out["continuity"]
    assert out["continuity"]["submitted"] \
        == out["continuity"]["completed"] == 6
    assert [r["weight_version"] for r in out["rounds"]] == [1, 2]
    assert all(r["fleet_versions"] == [r["weight_version"]]
               for r in out["rounds"])
    assert all(np.isfinite(r["loss"]) for r in out["rounds"])
