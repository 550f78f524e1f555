"""The port's serving observability against ``hetu_tpu``'s.

The same greedy traffic goes through JAX's and the port's
``ServingEngine`` (``GPTConfig.tiny`` and Llama tiny, params carried
over with ``params_from_jax``, prompts from a numpy seed) with telemetry
on in both packages: the registries must hold the same metric names
with equal counter values, equal histogram counts and equal final
gauges, and the flight recorders the same sequence of event kinds —
plain traffic with prefix hits, n-gram speculation, and a preempting
schedule with spill and resume. JAX's re-trace audit is per fused step
(``step_traces_total{what="serving_step"}``), the port's per captured
lane, so that one family is held to the port's capture count instead.

Then the port alone: one request track per request in ``trace.json``
(parsed by the port's ``trace_summary``), HEALTHZ, METRICS and DUMPOBS
over the wire, the watchdog tripping on a stalled serving loop (its dump
parses, HEALTHZ reads degraded, a later request still finishes), the
SLO engine firing on a TTFT regression, the lanes captured once with
telemetry on, and the metrics lint of ``hetu_tpu_torch/`` against
``docs/OBSERVABILITY.md``.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import telemetry as jtel
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.serving import SamplingParams as JaxSamplingParams
from hetu_tpu.serving import ServingEngine as JaxServingEngine

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.engine import trace_counts
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel,
    params_from_jax,
)
from hetu_tpu_torch.rpc import CoordinatorClient
from hetu_tpu_torch.serving import (
    SamplingParams, ServingEngine, ServingServer,
)
from hetu_tpu_torch.telemetry.slo import SLOEngine
from hetu_tpu_torch.tools import check_metrics_docs, obs_report
from hetu_tpu_torch.tools import trace_summary

torch.set_num_threads(2)

WAIT_S = 20.0
FAMILIES = {"gpt": (JaxGPTConfig, JaxGPT, GPTConfig, GPTLMHeadModel),
            "llama": (JaxLlamaConfig, JaxLlama, LlamaConfig,
                      LlamaLMHeadModel)}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jcfg_cls, jcls, cfg_cls, cls) in FAMILIES.items():
        jmodel = jcls(jcfg_cls.tiny())
        params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
        cfg = cfg_cls.tiny()
        model = cls(cfg, device="cpu")
        model.load_state_dict(
            params_from_jax(jax.tree.map(np.asarray, params), cfg))
        out[name] = (jmodel, params, model)
    return out


@pytest.fixture(autouse=True)
def _telemetry_on():
    for pkg in (jtel, telemetry):
        pkg.enable(True)
        pkg.reset()
    yield
    for pkg in (jtel, telemetry):
        pkg.enable(False)
        pkg.reset()


def _prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, 20).tolist()
    return [rng.integers(1, vocab, n).tolist() for n in (5, 9, 13, 3, 11)] \
        + [shared + [7, 8], shared + [9], shared[:17]]


#: (model, engine kwargs, (prompt, max_tokens, priority) schedule, steps
#: between the batch and the urgent wave)
CASES = {
    "plain": ("gpt", dict(slots=3, max_len=64, prefill_chunk=8,
                          block_size=8), None),
    "spec": ("gpt", dict(slots=3, max_len=64, prefill_chunk=8,
                         block_size=8, spec_depth=2), None),
    "llama_int8": ("llama", dict(slots=2, max_len=64, prefill_chunk=8,
                                 block_size=8, cache="int8"), None),
    "preempt": ("gpt", dict(slots=3, max_len=32, prefill_chunk=8,
                            block_size=8, kv_blocks=9), 4),
}


def _drive(eng, sp_cls, vocab, n_before):
    """Greedy traffic; with ``n_before`` a priority-2 batch first, then
    priority-0 arrivals that preempt it."""
    if n_before is None:
        reqs = [eng.submit(p, sp_cls(max_tokens=6))
                for p in _prompts(vocab)]
        while eng.has_work():
            eng.step()
        return reqs
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(1, vocab, n).tolist(),
                       sp_cls(max_tokens=12, priority=2))
            for n in (10, 9, 11)]
    for _ in range(n_before):
        eng.step()
    reqs += [eng.submit(rng.integers(1, vocab, n).tolist(),
                        sp_cls(max_tokens=4, priority=0)) for n in (6, 5)]
    while eng.has_work():
        eng.step()
    return reqs


def _readout(snap):
    """Counter and gauge values, histogram counts, by series name."""
    return {k: (v["count"] if isinstance(v, dict) else v)
            for k, v in snap.items() if not k.startswith("step_traces")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_series_and_flight_match_jax(models, case):
    name, kw, n_before = CASES[case]
    kw = dict(kw)
    int8 = kw.pop("cache", None) == "int8"
    jmodel, params, model = models[name]
    vocab = model.cfg.vocab_size
    jeng = JaxServingEngine(
        jmodel, params, attn_kernel="paged", prefill_attn="flash",
        cache_dtype=jnp.int8 if int8 else jnp.float32, **kw)
    jreqs = _drive(jeng, JaxSamplingParams, vocab, n_before)
    before = trace_counts()
    eng = ServingEngine(model, device="cpu",
                        cache_dtype=torch.int8 if int8 else None, **kw)
    reqs = _drive(eng, SamplingParams, vocab, n_before)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]

    js = jtel.get_registry().snapshot()
    ps = telemetry.get_registry().snapshot()
    assert _readout(ps) == _readout(js)
    assert ps["serving_requests_total{outcome=\"completed\"}"] == len(reqs)
    lanes = {k: trace_counts().get(k, 0) - before.get(k, 0)
             for k in ("serving_decode", "serving_prefill")}
    assert lanes == {"serving_decode": 1, "serving_prefill": 1}
    assert {k: v for k, v in ps.items() if k.startswith("step_traces")} \
        == {'step_traces_total{what="serving_decode"}': 1,
            'step_traces_total{what="serving_prefill"}': 1}
    # the kernel-path counters are the lanes' replays
    assert ps['serving_attn_kernel_total{path="paged"}'] \
        == eng.lane_iters["decode"]
    assert ps['prefill_attn_kernel_total{path="flash"}'] \
        == eng.lane_iters["prefill"]
    if case == "spec":
        assert ps["serving_draft_tokens_total"] == eng.spec_stats["drafted"]
    if case == "preempt":
        assert ps['serving_preemptions_total{priority="2"}'] >= 1
    kinds = [e["event"] for e in jtel.get_flight_recorder().events()]
    assert [e["event"] for e in telemetry.get_flight_recorder().events()] \
        == kinds
    assert kinds.count("serving_finish") == len(reqs)


def test_request_tracks_and_trace_summary(models, tmp_path, capsys):
    _, _, model = models["gpt"]
    eng = ServingEngine(model, slots=3, max_len=64, prefill_chunk=8,
                        block_size=8, device="cpu")
    reqs = _drive(eng, SamplingParams, model.cfg.vocab_size, None)
    paths = telemetry.export_dir(str(tmp_path))
    trace = json.load(open(paths["trace"]))
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "thread_name"
              and e["args"]["name"].startswith("req ")}
    assert tracks == {f"req {r.trace_id}" for r in reqs}
    decode = [e for e in trace["traceEvents"] if e.get("name") == "decode"
              and e.get("cat") == "request"]
    assert len(decode) == len(reqs)
    recs = trace_summary.load_records(paths["trace"])
    assert any(r.get("name") == "queued" for r in recs)
    assert trace_summary.main([paths["jsonl"]]) == 0
    out = capsys.readouterr().out
    assert "serving_ttft_seconds" in out or "ttft" in out.lower()


def test_healthz_metrics_dumpobs_over_the_wire(models):
    _, _, model = models["gpt"]
    eng = ServingEngine(model, slots=3, max_len=64, prefill_chunk=8,
                        block_size=8, device="cpu", slo=True)
    srv = ServingServer(eng, 0)
    srv.start()
    srv.wait_ready()
    try:
        cli = CoordinatorClient(srv.port, timeout=WAIT_S)
        res = cli.serving_generate([5, 6, 7, 8], max_tokens=4)
        assert len(res["tokens"]) == 4
        doc = cli.healthz()
        assert doc["status"] == "ok" and doc["serving"]["loop_running"]
        assert doc["slo"]["alerting_rules"] == []
        assert {r["name"] for r in doc["slo"]["rules"]} \
            == {r["name"] for r in eng.slo.status()["rules"]}
        text = cli.metrics_text()
        meta, samples = telemetry.parse_prometheus(text)
        assert meta["serving_tokens_total"]["type"] == "counter"
        assert any(n == "serving_ttft_seconds_count" and v == 1
                   for n, _, v in samples)
        bundle = cli.dump_obs()
        assert bundle["pid"] == os.getpid()
        assert {"chrome", "flight", "epoch_unix"} <= set(bundle)
        assert any(e["event"] == "serving_finish" for e in bundle["flight"])
        cli.close()
    finally:
        srv.stop()


def test_watchdog_trips_on_a_stalled_loop(models, tmp_path):
    _, _, model = models["gpt"]
    eng = ServingEngine(model, slots=3, max_len=64, prefill_chunk=8,
                        block_size=8, device="cpu", watchdog=True,
                        watchdog_min_timeout_s=1.0)
    eng.watchdog.poll_s = 0.05
    eng.watchdog.dump_dir = str(tmp_path)
    srv = ServingServer(eng, 0)
    srv.start()
    srv.wait_ready()
    try:
        cli = CoordinatorClient(srv.port, timeout=WAIT_S)
        cli.serving_generate([5, 6, 7], max_tokens=3)
        time.sleep(0.2)                   # idle turns beat the watchdog
        with eng._step_lock:              # the planted stall
            deadline = time.monotonic() + 8.0
            while eng.watchdog.trips == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.3)
        assert eng.watchdog.trips == 1
        snap = telemetry.get_registry().snapshot()
        assert snap['watchdog_trips_total{name="serving"}'] == 1
        assert cli.healthz()["status"] == "degraded"
        dumps = [f for f in os.listdir(tmp_path) if f.endswith(".jsonl")]
        assert dumps
        recs = obs_report.load_jsonl(str(tmp_path / dumps[0]))
        assert recs[0]["kind"] == "flight_header"
        assert recs[0]["reason"].startswith("watchdog")
        assert any(r["kind"] == "thread_stacks" for r in recs)
        # the loop lives on: a later request finishes
        res = cli.serving_generate([9, 10, 11], max_tokens=3)
        assert len(res["tokens"]) == 3
        cli.close()
    finally:
        srv.stop()


def test_slo_fires_on_a_ttft_regression(models):
    """An SLOEngine on a settable clock with the default rules' TTFT
    burn rate at a 0.1 s objective: a healthy baseline, then a delay
    before admission; the burn-rate alert fires and counts."""
    _, _, model = models["gpt"]
    clk = [0.0]
    eng = ServingEngine(model, slots=3, max_len=64, prefill_chunk=8,
                        block_size=8, device="cpu",
                        slo=SLOEngine(telemetry.get_registry(),
                                      clock=lambda: clk[0]))
    eng.slo.add_burn_rate("ttft_slo", "serving_ttft_seconds",
                          objective=0.1, budget=0.05,
                          windows=((60.0, 10.0), (300.0, 2.0)))
    rng = np.random.default_rng(0)
    fired = []
    for i in range(25):
        delay = 0.15 if i >= 10 else 0.0
        clk[0] += 1.0
        req = eng.submit(rng.integers(1, 256, 5).tolist(),
                         SamplingParams(max_tokens=2))
        time.sleep(delay)                 # the injected admission delay
        while eng.has_work():
            eng.step()
        assert req.status == "done"
        fired += [a.rule for a in eng.slo.evaluate()]
    assert any("ttft" in r for r in fired), fired
    snap = telemetry.get_registry().snapshot()
    assert any(k.startswith("slo_alerts_total") and v >= 1
               for k, v in snap.items())


def test_lanes_capture_once_with_telemetry_on_or_off(models):
    _, _, model = models["gpt"]
    for on in (True, False):
        telemetry.enable(on)
        before = trace_counts()
        eng = ServingEngine(model, slots=2, max_len=64, prefill_chunk=8,
                            block_size=8, device="cpu")
        eng.generate_many(_prompts(256)[:4], SamplingParams(max_tokens=4))
        assert {k: trace_counts().get(k, 0) - before.get(k, 0)
                for k in ("serving_decode", "serving_prefill")} \
            == {"serving_decode": 1, "serving_prefill": 1}
        assert {k: g.captures for k, g in eng.lanes.items()} \
            == {"decode": 1, "prefill": 1}


def test_metrics_lint_is_clean():
    assert check_metrics_docs.missing_from_docs() == {}
    assert check_metrics_docs.missing_traceparent_verbs() == []
    assert check_metrics_docs.main([]) == 0
    names = check_metrics_docs.registered_metric_names()
    root = os.path.basename(check_metrics_docs._ROOT)
    assert root == "hetu_tpu_torch"
    assert {"serving_ttft_seconds", "serving_attn_kernel_total",
            "moe_expert_tokens", "checkpoint_write_seconds",
            "data_bucket_compiles_total", "adapter_loads_total",
            "prefetch_batches_total"} <= set(names)
