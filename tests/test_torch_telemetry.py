"""The port's telemetry modules against ``hetu_tpu``'s.

``hetu_tpu_torch/telemetry/`` keeps its own copies of ``hetu_tpu``'s
jax-free telemetry modules (spans, metrics, flight recorder and
watchdog, goodput, SLO engine, aggregation, federation). The same event
sequence goes into both packages' objects, each with an injected clock
where the object takes one, and every read-out must be equal: registry
snapshots and Prometheus text, chrome-trace events and span records
(timestamps excepted), goodput reports, SLO alerts and status, flight
events and dumps, watchdog trips, health documents, aggregates and
federated pages. The telemetry-off fast path costs under 1% of a real
train step of the port, as ``tests/test_telemetry.py`` asserts for JAX.
"""

import json
import time

import numpy as np
import pytest

import torch

from hetu_tpu import telemetry as jtel
from hetu_tpu.telemetry import aggregate as jagg
from hetu_tpu.telemetry import federation as jfed
from hetu_tpu.telemetry import flight as jflight
from hetu_tpu.telemetry import goodput as jgood
from hetu_tpu.telemetry import slo as jslo
from hetu_tpu.telemetry import spans as jspans
from hetu_tpu.tools import obs_report as jobs
from hetu_tpu.tools import trace_summary as jsum

from hetu_tpu_torch import optim, telemetry
from hetu_tpu_torch.engine import build_train_step, init_state, make_plan
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.parallel import Strategy
from hetu_tpu_torch.telemetry import aggregate, federation, flight, goodput
from hetu_tpu_torch.telemetry import slo, spans
from hetu_tpu_torch.tools import obs_report, trace_summary

torch.set_num_threads(2)

PKGS = {"jax": jtel, "port": telemetry}
MODS = {"jax": dict(spans=jspans, flight=jflight, goodput=jgood, slo=jslo,
                    agg=jagg, fed=jfed, summary=jsum, obs=jobs),
        "port": dict(spans=spans, flight=flight, goodput=goodput, slo=slo,
                     agg=aggregate, fed=federation, summary=trace_summary,
                     obs=obs_report)}


class Clock:
    """A settable clock for the objects that take one."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _clean():
    for pkg in PKGS.values():
        pkg.enable(False)
        pkg.reset()
    yield
    for pkg in PKGS.values():
        pkg.enable(False)
        pkg.reset()


def _drive_registry(pkg):
    reg = pkg.MetricRegistry()
    c = reg.counter("serving_requests_total", "serving requests by outcome")
    c.inc(outcome="submitted")
    c.inc(2, outcome="completed")
    reg.counter("serving_tokens_total", "tokens").inc(7, kind="prompt")
    g = reg.gauge("serving_queue_depth", "requests waiting for a slot")
    g.set(3)
    g.set(1)
    g.set(0.5, tier='h"o\\st\n')
    h = reg.histogram("serving_ttft_seconds", "time submit -> first token")
    for v in (0.1, 0.3, 0.2, 5.0, 0.05):
        h.observe(v)
    h.observe(1.5, path="sampled")
    return reg


def test_registry_snapshot_and_prometheus_text_match():
    regs = {k: _drive_registry(p) for k, p in PKGS.items()}
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert regs["port"].to_prometheus() == regs["jax"].to_prometheus()
    assert regs["port"].to_record() == regs["jax"].to_record()
    # parse the exposition back through either federation module
    assert federation.parse_prometheus(regs["port"].to_prometheus()) \
        == jfed.parse_prometheus(regs["jax"].to_prometheus())


def _drive_tracer(m):
    tr = m["spans"].Tracer()
    with tr.span("compile", bucket=512):
        with tr.span("inner", cat="detail"):
            pass
    tr.complete("queued", 0.25, cat="request", ts_s=1.0,
                tid=m["spans"].REQ_TRACK_BASE + 3, trace_id="abc", req=3)
    tr.name_track(m["spans"].REQ_TRACK_BASE + 3, "req abc")
    tr.instant("mark", step=2)
    tr.record_counters({"mem_bytes": 1.0, "comm_bytes_total": 2.0,
                        "serving_queue_depth": 4.0})
    return tr


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "dur", "ts_s",
                                                       "dur_s", "pid")}


def test_tracer_records_and_chrome_events_match():
    trs = {k: _drive_tracer(m) for k, m in MODS.items()}
    recs = {k: [_strip(r) for r in t.records()] for k, t in trs.items()}
    assert recs["port"] == recs["jax"] and len(recs["port"]) >= 3
    chrome = {k: [_strip(e) for e in t.to_chrome()["traceEvents"]]
              for k, t in trs.items()}
    assert chrome["port"] == chrome["jax"]
    names = {e.get("name") for e in chrome["port"]}
    assert {"compile", "inner", "queued"} <= names
    # the disabled tracer hands out the shared no-op span
    off = spans.Tracer(enabled=False)
    assert off.span("x") is spans.NULL_SPAN and off.events() == []


def test_goodput_reports_match():
    reps = {}
    for k, m in MODS.items():
        clk = Clock(0.0)
        acct = m["goodput"].GoodputAccountant(peak_flops=1e12, clock=clk)
        for cat, s in (("compile", 2.0), ("compute", 5.0), ("stall", 0.5),
                       ("eval", 1.0), ("compute", 3.0), ("checkpoint", 0.7)):
            acct.record(cat, s)
        acct.add_tokens(4096)
        acct.add_step(10)
        acct.flops_per_token = 6e6
        clk.t = 14.0
        acct.freeze()
        clk.t = 99.0                       # frozen: later reads unchanged
        rep = acct.report()
        reps[k] = (rep.to_record(), m["goodput"].format_goodput_table(rep))
    assert reps["port"] == reps["jax"]
    assert reps["port"][0]["mfu"] == pytest.approx(4096 * 6e6 / 14.0 / 1e12,
                                                   abs=1e-6)
    assert goodput.model_flops_per_token.__doc__


def _drive_slo(m, pkg, serving: bool):
    clk = Clock(0.0)
    reg = pkg.MetricRegistry()
    eng = m["slo"].SLOEngine(reg, clock=clk)
    if serving:
        m["slo"].default_serving_rules(eng)
        series = ("serving_ttft_seconds", "serving_tpot_seconds",
                  "serving_step_seconds")
    else:
        m["slo"].default_training_rules(eng)
        series = ("loss", "grad_norm", "step_time_s")
    rng = np.random.default_rng(0)
    alerts = []
    for i in range(400):
        clk.t = float(i)
        regress = i > 300
        for s in series:
            v = float(rng.uniform(0.01, 0.02))
            eng.observe(s, v * (50.0 if regress else 1.0))
        if i % 10 == 0:
            alerts += [a.to_record() for a in eng.evaluate()]
    return alerts, eng.status(), reg.snapshot()


@pytest.mark.parametrize("serving", [False, True])
def test_slo_engines_alert_alike(serving):
    got = {k: _drive_slo(MODS[k], PKGS[k], serving) for k in PKGS}
    strip = lambda recs: [{k: v for k, v in r.items() if k != "ts_unix"}
                          for r in recs]
    assert strip(got["port"][0]) == strip(got["jax"][0])
    assert got["port"][0], "the regression must fire"
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]


def test_flight_recorder_events_and_dump_match(tmp_path):
    out = {}
    for k, m in MODS.items():
        rec = m["flight"].FlightRecorder(capacity=4, rank=0)
        for i in range(6):
            rec.record("step", step=i, trace="t1")
        rec.record("serving_submit", req=1, prompt_len=5)
        path = rec.dump(str(tmp_path / f"{k}.jsonl"), reason="manual")
        lines = [json.loads(x) for x in open(path)]
        out[k] = ([{a: b for a, b in e.items() if a not in ("ts_unix",
                                                             "tid")}
                   for e in rec.events()],
                  [ln["kind"] for ln in lines], len(rec))
    assert out["port"] == out["jax"]
    assert out["port"][2] == 4                      # bounded ring


def test_watchdog_trips_alike_and_reset_clears_trips(tmp_path):
    trips = {}
    for k, m in MODS.items():
        clk = Clock(0.0)
        reg = PKGS[k].MetricRegistry()
        seen = []
        wd = m["flight"].HangWatchdog(
            name="t", factor=4.0, min_timeout_s=1.0, clock=clk,
            dump_dir=str(tmp_path / k), registry=reg,
            on_trip=seen.append)
        for i in range(10):
            clk.t = i * 0.5
            wd.beat()
        clk.t = 4.5 + 1.9                   # 2 s threshold not yet passed
        assert wd.check() is None
        clk.t = 4.5 + 2.5
        assert wd.check() == pytest.approx(2.5)
        assert wd.check() is None           # latched: one trip a hang
        wd.pause()
        clk.t = 100.0
        assert wd.check() is None           # paused across a known block
        trips[k] = (wd.trips, reg.snapshot(), len(seen),
                    m["flight"].watchdog_trip_totals())
        PKGS[k].reset()
        assert m["flight"].watchdog_trip_totals() == {}
    assert trips["port"] == trips["jax"]
    assert trips["port"][0] == 1 and trips["port"][3] == {"t": 1}


def test_health_documents_match():
    docs = {}
    for k, m in MODS.items():
        reg = PKGS[k].MetricRegistry()
        reg.gauge("slo_alerting", "").set(1, rule="ttft_burn")
        reg.counter("slo_alerts_total", "").inc(rule="ttft_burn")
        doc = m["slo"].health_status(reg)
        doc.pop("ts_unix")
        docs[k] = (doc, m["slo"].health_from_snapshot(reg.snapshot()))
    assert docs["port"] == docs["jax"]
    assert docs["port"][0]["status"] == "degraded"


def test_aggregate_and_federation_match():
    snaps = [_drive_registry(p).snapshot() for p in PKGS.values()]
    assert aggregate.aggregate_snapshots(snaps) \
        == jagg.aggregate_snapshots(snaps)
    texts = {"r0": _drive_registry(telemetry).to_prometheus(),
             "r1": _drive_registry(jtel).to_prometheus()}
    # the page's first line stamps the merge's wall clock
    a, b = (m.merge_prometheus(texts).split("\n", 1)
            for m in (federation, jfed))
    assert a[0].startswith("# fleet") and b[0].startswith("# fleet")
    assert a[1] == b[1] and 'replica="_fleet"' in a[1]


def test_cluster_aggregate_over_the_port_coordinator():
    """``cluster_aggregate`` through the port's ``py_server`` KV and
    ``rpc/client.py``, two ranks on one host."""
    import threading

    from hetu_tpu_torch.rpc import CoordinatorClient, py_server
    srv = py_server.PyCoordinatorServer(0)
    srv.start()
    try:
        snaps = [{"x_total": 1.0, "g": 2.0}, {"x_total": 3.0, "g": 4.0}]
        out = [None, None]

        def rank(r):
            cli = CoordinatorClient(srv.port, timeout=20.0)
            out[r] = aggregate.cluster_aggregate(cli, r, 2, snaps[r],
                                                 run="t")
            cli.close()

        ths = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(30)
    finally:
        srv.stop()
    want = jagg.aggregate_snapshots(snaps)
    assert out[0] == want and out[1] == want
    assert want["x_total"]["sum"] == 4.0


def test_export_dir_and_tools_read_alike(tmp_path, capsys):
    """``export_dir`` of the same spans and metrics from each package;
    each package's ``trace_summary`` and ``obs_report`` prints the same
    text for either artifact."""
    for k, pkg in PKGS.items():
        pkg.enable(True)
        with pkg.span("compile", bucket=512):
            pass
        pkg.get_tracer().complete("eval", 0.5)
        reg = pkg.get_registry()
        reg.counter("serving_requests_total", "x").inc(3,
                                                       outcome="completed")
        reg.histogram("serving_ttft_seconds", "y").observe(0.2)
        pkg.get_flight_recorder().record("step", step=1)
        paths = pkg.export_dir(str(tmp_path / k), extra_records=[
            {"kind": "goodput", "wall_s": 2.0, "components":
             {"compute": 1.0}, "tokens": 10, "steps": 1}])
        assert set(paths) == {"trace", "jsonl"}
        pkg.get_flight_recorder().dump(str(tmp_path / k / "flight_0.jsonl"),
                                       reason="manual")
    printed = {}
    for k, m in MODS.items():
        for art in ("jax", "port"):
            m["summary"].main([str(tmp_path / art / "telemetry.jsonl")])
            a = capsys.readouterr().out
            m["obs"].main([str(tmp_path / art)])
            b = capsys.readouterr().out
            printed[(k, art)] = (a, _unstamped(b))
    assert printed[("port", "port")] == printed[("jax", "port")]
    assert printed[("port", "jax")] == printed[("jax", "jax")]
    assert "compile" in printed[("port", "port")][0]


def _unstamped(text):
    """Drop the lines that carry wall-clock stamps or paths."""
    return [ln for ln in text.splitlines()
            if not any(t in ln for t in ("age", "ts", "/", "pid", "ago"))]


def test_telemetry_off_overhead_under_1pct():
    """The acceptance bound of ``tests/test_telemetry.py``: with
    telemetry off, the instrumentation pattern a step executes (two
    spans, two enabled checks, three counter updates, one always-on
    flight event) costs under 1% of a real train step of the port."""
    telemetry.enable(False)
    tracer = telemetry.get_tracer()
    c = telemetry.get_registry().counter("overhead_probe_total")
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu", seed=0)
    opt = optim.adamw(1e-3)
    plan = make_plan(model, opt, Strategy(), device="cpu")
    state = init_state(model, opt, plan)
    step = build_train_step(model, opt, plan)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 33)))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times[1:]))
    flight_rec = telemetry.get_flight_recorder()
    n = 2000
    t0 = time.perf_counter()
    for i in range(n):
        with tracer.span("a", x=1):
            pass
        with tracer.span("b"):
            pass
        if telemetry.enabled():
            c.inc(1.0)
        if telemetry.enabled():
            c.inc(1.0)
        c.inc(1.0)
        flight_rec.record("step", step=i)
    per_step = (time.perf_counter() - t0) / n
    assert per_step < 0.01 * step_s, \
        f"telemetry-off overhead {per_step * 1e6:.1f}us vs step " \
        f"{step_s * 1e3:.2f}ms"
    assert telemetry.get_registry().snapshot() == {}
    assert tracer.events() == []


def test_port_surface_is_jax_surface():
    assert set(telemetry.__all__) == set(jtel.__all__)
    assert [c for c in goodput.CATEGORIES] == list(jgood.CATEGORIES)
    assert spans.REQ_TRACK_BASE == jspans.REQ_TRACK_BASE
