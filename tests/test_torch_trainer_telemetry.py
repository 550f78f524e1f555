"""The port's trainer telemetry against ``hetu_tpu``'s.

Both packages' ``Trainer`` run the same ragged batches (a numpy seed,
params carried over with ``params_from_jax``) through
``TrainerConfig(telemetry=True, trace_dir=..., seq_buckets=...)``:
``telemetry.jsonl`` holds the same set of record kinds, the ``data_*``
token counters and ``data_bucket_compiles_total`` are equal, and the
losses agree at the fp32 training tolerance. An MoE model's expert-plane
series (``moe_expert_tokens``, ``moe_aux_loss``,
``moe_overflow_fraction``) match JAX's once the routing is shown to sit
on no near-tie: the gauge exactly, the histogram counts exactly and the
aux sum at 1e-5, for train steps (emitted from the backward, last layer
first) and for ``evaluate`` (from the forward).

Then the port alone: the goodput ledger (a capturing step booked as
``compile``, the next pass ``compute`` only), the checkpoint span and
``checkpoint_write_seconds``, the watchdog, the SLO records, the cluster
aggregate, the export a crashed run leaves, no artifact with telemetry
off, and a captured step's expert plane written on the device and
drained at the log boundary.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import torch

from hetu_tpu import optim as jax_optim
from hetu_tpu import telemetry as jtel
from hetu_tpu.engine.trainer import Trainer as JaxTrainer
from hetu_tpu.engine.trainer import TrainerConfig as JaxTrainerConfig
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.parallel.strategy import Strategy as JaxStrategy

from hetu_tpu_torch import optim, telemetry
from hetu_tpu_torch.engine import (
    StepCache, Trainer, TrainerConfig, build_train_step, init_state,
    make_plan,
)
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from hetu_tpu_torch.nn import moe
from hetu_tpu_torch.parallel import Strategy

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
BUCKETS = (16, 32, 64)
NEAR_TIE = 1e-4


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (jtel, telemetry):
        pkg.enable(False)
        pkg.reset()
    yield
    for pkg in (jtel, telemetry):
        pkg.enable(False)
        pkg.reset()


def _ragged(vocab, seed=0):
    """Six batches of two rows, widths 7..64, with real lengths."""
    rng = np.random.default_rng(seed)

    def mk(width, real):
        ids = rng.integers(1, vocab, (2, width)).astype(np.int32)
        labels = np.full((2, width), -100, np.int32)
        for r, t in enumerate(real):
            labels[r, :t] = ids[r, :t]
        return {"input_ids": ids, "labels": labels}

    return [mk(13, (13, 5)), mk(30, (30, 22)), mk(64, (60, 10)),
            mk(20, (20, 11)), mk(7, (7, 3)), mk(55, (55, 54))]


def _sharpen_gates(params, scale=4.0):
    """The gate weights scaled up (a sharper router than the 0.02 init,
    so every row's routing is decided by a clear margin)."""
    def f(path, leaf):
        keys = [getattr(k, "key", None) for k in path]
        return leaf * scale if "gate" in keys else leaf

    return jax.tree_util.tree_map_with_path(f, params)


def _pair(jcfg, tmp_path, *, sharpen=False, seed=0, **kw):
    """JAX's and the port's Trainer on the same params, telemetry on."""
    jtr = JaxTrainer(JaxGPT(jcfg), jax_optim.adamw(3e-3), JaxStrategy(),
                     config=JaxTrainerConfig(
                         precision="fp32", seed=seed, prefetch=0,
                         telemetry=True, trace_dir=str(tmp_path / "jax"),
                         **kw),
                     devices=jax.devices()[:1])
    jtr.initialize()
    if sharpen:
        jtr.state = jtr.state._replace(
            params=_sharpen_gates(jtr.state.params))
    cfg = GPTConfig(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(GPTConfig)})
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jtr.state.params),
        cfg))
    tr = Trainer(model, optim.adamw(3e-3), Strategy(), device="cpu",
                 step_cache=StepCache(),
                 config=TrainerConfig(precision="fp32", prefetch=0,
                                      telemetry=True,
                                      trace_dir=str(tmp_path / "port"),
                                      **kw))
    return jtr, tr


def _kinds(path):
    return {json.loads(line)["kind"] for line in open(path)}


def _family(snap, prefix):
    return {k: v for k, v in snap.items() if k.startswith(prefix)}


def test_bucketed_trainer_records_and_data_counters_match_jax(tmp_path):
    jtr, tr = _pair(JaxGPTConfig.tiny(), tmp_path, log_every=2,
                    seq_buckets=BUCKETS, slo=True, aggregate_every=3)
    batches = _ragged(256)
    want = [r for r in jtr.train(iter(batches), steps=6) if "loss" in r]
    got = [r for r in tr.train(iter(batches), steps=6) if "loss" in r]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], **TOL)
    js, ps = jtel.get_registry().snapshot(), telemetry.get_registry(
        ).snapshot()
    for fam in ("data_real_tokens_total", "data_padding_tokens_total",
                "data_raw_tokens_total", "data_bucket_hits_total",
                "data_bucket_compiles_total"):
        assert _family(ps, fam) == _family(js, fam), fam
    assert _family(ps, "data_bucket_compiles_total") == {
        f'data_bucket_compiles_total{{bucket="{b}"}}': 1 for b in BUCKETS}
    st = tr.bucketer.stats
    assert ps["data_real_tokens_total"] == st.real_tokens
    assert ps["data_raw_tokens_total"] == st.raw_tokens
    jk = _kinds(tmp_path / "jax" / "telemetry.jsonl")
    pk = _kinds(tmp_path / "port" / "telemetry.jsonl")
    assert pk == jk
    assert {"metrics", "span", "goodput", "measured_step",
            "metrics_snapshot", "cluster_aggregate"} <= pk
    assert os.path.exists(tmp_path / "port" / "trace.json")
    tr.close()
    jtr.close()


def _moe_margin_spy(model):
    margins = []

    def hook(gate, args, out):
        margins.append(moe.routing_margins(gate, args[0]))

    handles = [m.gate.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, moe.MoEMLP)]
    return margins, handles


@pytest.mark.parametrize("log_every", [1, 3, 0])
def test_moe_expert_plane_matches_jax(tmp_path, log_every):
    """``log_every`` 0 leaves a one-step ring and no log boundary: each
    step after the first finds the ring full and drains it first."""
    jcfg = dataclasses.replace(JaxGPTConfig.tiny_moe(), num_layers=3)
    jtr, tr = _pair(jcfg, tmp_path, sharpen=True, seed=3,
                    log_every=log_every)
    batches = _ragged(256, seed=1)[:3]
    batches = [{k: v[:, :32] if v.shape[1] >= 32 else v
                for k, v in b.items()} for b in batches[1:]] * 3
    margins, handles = _moe_margin_spy(tr.model)
    with torch.no_grad():
        for b in batches[:2]:
            tr.model.loss(torch.from_numpy(b["input_ids"]).long(),
                          torch.from_numpy(b["labels"]).long())
    for h in handles:
        h.remove()
    # routing is discrete: the comparison rests on no near-tie
    assert sum(int((m < NEAR_TIE).sum()) for m in margins) == 0
    jtr.train(iter(batches), steps=6)
    tr.train(iter(batches), steps=6)
    js, ps = jtel.get_registry().snapshot(), telemetry.get_registry(
        ).snapshot()
    assert _family(ps, "moe_expert_tokens") \
        == _family(js, "moe_expert_tokens")
    assert len(_family(ps, "moe_expert_tokens")) == 4
    for h in ("moe_aux_loss", "moe_overflow_fraction"):
        assert ps[h]["count"] == js[h]["count"] == 3 * 6
        assert ps[h]["sum"] == pytest.approx(js[h]["sum"], abs=1e-5)
    assert "moe_dropped_tokens_total" not in ps
    # evaluate: the forward's order, the last layer last
    ev = batches[:1]
    assert tr.evaluate(ev) == pytest.approx(jtr.evaluate(ev), abs=1e-5,
                                            rel=1e-5)
    js, ps = jtel.get_registry().snapshot(), telemetry.get_registry(
        ).snapshot()
    assert _family(ps, "moe_expert_tokens") \
        == _family(js, "moe_expert_tokens")
    assert ps["moe_aux_loss"]["count"] == js["moe_aux_loss"]["count"]
    tr.close()
    jtr.close()


def test_captured_step_writes_the_plane_on_the_device():
    """``build_train_step`` of an MoE model captured with telemetry on:
    the ring holds each step's per-layer loads and aux, the drain makes
    one observation a layer and step, and a dense model has no plane."""
    telemetry.enable(True)
    cfg = GPTConfig.tiny_moe()
    model = GPTLMHeadModel(cfg, device="cpu", seed=0)
    opt = optim.adamw(1e-3)
    plan = make_plan(model, opt, Strategy(remat="full"), device="cpu")
    state = init_state(model, opt, plan)
    step = build_train_step(model, opt, plan, expert_steps=2)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 17)))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    for _ in range(2):
        state, _m = step(state, batch)
    plane = step.plane
    assert plane.armed and plane.load.shape == (2, 2, 4)
    # every layer call routed each token to k experts (remat recomputes
    # write the same cells)
    assert torch.all(plane.load.sum(-1) == 2 * 16 * cfg.moe_top_k)
    assert plane.drain() == 2
    snap = telemetry.get_registry().snapshot()
    assert snap["moe_aux_loss"]["count"] == 4
    assert snap["moe_overflow_fraction"]["sum"] == 0.0
    assert plane.drain() == 0
    dense = GPTLMHeadModel(GPTConfig.tiny(), device="cpu", seed=0)
    dplan = make_plan(dense, opt, Strategy(), device="cpu")
    assert build_train_step(dense, opt, dplan).plane is None


def test_a_replay_writes_the_plane_as_its_capture_did():
    """Whether a captured step writes the expert plane is fixed per batch
    signature when it is captured: a replay is armed as its own capture
    was, whatever telemetry is at the replay, and only armed steps take
    ring slots. (On the CPU every call runs the body, so the entry is
    given a CUDA plan and its graphs are stood in for.)"""
    from types import SimpleNamespace

    from hetu_tpu_torch.engine.train_step import CapturedStep, _batch_key
    plane = moe.ExpertPlane(2, 4, steps=4, device="cpu", backward=True)
    entry = CapturedStep("train_step",
                         SimpleNamespace(device=torch.device("cuda")),
                         lambda bufs: (), seeds=False)
    a = {"input_ids": torch.zeros(2, 8, dtype=torch.long)}
    b = {"input_ids": torch.zeros(2, 16, dtype=torch.long)}
    for batch, on in ((a, True), (b, False)):   # the two captures
        telemetry.enable(on)
        entry.arm(plane, batch)
        assert plane.armed == on
        entry.graphs[_batch_key(batch)] = (None, None)
    for batch, on, want in ((b, True, False), (a, False, True),
                            (b, True, False)):  # replays
        telemetry.enable(on)
        entry.arm(plane, batch)
        assert plane.armed == want
    telemetry.enable(True)
    assert plane.drain() == 2                   # a's capture and replay
    entry.release()
    assert entry.armed == {}


def test_goodput_compile_then_compute_and_checkpoint(tmp_path):
    cfg = GPTConfig.tiny()
    tr = Trainer(GPTLMHeadModel(cfg, device="cpu", seed=0),
                 optim.adamw(1e-3), Strategy(), device="cpu",
                 step_cache=StepCache(),
                 config=TrainerConfig(
                     precision="fp32", prefetch=0, log_every=3,
                     telemetry=True, trace_dir=str(tmp_path / "t"),
                     watchdog=True, slo=True, seq_buckets=BUCKETS,
                     peak_flops=1e12))
    batches = _ragged(cfg.vocab_size)
    tr.train(iter(batches), steps=6)
    first = tr.goodput.report()
    assert first.components.get("compile", 0) > 0
    tr.train(iter(batches), steps=6)
    second = tr.goodput.report()
    assert "compile" not in second.components
    assert second.components["compute"] > 0 and second.steps == 6
    assert second.tokens == 2 * (16 + 32 + 64 + 32 + 16 + 64)
    fpt = {w: 6.0 * sum(p.numel() for p in tr.model.parameters())
           + 6.0 * cfg.num_layers * cfg.hidden_size * w for w in BUCKETS}
    flops = sum(2 * w * fpt[w] for w in (16, 32, 64, 32, 16, 64))
    assert second.mfu == pytest.approx(
        flops / second.wall_s / 1e12, rel=1e-9)
    tr.save(str(tmp_path / "ckpt"), wait=True)
    snap = telemetry.get_registry().snapshot()
    assert snap['checkpoint_write_seconds{mode="sync"}']["count"] == 1
    assert snap["checkpoint_seconds_total"] > 0
    names = [e.name for e in telemetry.get_tracer().events()]
    assert {"checkpoint", "checkpoint_gather", "checkpoint_write",
            "compile"} <= set(names)
    kinds = [e["event"] for e in telemetry.get_flight_recorder().events()]
    assert kinds.count("step") == 12 and "checkpoint" in kinds
    assert "compile" in kinds
    assert tr.goodput is not None and "watchdog_trips_total" not in str(
        snap)
    tr.close()


def test_a_crashed_run_exports_and_dumps(tmp_path):
    cfg = GPTConfig.tiny()
    tr = Trainer(GPTLMHeadModel(cfg, device="cpu", seed=0),
                 optim.adamw(1e-3), Strategy(), device="cpu",
                 step_cache=StepCache(),
                 config=TrainerConfig(precision="fp32", prefetch=0,
                                      log_every=1, telemetry=True,
                                      trace_dir=str(tmp_path)))

    def batches():
        yield from _ragged(cfg.vocab_size)[:2]
        raise RuntimeError("loader died")

    with pytest.raises(RuntimeError, match="loader died"):
        tr.train(batches(), steps=5)
    assert _kinds(tmp_path / "telemetry.jsonl") >= {"metrics", "goodput"}
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("flight_")]
    lines = [json.loads(x) for x in open(tmp_path / dumps[0])]
    assert lines[0]["reason"] == "train_error"
    assert lines[-2]["event"] == "train_error" \
        or any(r.get("event") == "train_error" for r in lines)
    tr.close()


def test_telemetry_off_leaves_no_artifacts(tmp_path):
    cfg = GPTConfig.tiny()
    tr = Trainer(GPTLMHeadModel(cfg, device="cpu", seed=0),
                 optim.adamw(1e-3), Strategy(), device="cpu",
                 step_cache=StepCache(),
                 config=TrainerConfig(precision="fp32", prefetch=0,
                                      log_every=1))
    hist = tr.train(iter(_ragged(cfg.vocab_size)[:2]), steps=2)
    assert len(hist) == 2 and "telemetry" not in hist[0]
    assert telemetry.get_tracer().events() == []
    assert telemetry.get_registry().snapshot() == {}
    assert tr.goodput.report().steps == 2
    tr.close()
