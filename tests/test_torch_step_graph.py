"""The serving step's captured lanes (``hetu_tpu_torch/serving/
step_graph.py``) against ``hetu_tpu``'s one-compile fused step, on the
CPU.

On the CPU each lane is the same ``StepGraph`` object the card replays,
running its body eagerly on the engine's static operand buffers and
copying into its static outputs, so these tests check the plumbing a
replay reads on the card: the operands a step fills, the block tables'
device mirror, the finishing rows of the pack, the outputs a later step
overwrites, the capture accounting and the precision policy a capture
freezes.

Both engines serve the same weights (a ``hetu_tpu`` tree carried over
with ``params_from_jax``) through churn: staggered submits, a pack in
which ``_fin_cap`` prompts finish at once, slots that finish and are
reused, a multi-chunk prompt, and a shared system prompt whose cached
blocks later requests hit (whole blocks plus a copy-on-write tail), on
``GPTConfig.tiny`` (fp32) and ``LlamaConfig.tiny`` (fp32 and int8
arenas). Greedy tokens must be equal, each port lane is captured once
through the run, and the JAX step is not re-traced by it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.engine import trace_counts as jax_trace_counts
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.serving import SamplingParams as JaxSamplingParams
from hetu_tpu.serving import ServingEngine as JaxServingEngine

from hetu_tpu_torch.core import BF16_COMPUTE, FP32, autocast
from hetu_tpu_torch.engine import trace_counts
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel,
    params_from_jax,
)
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.serving import SamplingParams, ServingEngine
from hetu_tpu_torch.engine.step_graph import StepGraph

torch.set_num_threads(2)

SLOTS, MAX_LEN, CHUNK, BLOCK, NEW = 3, 64, 8, 8, 5
LANES = {"decode": "serving_decode", "prefill": "serving_prefill"}
MODELS = {"gpt": (JaxGPTConfig, JaxGPT, GPTConfig, GPTLMHeadModel),
          "llama": (JaxLlamaConfig, JaxLlama, LlamaConfig, LlamaLMHeadModel)}
#: (model, port arena dtype, JAX arena dtype)
CASES = {"gpt_fp32": ("gpt", None, None),
         "llama_fp32": ("llama", None, None),
         "llama_int8": ("llama", torch.int8, jnp.int8)}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jcfg_cls, jcls, cfg_cls, cls) in MODELS.items():
        jmodel = jcls(jcfg_cls.tiny())
        params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
        cfg = cfg_cls.tiny()
        model = cls(cfg, device="cpu")
        model.load_state_dict(
            params_from_jax(jax.tree.map(np.asarray, params), cfg),
            strict=True)
        out[name] = (jmodel, params, model)
    return out


def _port_engine(model, cache_dtype=None, **kw):
    return ServingEngine(model, slots=SLOTS, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, block_size=BLOCK,
                         cache_dtype=cache_dtype, device="cpu", **kw)


def _waves(vocab):
    """Three arrival waves: three prompts short enough to finish in one
    pack (``_fin_cap`` = 3 finishing rows); then a system-prompt request
    and a three-chunk prompt, which wait for reused slots; then two more
    system-prompt requests (a prefix hit of two whole blocks plus a
    copy-on-write tail) and a short one."""
    rng = np.random.default_rng(5)

    def draw(n):
        return rng.integers(1, vocab, n).tolist()

    system = draw(20)                               # 2.5 blocks
    return [[draw(2), draw(3), draw(2)],
            [system + draw(6), draw(19)],
            [system + draw(9), system + draw(4), draw(5)]]


def _serve_waves(eng, sp, waves, between=lambda: None):
    """Submit ``waves`` with two engine iterations between them, then
    drain; ``between`` runs after every iteration. Returns the requests
    in submission order."""
    reqs = []
    for i, wave in enumerate(waves):
        reqs += [eng.submit(p, sp) for p in wave]
        for _ in range(2 if i < len(waves) - 1 else 0):
            eng.step()
            between()
    while eng.has_work():
        eng.step()
        between()
    return reqs


def _lane_delta(before):
    now = trace_counts()
    return {lane: now.get(k, 0) - before.get(k, 0)
            for lane, k in LANES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_graph_engine_matches_jax_engine_through_churn(models, case):
    name, cache_dtype, jax_cache = CASES[case]
    jmodel, params, model = models[name]
    waves = _waves(model.cfg.vocab_size)

    jeng = JaxServingEngine(jmodel, params, slots=SLOTS, max_len=MAX_LEN,
                            prefill_chunk=CHUNK, block_size=BLOCK,
                            cache_dtype=jax_cache, prefill_attn="flash")
    jax_seen = []
    jreqs = _serve_waves(
        jeng, JaxSamplingParams(max_tokens=NEW), waves,
        lambda: jax_seen.append(jax_trace_counts().get("serving_step", 0)))
    # the JAX step traced once, at its first call, and never again
    assert len(set(jax_seen)) == 1

    before = trace_counts()
    eng = _port_engine(model, cache_dtype)
    assert _lane_delta(before) == {"decode": 1, "prefill": 1}
    assert eng._fin_cap == SLOTS
    slot_owners = {s: set() for s in range(SLOTS)}
    stage, staged = eng._stage_locked, []

    def checked_stage():
        # what the lanes read: the device tables mirror the host's whole
        # table (rows of finished slots zeroed, reused slots rewritten)
        out = stage()
        np.testing.assert_array_equal(eng._bt_dev.numpy(), eng._bt)
        staged.append(out is not None)
        return out

    eng._stage_locked = checked_stage

    def audit():
        assert _lane_delta(before) == {"decode": 1, "prefill": 1}
        assert {k: g.captures for k, g in eng.lanes.items()} \
            == {"decode": 1, "prefill": 1}
        for s, r in enumerate(eng._slot_req):
            if r is not None:
                slot_owners[s].add(r.id)
                np.testing.assert_array_equal(eng._bt_dev[s].numpy(),
                                              eng._bt[s])

    sp = SamplingParams(max_tokens=NEW)
    reqs = []
    for i, wave in enumerate(waves):
        reqs += [eng.submit(p, sp) for p in wave]
        if i == 0:
            eng.step()
            audit()
            # the whole first wave finished its prompts in one pack
            assert all(r.first_token_s is not None for r in reqs)
            eng.step()
            audit()
        elif i == 1:
            eng.step()
            audit()
            eng.step()
            audit()
    while eng.has_work():
        eng.step()
        audit()

    assert len(staged) > 10 and all(staged)
    assert [list(r.tokens) for r in reqs] == [list(r.tokens) for r in jreqs]
    assert all(len(r.tokens) == NEW for r in reqs)
    # churn: slots served more than one request; the shared prompt hit
    # whole blocks and a copy-on-write tail
    assert any(len(ids) >= 2 for ids in slot_owners.values())
    hits = [r.cached_tokens for r in reqs]
    assert any(h >= 2 * BLOCK for h in hits) and any(h % BLOCK for h in hits)
    assert eng.lane_iters["decode"] > 0 and eng.lane_iters["prefill"] > 0


@pytest.mark.parametrize("case", ["gpt_fp32", "llama_int8"])
def test_decode_only_step_reads_no_stale_pack(models, case):
    """Before every iteration that has no pack to run, the pack's
    operands are poisoned with live-looking rows (valid, positions and
    tables of a live slot): a decode-only iteration must not replay the
    prefill lane, so tokens, lane counts and the arena match an engine
    whose operands were left alone."""
    name, cache_dtype, _ = CASES[case]
    model = models[name][2]
    waves = _waves(model.cfg.vocab_size)
    sp = SamplingParams(max_tokens=NEW)
    clean = _port_engine(model, cache_dtype)
    want = _serve_waves(clean, sp, waves)
    eng = _port_engine(model, cache_dtype)
    poisoned = []

    def poison():
        if eng._prefilling or eng.scheduler.queue:
            return
        ops = eng._ops
        ops["pf_valid"].fill_(True)
        ops["pf_tok"].fill_(1)
        ops["pf_pos"].copy_(torch.arange(CHUNK))
        ops["pf_slot"].fill_(int(np.argmax(eng._active)))
        ops["pf_seg"].zero_()
        poisoned.append(eng.lane_iters["decode"])

    got = _serve_waves(eng, sp, waves, poison)
    assert len(poisoned) > 2
    assert [list(r.tokens) for r in got] == [list(r.tokens) for r in want]
    assert eng.lane_iters == clean.lane_iters
    for a, b in zip(eng.pool.caches, clean.pool.caches):
        assert torch.equal(a, b)


def test_recorded_first_logits_survive_later_steps(models):
    """``record_first_logits`` copies its rows out of the prefill lane's
    static output, which every later prefill overwrites."""
    model = models["llama"][2]
    eng = _port_engine(model, torch.int8, record_first_logits=True)
    kept = {}

    def keep():
        for r in reqs:
            if r.first_logits is not None and r.id not in kept:
                kept[r.id] = r.first_logits.clone()

    reqs = []
    for wave in _waves(model.cfg.vocab_size):
        reqs += [eng.submit(p, SamplingParams(max_tokens=NEW))
                 for p in wave]
    while eng.has_work():
        eng.step()
        keep()
    assert len(kept) == len(reqs) and eng.lane_iters["prefill"] > 3
    for r in reqs:
        assert torch.equal(r.first_logits, kept[r.id])
        assert r.first_logits.data_ptr() \
            != eng.lanes["prefill"].outputs[0].data_ptr()


def test_changed_policy_recaptures_and_is_counted(models):
    """A step under another precision policy re-captures both lanes (one
    count each, as a JAX re-trace) and serves under that policy: the
    tokens of an engine built under it; back under the first policy,
    one more capture."""
    model = models["gpt"][2]
    prompts = _waves(model.cfg.vocab_size)[1]
    sp = SamplingParams(max_tokens=NEW)
    with autocast(BF16_COMPUTE):
        want_bf16 = _port_engine(model).generate_many(prompts, sp)
    want_fp32 = _port_engine(model).generate_many(prompts, sp)
    before = trace_counts()
    eng = _port_engine(model)
    assert eng.lanes["decode"].policy == FP32
    assert eng.generate_many(prompts, sp) == want_fp32
    assert _lane_delta(before) == {"decode": 1, "prefill": 1}
    with autocast(BF16_COMPUTE):
        assert eng.generate_many(prompts, sp) == want_bf16
    assert _lane_delta(before) == {"decode": 2, "prefill": 2}
    assert all(g.policy == BF16_COMPUTE for g in eng.lanes.values())
    assert eng.generate_many(prompts, sp) == want_fp32
    assert _lane_delta(before) == {"decode": 3, "prefill": 3}
    assert {k: g.captures for k, g in eng.lanes.items()} \
        == {"decode": 3, "prefill": 3}


@pytest.mark.parametrize("case", ["gpt_fp32", "llama_int8"])
def test_capture_and_idle_replays_leave_the_arena_untouched(models, case):
    """Warm-up and capture run with every slot masked and every pack row
    invalid, and so does a replay of the operands a fresh engine holds:
    the arena keeps every bit, here filled with random rows (a
    re-capture under another policy included)."""
    name, cache_dtype, _ = CASES[case]
    model = models[name][2]
    eng = _port_engine(model, cache_dtype)
    g = torch.Generator().manual_seed(1)
    for c in eng.pool.caches:
        if c.dtype == torch.int8:
            c.copy_(torch.randint(-127, 128, c.shape, generator=g))
        else:
            c.copy_(torch.rand(c.shape, generator=g) + 0.5)
    snap = [c.clone() for c in eng.pool.caches]
    with autocast(BF16_COMPUTE):
        for lane in eng.lanes.values():
            lane.replay()
            assert lane.captures == 2
    for lane in eng.lanes.values():
        lane.replay()
    for a, b in zip(eng.pool.caches, snap):
        assert torch.equal(a, b)


def test_capture_error_propagates(models, monkeypatch):
    """A body that fails at its capture fails the engine's constructor
    (no eager fallback, no capture counted); one that fails at a replay
    fails that step."""
    from hetu_tpu_torch.models import generation

    def broken(*args, **kwargs):
        raise RuntimeError("injected body failure")

    model = models["gpt"][2]
    before = trace_counts()
    with monkeypatch.context() as m:
        m.setattr(generation, "decode", broken)
        with pytest.raises(RuntimeError, match="injected body failure"):
            _port_engine(model)
    assert _lane_delta(before)["decode"] == 0

    eng = _port_engine(model)
    eng.submit([1, 2, 3], SamplingParams(max_tokens=3))
    eng.step()                                 # prefill: first token
    monkeypatch.setattr(generation, "decode", broken)
    with pytest.raises(RuntimeError, match="injected body failure"):
        eng.step()                             # the decode lane's replay


def test_step_graph_restores_operands_and_counts_capture():
    """Warm-up and capture run under ``idle``; the operands' values are
    restored after, a capture counts once under its name, and the
    static outputs are overwritten in place by each replay."""
    x = torch.arange(4.0)
    mask = torch.ones(4, dtype=torch.bool)
    seen = []

    def body():
        seen.append(mask.clone())
        return (torch.where(mask, x * 2, x.new_zeros(())),)

    before = trace_counts().get("unit_lane", 0)
    g = StepGraph("unit_lane", body, operands=[mask],
                  idle=lambda: mask.zero_(), device="cpu")
    assert not seen[0].any() and mask.all()
    assert trace_counts()["unit_lane"] - before == 1 and g.captures == 1
    out, = g.outputs
    ptr = out.data_ptr()
    mask[1] = False
    got, = g.replay()
    assert got.data_ptr() == ptr
    assert got.tolist() == [0.0, 0.0, 4.0, 6.0]
    fresh, = g.run_eager()
    assert fresh.data_ptr() != ptr and torch.equal(fresh, got)
    assert trace_counts()["unit_lane"] - before == 1


def test_launches_counted_in_a_capture_go_to_its_tally():
    """A launch counted while a graph is captured goes to the graph's
    tally; each replay adds the tally to the counters."""
    _build.reset_launch_counts()
    with _build.counting_into({}) as tally:
        _build.count_launch("paged_attention")
        _build.count_launch("paged_attention")
        _build.count_launch("flash_fwd")
    assert tally == {"paged_attention": 2, "flash_fwd": 1}
    assert _build.launch_counts() == {}
    _build.count_launch("flash_fwd")
    _build.add_launches(tally)
    _build.add_launches(tally)
    assert _build.launch_counts() == {"paged_attention": 4, "flash_fwd": 3}
    _build.reset_launch_counts()


# -- the kernels' dispatcher ops and their fakes ------------------------------

def _op_cases():
    """One tiny CPU call of each of the port's five dispatcher ops (#1 in
    its fp and int8 arenas): (id, op, args, kwargs)."""
    from hetu_tpu_torch.ops import quantize_int8
    from hetu_tpu_torch.ops.flash import flash_bwd_op, flash_fwd_op
    from hetu_tpu_torch.ops.fused_ce import fused_ce_bwd_op, fused_ce_fwd_op
    from hetu_tpu_torch.ops.paged import paged_attention_op

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, grad=False):
        return torch.randn(*shape, generator=g).requires_grad_(grad)

    S, R, hq, hkv, d, bs, W = 3, 2, 4, 2, 32, 4, 3
    q, k, v = rnd(S, R, hq, d), rnd(1 + S * W, bs, hkv, d), \
        rnd(1 + S * W, bs, hkv, d)
    tables = (1 + torch.arange(S * W, dtype=torch.int32)).view(S, W)
    off = torch.tensor([3, 0, 9], dtype=torch.int32)
    (kq, ks), (vq, vs) = quantize_int8(k), quantize_int8(v)
    b, s = 1, 8
    fq, fk, fv = rnd(b, hq, s, d, grad=True), rnd(b, hkv, s, d, grad=True), \
        rnd(b, hkv, s, d, grad=True)
    seg = torch.tensor([[0, 0, 0, 1, 1, 1, 1, -1]], dtype=torch.int32)
    out, lse = flash_fwd_op(fq.detach(), fk.detach(), fv.detach(), seg, seg,
                            True, d ** -0.5, 0, 0, 0.0, None)
    n, vocab, e = 6, 50, 32
    h, w = rnd(n, e, grad=True), rnd(vocab, e, grad=True)
    labels = torch.tensor([0, 49, -1, 7, 3, 3], dtype=torch.int32)
    flse, _ = fused_ce_fwd_op(h.detach(), w.detach(), labels)
    return [
        ("paged_fp32", paged_attention_op,
         (q, k, v, tables, off, None, None, None, d ** -0.5)),
        ("paged_int8", paged_attention_op,
         (q, kq, vq, tables, off, ks, vs, None, d ** -0.5)),
        ("paged_row_slot", paged_attention_op,
         (q, k, v, tables, off, None, None,
          torch.tensor([2, 2, 0], dtype=torch.int32), d ** -0.5)),
        ("flash_fwd", flash_fwd_op,
         (fq, fk, fv, seg, seg, True, d ** -0.5, 0, 0, 0.0, None)),
        ("flash_fwd_dropout", flash_fwd_op,
         (fq, fk, fv, seg, seg, True, d ** -0.5, 0, 0, 0.1,
          torch.tensor([1234], dtype=torch.int32))),
        ("flash_bwd", flash_bwd_op,
         (fq.detach(), fk.detach(), fv.detach(), seg, seg, out, lse,
          rnd(b, hq, s, d), True, d ** -0.5, 0, 0, 0.0, None)),
        ("fused_ce_fwd", fused_ce_fwd_op, (h, w, labels)),
        ("fused_ce_bwd", fused_ce_bwd_op,
         (h.detach(), w.detach(), labels, flse, rnd(n), rnd(n))),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _op_cases()])
def test_dispatcher_ops_pass_opcheck(case):
    """Each op's schema, fake (``register_fake``: what ``torch.compile``
    traces with), autograd registration and AOT dispatch, held against
    its CPU implementation by ``torch.library.opcheck``."""
    _, op, args = next(c for c in _op_cases() if c[0] == case)
    torch.library.opcheck(op, args)


def test_paged_attention_goes_through_its_op():
    """``ops.paged_attention`` is the op: a trace with fake tensors
    records ``hetu_tpu_torch.paged_attention`` (int8 lane included), and
    its out/lse shapes are the fake's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from hetu_tpu_torch.ops import paged_attention

    _, _, args = next(c for c in _op_cases() if c[0] == "paged_int8")
    q, k, v, tables, off, ks, vs, _, _ = args

    def f(q, k, v, tables, off, ks, vs):
        return paged_attention(q, k, v, tables, off, k_scale=ks, v_scale=vs,
                               return_lse=True)

    with FakeTensorMode(allow_non_fake_inputs=True):
        gm = make_fx(f, tracing_mode="fake")(q, k, v, tables, off, ks, vs)
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert "hetu_tpu_torch.paged_attention.default" in targets
    out, lse = f(q, k, v, tables, off, ks, vs)
    assert out.shape == q.shape and lse.shape == (3, 4, 2)
