"""The port's step cache and captured train step against ``hetu_tpu``'s.

``StepCache`` is driven the same way as ``hetu_tpu.engine.train_step``'s
(keys, hits and misses, LRU eviction, single-flight builds under two
threads, a ``clear`` during a build) and must read the same. A cached
``Trainer`` step equals JAX's ``Trainer`` step on ``GPTConfig.tiny`` and
Llama tiny (params carried over with ``params_from_jax``): losses at
1e-5 (atol and rtol, the fp32 training tolerance of
``test_torch_train.py``), and under SGD the params after the steps at
1e-5. On the CPU the
captured step runs its body eagerly over the same static buffers, so the
staged operands (rate, bias corrections, seeds) are checked here as the
card replays them: bit for bit against the eager body.
"""

import dataclasses
import threading
import time
import warnings

import numpy as np
import pytest

import jax
import torch

from hetu_tpu import optim as jax_optim
from hetu_tpu.engine.train_step import StepCache as JaxStepCache
from hetu_tpu.engine.trainer import Trainer as JaxTrainer
from hetu_tpu.engine.trainer import TrainerConfig as JaxTrainerConfig
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.parallel.strategy import Strategy as JaxStrategy

from hetu_tpu_torch import optim
from hetu_tpu_torch.engine import (
    CachedStep, StepCache, Trainer, TrainerConfig, build_eval_step,
    build_grad_accum_steps, build_train_step, compile_strategy,
    get_step_cache, init_state, make_plan, trace_counts,
)
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel,
    params_from_jax,
)
from hetu_tpu_torch.optim.schedules import cosine_decay
from hetu_tpu_torch.parallel import Strategy

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
FAMILIES = {"gpt": (JaxGPTConfig, JaxGPT, GPTConfig, GPTLMHeadModel),
            "llama": (JaxLlamaConfig, JaxLlama, LlamaConfig,
                      LlamaLMHeadModel)}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(seed, b=2, s=32, vocab=256):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _tiny_gpt(seed=0, **kw):
    cfg = dataclasses.replace(GPTConfig.tiny(), **kw)
    return GPTLMHeadModel(cfg, device="cpu", seed=seed)


# -- the cache ------------------------------------------------------------------

CACHES = {"jax": JaxStepCache, "port": StepCache}


def _drive(cache_cls):
    """One script of lookups, builds and evictions; returns what it
    read."""
    cache = cache_cls(capacity=2)
    model, opt = object(), object()
    built = []

    def builder(tag):
        def build():
            built.append(tag)
            return tag
        return build

    k = [cache.key_for(model, opt, "s", bucket=b) for b in (0, 16, 32)]
    out = [k[0] == cache.key_for(model, opt, "s"), k[0] != k[1],
           len(k[0]), cache.lookup(k[0])]
    out.append(cache.get_or_build(k[0], builder("a")))
    out.append(cache.get_or_build(k[0], builder("x")))       # a hit
    out.append(cache.get_or_build(k[1], builder("b")))
    out.append(cache.lookup(k[0]))                          # refresh a
    out.append(cache.get_or_build(k[2], builder("c")))      # evicts b
    out += [k[1] in cache, k[0] in cache, len(cache), dict(cache.stats())]
    out.append(list(built))
    return out


def test_step_cache_keys_hits_and_lru_match_jax():
    assert _drive(StepCache) == _drive(JaxStepCache)


@pytest.mark.parametrize("impl", sorted(CACHES))
def test_single_flight_build_under_two_threads(impl):
    """Two threads racing to one key build it once and share it (the
    same on both packages)."""
    cache = CACHES[impl]()
    calls, out = [], []
    gate = threading.Event()

    def build():
        calls.append(1)
        gate.wait(5)
        return object()

    threads = [threading.Thread(target=lambda: out.append(
        cache.get_or_build("k", build))) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in threads:
        t.join(5)
    assert len(calls) == 1 and len(out) == 2 and out[0] is out[1]
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 1


@pytest.mark.parametrize("impl", sorted(CACHES))
def test_clear_during_a_build_keeps_it_out_of_the_pool(impl):
    cache = CACHES[impl]()

    def build():
        cache.clear()
        return "stale"

    assert cache.get_or_build("k", build) == "stale"
    assert "k" not in cache and len(cache) == 0
    assert cache.get_or_build("k", lambda: "fresh") == "fresh"
    assert "k" in cache


def test_compile_strategy_and_the_process_cache():
    model = _tiny_gpt()
    opt = optim.adamw(1e-3)
    entry = compile_strategy(model, opt, Strategy(), device="cpu")
    assert isinstance(entry, CachedStep)
    assert entry.plan.device.type == "cpu" and entry.eval_fn is not None
    assert get_step_cache() is get_step_cache()
    state = init_state(model, opt, entry.plan)
    state, m = entry(state, {k: torch.from_numpy(v)
                             for k, v in _batch(0).items()})
    assert state.step == 1 and torch.isfinite(m["loss"])


def test_trainer_entries_come_from_the_cache_and_step_cache_false_rebuilds():
    model = _tiny_gpt()
    opt = optim.adamw(1e-3)
    cache = StepCache()
    a = Trainer(model, opt, Strategy(), device="cpu", step_cache=cache,
                config=TrainerConfig(precision="fp32"))
    b = Trainer(model, opt, Strategy(), device="cpu", step_cache=cache,
                config=TrainerConfig(precision="fp32"))
    assert a._step_fn is b._step_fn and a._plan_cache is cache
    assert cache.stats() == {"entries": 1, "hits": 1, "misses": 1,
                             "evictions": 0, "hit_rate": 0.5}
    c = Trainer(model, opt, Strategy(), device="cpu", step_cache=cache,
                config=TrainerConfig(precision="fp32", step_cache=False))
    assert c._step_fn is not a._step_fn and len(cache) == 1


# -- the cached step against JAX's ----------------------------------------------

OPTS = {"adamw": (lambda: jax_optim.adamw(3e-3, weight_decay=0.01),
                  lambda: optim.adamw(3e-3, weight_decay=0.01)),
        "sgd": (lambda: jax_optim.sgd(0.1, momentum=0.9),
                lambda: optim.sgd(0.1, momentum=0.9))}


def _pair(family, kind):
    jcfg_cls, jcls, cfg_cls, cls = FAMILIES[family]
    jopt, opt = OPTS[kind]
    jcfg = jcfg_cls.tiny()
    jmodel = jcls(jcfg)
    jtr = JaxTrainer(jmodel, jopt(), JaxStrategy(),
                     config=JaxTrainerConfig(log_every=1, precision="fp32",
                                             seed=0),
                     devices=jax.devices()[:1])
    jtr.initialize()
    cfg = cfg_cls(**{f.name: getattr(jcfg, f.name)
                     for f in dataclasses.fields(cfg_cls)})
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np(jtr.state.params), cfg))
    tr = Trainer(model, opt(), Strategy(), device="cpu",
                 step_cache=StepCache(),
                 config=TrainerConfig(log_every=1, precision="fp32",
                                      prefetch=0))
    return jtr, tr, cfg


@pytest.mark.parametrize("kind", sorted(OPTS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cached_trainer_step_matches_jax(family, kind):
    """Three cached steps against JAX's: loss at 1e-5, the norm at 1e-4
    (``test_torch_trainer.py``'s); under SGD the params at 1e-5 too
    (AdamW divides near-zero grads by their own noise, so its params are
    held through the losses)."""
    jtr, tr, cfg = _pair(family, kind)
    before = trace_counts().get("train_step", 0)
    for i in range(3):
        batch = _batch(i, vocab=cfg.vocab_size)
        want = jtr.train_step(batch)
        got = tr.train_step(batch)
        np.testing.assert_allclose(float(got["loss"]),
                                   float(want["loss"]), **TOL)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-4)
    assert trace_counts()["train_step"] - before == 1
    if kind != "sgd":
        return
    for name, t in params_from_jax(_np(jtr.state.params), cfg).items():
        np.testing.assert_allclose(
            dict(tr.model.named_parameters())[name].detach().numpy(),
            t.numpy(), err_msg=name, **TOL)


def _twins(opt, **cfg_kw):
    """A model and its twin from one seed, with their states and steps."""
    out = []
    for _ in range(2):
        model = _tiny_gpt(**cfg_kw)
        plan = make_plan(model, opt, Strategy(remat="full"), device="cpu")
        out.append((model, init_state(model, opt, plan),
                    build_train_step(model, opt, plan)))
    return out


@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_staged_scalars_bit_equal_to_the_eager_body(drop):
    """Five steps under ``cosine_decay`` (and dropout), through the
    captured entry and through its eager body on a twin: losses, norms
    and params bit-equal, the staged rate and bias corrections the host's
    float32 values, and no extra (warm-up) step: the first call is the
    step itself."""
    sched = cosine_decay(3e-3, 5, warmup_steps=2)
    opt = optim.adamw(sched, weight_decay=0.01)
    (ma, sa, step_a), (mb, sb, step_b) = _twins(opt, attn_pdrop=drop,
                                                resid_pdrop=drop)
    before = trace_counts().get("train_step", 0)
    for i in range(5):
        batch = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        sa, got = step_a(sa, batch)
        sb, want = step_b.body(sb, batch)
        assert torch.equal(got["loss"], want["loss"]), i
        assert torch.equal(got["grad_norm"], want["grad_norm"]), i
        for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
            assert torch.equal(p, q), (i, n)
        sc = sa.optimizer.scalars.tolist()
        c = np.float32(i + 1)
        assert sc[0] == -sched(i)
        assert sc[1] == float(np.float32(1) / (np.float32(1)
                                               - np.float32(0.9) ** c))
        assert sc[2] == float(np.float32(1) / (np.float32(1)
                                               - np.float32(0.999) ** c))
    assert sa.step == 5 and {st["count"] for st in
                             sa.optimizer.state.values()} == {5}
    assert trace_counts()["train_step"] - before == 1
    assert step_a.entry.captures == 1 and len(step_a.entry.graphs) == 1


def test_dropout_steps_replay_their_own_seed():
    """With dropout, two steps on one batch draw two masks (the loss
    differs), and the seed words of the table are the host's
    derivation of each step's seed."""
    from hetu_tpu_torch.engine.train_step import step_dropout_seed
    opt = optim.sgd(0.0)
    (ma, sa, step_a), _ = _twins(opt, attn_pdrop=0.3, resid_pdrop=0.3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    sa, m0 = step_a(sa, batch)
    l0 = float(m0["loss"])
    sa, m1 = step_a(sa, batch)
    assert float(m1["loss"]) != l0
    table = step_a.entry.seeds
    assert table.root == step_dropout_seed(1)
    for path, i in table._slots.items():
        word = int(table.words[i]) & 0xFFFFFFFF
        assert word == table.value(path)
    # replaying step 0's seed gives step 0's loss back
    sa.step = 0
    sa, again = step_a(sa, batch)
    assert float(again["loss"]) == l0


def test_a_replaced_optimizer_recaptures():
    opt = optim.adamw(1e-3)
    (model, state, step), _ = _twins(opt)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    assert step.entry.captures == 1
    state.optimizer = opt.build(model)
    state, _ = step(state, batch)
    assert step.entry.captures == 1 and len(step.entry.graphs) == 1
    assert step.entry._bound[0] == id(state.optimizer)


def test_resume_into_a_live_trainer_copies_in_place(tmp_path):
    model = _tiny_gpt()
    tr = Trainer(model, optim.adamw(3e-3), Strategy(), device="cpu",
                 step_cache=StepCache(),
                 config=TrainerConfig(precision="fp32", prefetch=0))
    batches = [_batch(i) for i in range(4)]
    for b in batches[:2]:
        tr.train_step(b)
    tr.save(str(tmp_path / "ck"), wait=True)
    want = [float(tr.train_step(b)["loss"]) for b in batches[2:]]
    mu = {id(p): st["mu"].data_ptr()
          for p, st in tr.state.optimizer.state.items()}
    before = trace_counts().get("train_step", 0)
    tr.resume(str(tmp_path / "ck"))
    assert tr.state.step == 2
    assert {id(p): st["mu"].data_ptr()
            for p, st in tr.state.optimizer.state.items()} == mu
    got = [float(tr.train_step(b)["loss"]) for b in batches[2:]]
    assert got == want
    assert trace_counts().get("train_step", 0) == before    # no re-capture


def test_train_step_hands_out_copies():
    tr = Trainer(_tiny_gpt(), optim.adamw(1e-3), Strategy(), device="cpu",
                 step_cache=StepCache(),
                 config=TrainerConfig(precision="fp32", prefetch=0))
    a = tr.train_step(_batch(0))
    la = float(a["loss"])
    tr.train_step(_batch(1))
    assert float(a["loss"]) == la


# -- a caller's loss and the eval step ------------------------------------------

def test_custom_loss_fn_and_the_dropout_contract():
    model = _tiny_gpt(resid_pdrop=0.1)
    opt = optim.sgd(0.0)
    plan = make_plan(model, opt, Strategy(), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}

    def plain(b):
        return 2.0 * model.loss(b["input_ids"], b["labels"])

    with pytest.warns(UserWarning, match="dropout will be OFF"):
        step = build_train_step(model, opt, plan, loss_fn=plain)
    state = init_state(model, opt, plan)
    state, m = step(state, batch)
    with torch.no_grad():
        ref = float(model.loss(batch["input_ids"], batch["labels"]))
    np.testing.assert_allclose(float(m["loss"]), 2.0 * ref, rtol=1e-6)

    def kw(b, **k):
        return model.loss(b["input_ids"], b["labels"], **k)

    with pytest.warns(UserWarning, match="via \\*\\*kwargs"):
        assert build_train_step(model, opt, plan, loss_fn=kw).thread_dropout

    def explicit(b, dropout_seed=None):
        return model.loss(b["input_ids"], b["labels"],
                          dropout_seed=dropout_seed)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert build_train_step(model, opt, plan,
                                loss_fn=explicit).thread_dropout
    ev = build_eval_step(model, plan, loss_fn=plain)
    np.testing.assert_allclose(float(ev(batch)), 2.0 * ref, rtol=1e-6)


def test_eval_step_is_captured_once_and_equals_its_body():
    model = _tiny_gpt(attn_pdrop=0.2)
    plan = make_plan(model, optim.sgd(0.0), Strategy(), device="cpu")
    ev = build_eval_step(model, plan)
    before = trace_counts().get("eval_step", 0)
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        assert torch.equal(ev(batch), ev.body(batch))
    assert trace_counts()["eval_step"] - before == 1


# -- the graphs' lifetime: one shared pool an entry, released --------------------

def _live(refs):
    """How many of the weakly referenced ``StepGraph``s are alive."""
    import gc
    gc.collect()
    return sum(r() is not None for r in refs)


def _graph_refs(*entries):
    import weakref
    return [weakref.ref(g) for e in entries
            for fn in (e.step_fn, e.eval_fn) if fn is not None
            for g, _ in fn.entry.graphs.values()]


def _bucketed(cache, **kw):
    return Trainer(_tiny_gpt(), optim.adamw(1e-3), Strategy(), device="cpu",
                   step_cache=cache,
                   config=TrainerConfig(precision="fp32", prefetch=0,
                                        seq_buckets=(16, 32), **kw))


def _widths(*ws):
    return [_batch(i, s=w) for i, w in enumerate(ws)]


@pytest.mark.parametrize("how", ["evict", "clear", "close"])
def test_released_entries_leave_no_graph_alive(how):
    """An evicted entry, a cleared cache and a closed Trainer each drop
    their ``StepGraph``s (and with them the pools); a caller still
    holding an entry captures again at its next call."""
    cache = StepCache(capacity=2 if how == "evict" else 8)
    tr = _bucketed(cache)
    for b in _widths(12, 30, 9):
        tr.train_step(b)
    entries = [tr._bucket_entries[16], tr._bucket_entries[32]]
    refs = _graph_refs(*entries)
    assert len(refs) == 2 and _live(refs) == 2
    if how == "evict":
        # a third key evicts the oldest: the base entry, then bucket 16
        _bucketed(cache)
        cache.get_or_build(("other",), lambda: compile_strategy(
            _tiny_gpt(), optim.adamw(1e-3), Strategy(), device="cpu"))
        assert cache.evictions >= 2 and _live(refs[:1]) == 0
    elif how == "clear":
        cache.clear()
        assert _live(refs) == 0
    else:
        tr.close()
        assert _live(refs) == 0 and len(cache) == 0
        before = trace_counts().get("train_step", 0)
        tr.train_step(_batch(0, s=12))          # captures again
        assert trace_counts().get("train_step", 0) == before + 1


def test_a_second_trainer_does_not_keep_the_first_ones_graphs():
    cache = StepCache()
    first = _bucketed(cache)
    for b in _widths(12, 30):
        first.train_step(b)
    refs = _graph_refs(*first._bucket_entries.values())
    assert _live(refs) == 2
    del first                                   # dropped, never closed
    second = _bucketed(cache)
    second.train_step(_batch(0, s=12))
    assert _live(refs) == 0
    assert len(cache) == 2                      # the second's entries only
    assert len(_graph_refs(*second._bucket_entries.values())) == 1


def test_static_outputs_survive_a_replay_of_another_signature():
    """Each signature's outputs are its own buffers, made before its
    capture: a replay of another signature of the same entry (sharing
    its pool) leaves them as they were."""
    model = _tiny_gpt()
    opt = optim.adamw(1e-3)
    plan = make_plan(model, opt, Strategy(), device="cpu")
    state = init_state(model, opt, plan)
    step = build_train_step(model, opt, plan)
    t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    state, a = step(state, t(_batch(0, s=16)))
    state, b = step(state, t(_batch(1, s=32)))
    la = float(a["loss"])
    state, b = step(state, t(_batch(2, s=32)))  # a replay of the other
    assert float(a["loss"]) == la
    assert a["loss"].data_ptr() != b["loss"].data_ptr()
    outs = [g.outputs for g, _ in step.entry.graphs.values()]
    assert len(outs) == 2 and all(len(o) == 2 for o in outs)
    step.entry.release()
    assert step.entry.graphs == {}


def test_a_trainers_entries_share_one_pool():
    """Every entry a Trainer builds (each bucket's step and eval)
    captures into the trainer's one pool; split-phase steps share one
    too; a step built alone has its own."""
    tr = _bucketed(StepCache())
    for b in _widths(12, 30):
        tr.train_step(b)
    entries = [tr._bucket_entries[16], tr._bucket_entries[32],
               tr._entry(0)]
    pools = {id(fn.entry.pool) for e in entries
             for fn in (e.step_fn, e.eval_fn)}
    assert pools == {id(tr._pool)}
    model = _tiny_gpt()
    opt = optim.adamw(1e-3)
    plan = make_plan(model, opt, Strategy(), device="cpu")
    _init, grad_step, apply_step = build_grad_accum_steps(model, opt, plan)
    assert grad_step.entry.pool is apply_step.entry.pool
    alone = build_train_step(model, opt, plan)
    assert alone.entry.pool is not grad_step.entry.pool
