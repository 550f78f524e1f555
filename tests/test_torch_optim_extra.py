"""The rest of ``optim/`` and the auxiliary losses against ``hetu_tpu``'s:
``adagrad``, ``adafactor`` (factored and unfactored leaves, the RMS clip
over a stacked block leaf), ``adam(amsgrad=True)`` and ``adamw`` with a
scheduled weight decay, each for three updates of GPT tiny's params from
one tree with the same random grads (params at 1e-5, atol and rtol, the
fp32 training tolerance of ``test_torch_train.py``); the schedules
``inverse_sqrt``, ``wd_increment`` and ``linear_decay`` over 30 steps
(rtol 1e-6: float32 arithmetic in another order); the fp16 scaler
exactly; the five auxiliary losses at 1e-6. Each optimizer's state
crosses to ``hetu_tpu``'s checkpoint format and back bit for bit."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import optim as jax_optim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.ops import losses as jax_losses
from hetu_tpu.optim import schedules as jax_sched
from hetu_tpu.optim.base import apply_updates as jax_apply_updates
from hetu_tpu.utils import checkpoint as jax_ckpt

from hetu_tpu_torch import optim
from hetu_tpu_torch.engine import Trainer, TrainerConfig
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from hetu_tpu_torch.ops import losses
from hetu_tpu_torch.parallel import Strategy
from hetu_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


#: (hetu_tpu's optimizer, the port's) by name
OPTS = {
    "adagrad": (lambda: jax_optim.adagrad(0.05, initial_accumulator=0.1),
                lambda: optim.adagrad(0.05, initial_accumulator=0.1)),
    "adafactor": (lambda: jax_optim.adafactor(
        jax_sched.inverse_sqrt(0.01, warmup_steps=2),
        min_dim_size_to_factor=32, weight_decay=0.01),
        lambda: optim.adafactor(optim.inverse_sqrt(0.01, warmup_steps=2),
                                min_dim_size_to_factor=32,
                                weight_decay=0.01)),
    "adafactor_unfactored": (lambda: jax_optim.adafactor(0.01),
                             lambda: optim.adafactor(0.01)),
    "amsgrad": (lambda: jax_optim.adam(3e-3, amsgrad=True),
                lambda: optim.adam(3e-3, amsgrad=True)),
    "adamw_wd_schedule": (lambda: jax_optim.adamw(
        3e-3, weight_decay=jax_sched.wd_increment(0.0, 0.1, 2)),
        lambda: optim.adamw(3e-3, weight_decay=optim.wd_increment(
            0.0, 0.1, 2))),
}


def _pair():
    jcfg = JaxGPTConfig.tiny()
    jmodel = JaxGPT(jcfg)
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = GPTConfig(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(GPTConfig)})
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np(params), cfg))
    return jmodel, params, model, cfg


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_optimizer_updates_match_jax(kind):
    jopt, opt = (f() for f in OPTS[kind])
    jmodel, params, model, cfg = _pair()
    jstate = jopt.init(params)
    spec = opt
    torch_opt = spec.build(model)
    named = dict(model.named_parameters())
    rng = np.random.default_rng(5)
    for count in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape) * 1e-2,
                                  jnp.float32), params)
        upd, jstate = jopt.update(grads, jstate, params)
        params = jax_apply_updates(params, upd)
        port = params_from_jax(_np(grads), cfg)
        spec.step(torch_opt, count, {named[n]: g for n, g in port.items()})
    for name, t in params_from_jax(_np(params), cfg).items():
        np.testing.assert_allclose(named[name].detach().numpy(), t.numpy(),
                                   err_msg=name, **TOL)


def test_adafactor_factors_by_hetu_tpus_leaf_shapes():
    _, _, model, _ = _pair()
    opt = optim.adafactor(0.01, min_dim_size_to_factor=32).build(model)
    st = {n: opt.state[p] for n, p in model.named_parameters()}
    # a Linear weight (out, in) keeps hetu_tpu's (in,) rows, (out,) cols
    q = st["blocks.0.attn.q_proj.weight"]
    assert q["v_row"].shape == (64,) and q["v_col"].shape == (64,)
    up = st["blocks.1.mlp.fc_in.weight"]                 # (256, 64)
    assert up["v_row"].shape == (64,) and up["v_col"].shape == (256,)
    wte = st["wte.weight"]                  # (V, E) alike in both
    assert wte["v_row"].shape == (256,) and wte["v_col"].shape == (64,)
    assert set(st["ln_f.scale"]) == {"count", "v"}
    assert set(st["blocks.0.ln_1.scale"]) == {"count", "v"}
    assert tuple(opt.scalars.shape) == (4,)


@pytest.mark.parametrize("name,args", [
    ("inverse_sqrt", (0.01,)), ("inverse_sqrt", (0.01, 5, 1e-4)),
    ("inverse_sqrt", (0.01, 5, 1e-4, 20)),
    ("linear_decay", (1e-3, 20)), ("linear_decay", (1e-3, 20, 5, 1e-5)),
    ("wd_increment", (0.0, 0.1, 10)), ("wd_increment", (0.0, 0.1, 10,
                                                        "cosine")),
    ("wd_increment", (0.05, 0.05, 10, "constant")),
    ("cosine_decay", (1e-3, 20, 5, 1e-5)), ("linear_warmup", (1e-3, 7)),
])
def test_schedules_match_jax(name, args):
    got = getattr(optim, name)(*args)
    want = getattr(jax_sched, name)(*args)
    for step in range(30):
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert np.isclose(got(step), w, rtol=1e-6, atol=0), (step,
                                                             got(step), w)
        assert got(step) == float(np.float32(got(step)))   # float32 values
    with pytest.raises(ValueError, match="start_wd == end_wd"):
        optim.wd_increment(0.0, 0.1, 10, "constant")


def test_scaler_matches_jax():
    st, jst = optim.init_scaler(1024.0), jax_optim.init_scaler(1024.0)
    loss = torch.tensor(0.75)
    assert float(optim.scale_loss(st, loss)) == float(
        jax_optim.scale_loss(jst, jnp.float32(0.75)))
    rng = np.random.default_rng(0)
    for step in range(7):
        gs = [rng.normal(size=(3, 4)).astype(np.float32) * 100,
              rng.normal(size=(5,)).astype(np.float32)]
        if step in (2, 5):
            gs[1][3] = np.inf if step == 2 else np.nan
        got, fin = optim.unscale_and_check(st, [torch.from_numpy(g)
                                                for g in gs])
        want, jfin = jax_optim.unscale_and_check(jst, [jnp.asarray(g)
                                                       for g in gs])
        assert bool(fin) == bool(jfin)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        st = optim.update_scaler(st, fin, growth_interval=2)
        jst = jax_optim.update_scaler(jst, jfin, growth_interval=2)
        assert float(st.scale) == float(jst.scale)
        assert int(st.growth_tracker) == int(jst.growth_tracker)
        assert st.scale.dtype == torch.float32
        assert st.growth_tracker.dtype == torch.int32


def test_auxiliary_losses_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6, 5)).astype(np.float32)
    y = rng.normal(size=(4, 6, 5)).astype(np.float32)
    probs = 1 / (1 + np.exp(-x))
    tgt = (rng.random((4, 6, 5)) > 0.5).astype(np.float32)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    q = np.exp(y) / np.exp(y).sum(-1, keepdims=True)
    labels = rng.integers(0, 5, (4, 6)).astype(np.int64)
    labels[0, :3] = -100
    t = torch.from_numpy
    cases = [
        ("mse_loss", (x, y), {}), ("bce_loss", (probs, tgt), {}),
        ("bce_with_logits_loss", (x, tgt), {}),
        ("kl_div_loss", (logp, q), {}), ("nll_loss", (logp, labels), {}),
    ]
    for name, arrays, kw in cases:
        reductions = ("batchmean", "mean", "sum", "none") \
            if name == "kl_div_loss" else ("mean", "sum", "none")
        for red in reductions:
            got = getattr(losses, name)(*map(t, arrays), reduction=red)
            want = getattr(jax_losses, name)(
                *map(jnp.asarray, arrays), reduction=red)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {red}")
    labels3 = np.where(labels == -100, 3, labels)
    got = losses.nll_loss(t(logp), t(labels3), ignore_index=3)
    want = jax_losses.nll_loss(jnp.asarray(logp), jnp.asarray(labels3),
                               ignore_index=3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown reduction"):
        losses.mse_loss(t(x), t(y), reduction="max")


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_optimizer_state_crosses_to_hetu_tpu_and_back(kind, tmp_path):
    """Two port steps, saved; ``hetu_tpu``'s ``load_checkpoint`` reads
    every leaf of its own optimizer tree from it; ``hetu_tpu`` saves the
    state again and the port loads it back bit for bit."""
    jopt, opt = (f() for f in OPTS[kind])
    jmodel, _, model, _ = _pair()
    tr = Trainer(model, opt, Strategy(), device="cpu",
                 config=TrainerConfig(precision="fp32", prefetch=0))
    rng = np.random.default_rng(0)
    for _ in range(2):
        ids = rng.integers(0, 256, (2, 33))
        tr.train_step({"input_ids": ids[:, :-1].astype(np.int32),
                       "labels": ids[:, 1:].astype(np.int32)})
    tr.save(str(tmp_path / "port"), wait=True)
    state = jax_ckpt.load_checkpoint(str(tmp_path / "port"), jmodel, jopt)
    assert int(state.step) == 2
    flat = jax_ckpt._flatten(state.opt_state)
    jflat = jax_ckpt._flatten(jopt.init(jmodel.abstract_params()))
    assert sorted(flat) == sorted(jflat)
    for k in flat:
        assert flat[k].shape == jflat[k].shape, k
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), state)
    back = ckpt.load_checkpoint(str(tmp_path / "jax"), model, opt)
    assert back.step == 2
    for p, st in tr.state.optimizer.state.items():
        other = back.optimizer.state[p]
        assert sorted(other) == sorted(st)
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(other[k], v), k
            else:
                assert other[k] == v, k
