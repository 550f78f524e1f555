"""Split-phase accumulation (``build_grad_accum_steps``) against
``hetu_tpu``'s: ``init_acc``/``grad_step``/``apply_step`` on GPT tiny
fp32 from one parameter tree, each grad step's loss and the params after
the update at 1e-5 (atol and rtol, the fp32 training tolerance of
``test_torch_train.py``); ``donate_acc`` both ways, the refusal
included; dropout seeds folded per ``accum_index``, held bit for bit to
the in-step microbatches of ``num_microbatches``."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import optim as jax_optim
from hetu_tpu.engine.state import new_train_state
from hetu_tpu.engine.train_step import build_grad_accum_steps as jax_accum
from hetu_tpu.engine.train_step import make_plan as jax_make_plan
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.parallel.strategy import Strategy as JaxStrategy

from hetu_tpu_torch import optim
from hetu_tpu_torch.engine import (
    build_grad_accum_steps, build_train_step, init_state, make_plan,
    trace_counts,
)
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from hetu_tpu_torch.parallel import Strategy

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _batch(seed, b=2, s=32, vocab=256):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_grad_accum_matches_jax():
    jcfg = JaxGPTConfig.tiny()
    jmodel = JaxGPT(jcfg)
    jopt = jax_optim.sgd(0.1, momentum=0.9)
    jplan = jax_make_plan(jmodel, jopt, JaxStrategy(), jax.devices()[:1])
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    jstate = new_train_state(params, jopt)
    j_init, j_grad, j_apply = jax_accum(jmodel, jopt, jplan)
    cfg = GPTConfig(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(GPTConfig)})
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np(params), cfg))
    opt = optim.sgd(0.1, momentum=0.9)
    plan = make_plan(model, opt, Strategy(), device="cpu")
    state = init_state(model, opt, plan)
    init_acc, grad_step, apply_step = build_grad_accum_steps(model, opt,
                                                             plan)
    for update in range(2):
        jacc, acc = j_init(), init_acc()
        for i in range(3):
            b = _batch(10 * update + i)
            jacc, jloss = j_grad(jstate, jacc, b, accum_index=i)
            acc, loss = grad_step(state, acc, _t(b), accum_index=i)
            np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        jstate, jm = j_apply(jstate, jacc, 3)
        state, m = apply_step(state, acc, 3)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 2
    for name, t in params_from_jax(_np(jstate.params), cfg).items():
        np.testing.assert_allclose(
            dict(model.named_parameters())[name].detach().numpy(),
            t.numpy(), err_msg=name, **TOL)


def _setup(donate_acc=True, **cfg_kw):
    cfg = dataclasses.replace(GPTConfig.tiny(), **cfg_kw)
    model = GPTLMHeadModel(cfg, device="cpu", seed=0)
    opt = optim.adamw(1e-3)
    plan = make_plan(model, opt, Strategy(), device="cpu")
    state = init_state(model, opt, plan)
    return model, opt, plan, state, build_grad_accum_steps(
        model, opt, plan, donate_acc=donate_acc)


def test_donate_acc_consumes_the_accumulator():
    _, _, _, state, (init_acc, grad_step, apply_step) = _setup(True)
    acc = init_acc()
    acc, _ = grad_step(state, acc, _t(_batch(0)))
    state, _ = apply_step(state, acc, 1)
    assert acc.consumed
    with pytest.raises(RuntimeError, match="donated"):
        init_acc(like=acc)
    with pytest.raises(RuntimeError, match="donated"):
        grad_step(state, acc, _t(_batch(1)))
    fresh = init_acc()
    assert not fresh.consumed and all(not g.any() for g in fresh.grads)


def test_donate_acc_false_recycles_the_buffer():
    _, _, _, state, (init_acc, grad_step, apply_step) = _setup(False)
    acc = init_acc()
    ptrs = [g.data_ptr() for g in acc.grads]
    acc, _ = grad_step(state, acc, _t(_batch(0)))
    assert any(g.any() for g in acc.grads)
    state, _ = apply_step(state, acc, 1)
    again = init_acc(like=acc)
    assert again is acc and [g.data_ptr() for g in again.grads] == ptrs
    assert all(not g.any() for g in again.grads)


def test_steps_capture_once_across_indices():
    before = trace_counts()
    _, _, _, state, (init_acc, grad_step, apply_step) = _setup(
        False, attn_pdrop=0.1)
    for _ in range(2):
        acc = init_acc()
        for i in range(3):
            acc, _ = grad_step(state, acc, _t(_batch(i)), accum_index=i)
        state, _ = apply_step(state, acc, 3)
    now = trace_counts()
    assert {k: now.get(k, 0) - before.get(k, 0)
            for k in ("grad_step", "apply_step")} == {"grad_step": 1,
                                                      "apply_step": 1}
    assert len(grad_step.entry.graphs) == 1


def test_dropout_seeds_fold_the_index_as_the_in_step_microbatches():
    """Four grad steps (one row each, ``accum_index`` 0-3) and an update
    equal one step of ``num_microbatches=4`` on the four rows, bit for
    bit, with dropout on; a different index draws a different mask."""
    cfg = dataclasses.replace(GPTConfig.tiny(), attn_pdrop=0.2,
                              resid_pdrop=0.2, embd_pdrop=0.1)
    opt = optim.adamw(1e-3)
    a = GPTLMHeadModel(cfg, device="cpu", seed=0)
    plan_a = make_plan(a, opt, Strategy(num_microbatches=4), device="cpu")
    sa = init_state(a, opt, plan_a)
    b = GPTLMHeadModel(cfg, device="cpu", seed=0)
    plan_b = make_plan(b, opt, Strategy(), device="cpu")
    sb = init_state(b, opt, plan_b)
    init_acc, grad_step, apply_step = build_grad_accum_steps(b, opt, plan_b)
    batch = _t(_batch(3, b=4))
    sa, ma = build_train_step(a, opt, plan_a)(sa, batch)
    acc, losses = init_acc(), []
    for i in range(4):
        acc, loss = grad_step(sb, acc, {k: v[i:i + 1]
                                        for k, v in batch.items()},
                              accum_index=i)
        losses.append(loss.clone())
    sb, mb = apply_step(sb, acc, 4)
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])
    np.testing.assert_allclose(float(ma["loss"]),
                               float(torch.stack(losses).mean()), **TOL)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    # the index is folded into the seed: index 1 on row 0 draws another
    # mask than index 0 did
    acc = init_acc()
    row0 = {k: v[:1] for k, v in batch.items()}
    _, l0 = grad_step(sb, acc, row0, accum_index=0)
    l0 = float(l0)
    _, l1 = grad_step(sb, acc, row0, accum_index=1)
    l1 = float(l1)          # read now: the next call overwrites it
    _, l0_again = grad_step(sb, acc, row0, accum_index=0)
    assert l1 != l0 and float(l0_again) == l0


def test_refusals_match_jax():
    model, opt, plan, _, _ = _setup()
    build_grad_accum_steps(model, opt, plan, delay_grad_sync=True)
    fsdp = make_plan(model, opt, Strategy(fsdp=True), device="cpu")
    with pytest.raises(ValueError, match="incompatible with fsdp"):
        build_grad_accum_steps(model, opt, fsdp, delay_grad_sync=True)
    with pytest.warns(UserWarning, match="dropout will be OFF in "
                                         "build_grad_accum_steps"):
        m2 = GPTLMHeadModel(dataclasses.replace(GPTConfig.tiny(),
                                                attn_pdrop=0.1),
                            device="cpu")
        build_grad_accum_steps(m2, opt, make_plan(m2, opt, Strategy(),
                                                  device="cpu"),
                               loss_fn=lambda b: m2.loss(b["input_ids"],
                                                         b["labels"]))
