"""The port's training step against ``hetu_tpu``'s on ``GPTConfig.tiny``.

One ``hetu_tpu`` parameter tree is carried into the port with
``params_from_jax``; its grads come back with ``grads_from_jax``; token
ids are made with numpy from a seed and handed to both. Tolerances:
- fp32 loss and every grad: 1e-5 (atol and rtol; sums in other orders);
- the same under bf16 compute: loss within 2e-3 and every grad within
  5% of the largest grad (the two frameworks round bf16 at different
  points: bias adds, GELU's intermediates, the kernels' fp32 p);
- a 10-step AdamW loss curve: 1e-4 per step;
- ``HETU_LM_LOSS_IMPL=fused`` (a ragged vocab of 8269, the fused CE
  against the Pallas kernels in interpret mode): fp32 loss and every
  grad as above; a 10-step lockstep with bf16 params and bf16 compute:
  each loss within 2e-3 (the bf16-compute bound above) and each grad
  norm within 1% (bf16 params round every update, so last-bit
  differences carry from step to step);
- one AdamW update of a bf16 param: within 1 bf16 ulp of JAX's.
Remat none/full/selective (and a per-layer ``remat_mask``) must give
bit-identical losses and grads.
"""

import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import optim as jax_optim
from hetu_tpu.core.dtypes import BF16_COMPUTE as JAX_BF16
from hetu_tpu.core.dtypes import Policy as JaxPolicy
from hetu_tpu.core.dtypes import autocast as jax_autocast
from hetu_tpu.engine import build_train_step as jax_build_train_step
from hetu_tpu.engine import init_state as jax_init_state
from hetu_tpu.engine import make_plan as jax_make_plan
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.ops import losses as jax_losses
from hetu_tpu.ops.losses import chunked_lm_loss as jax_chunked_lm_loss
from hetu_tpu.optim.base import apply_updates as jax_apply_updates
from hetu_tpu.parallel.strategy import Strategy as JaxStrategy
from hetu_tpu.utils.checkpoint import _flatten

from hetu_tpu_torch import optim
from hetu_tpu_torch.core import BF16_COMPUTE, Policy, autocast
from hetu_tpu_torch.engine import (
    build_train_step, init_state, make_plan, step_dropout_seed,
)
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, grads_from_jax, params_from_jax,
)
from hetu_tpu_torch.ops import chunked_lm_loss, vocab_parallel_lm_loss
from hetu_tpu_torch.ops import flash as flash_mod
from hetu_tpu_torch.ops import fused_ce as fused_mod
from hetu_tpu_torch.ops import losses as losses_mod
from hetu_tpu_torch.parallel import Strategy

torch.set_num_threads(2)

REMATS = ("none", "full", "selective")
#: a vocab large enough for the LM loss's chunked/fused branch, and
#: ragged against every tile
FUSED_VOCAB = 8269
BF16_PARAMS = Policy(param_dtype=torch.bfloat16,
                     compute_dtype=torch.bfloat16)
JAX_BF16_PARAMS = JaxPolicy(param_dtype=jnp.bfloat16,
                            compute_dtype=jnp.bfloat16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(seed=0, b=2, s=32, vocab=256):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    x, y = ids[:, :-1], ids[:, 1:].copy()
    y[0, :3] = -100                     # ignored labels
    return x, y


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxGPT(JaxGPTConfig.tiny())
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = GPTConfig.tiny()
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(params), cfg))
    x, y = _batch()
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        params, jnp.asarray(x), jnp.asarray(y))
    return dict(jmodel=jmodel, params=params, model=model, x=x, y=y,
                loss=float(loss), grads=grads_from_jax(_np_tree(grads), cfg))


def _port_loss_and_grads(model, x, y, **kw):
    model.zero_grad(set_to_none=True)
    loss = model.loss(_t(x), _t(y), **kw)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def no_remat(tiny):
    return _port_loss_and_grads(tiny["model"], tiny["x"], tiny["y"])


@pytest.mark.parametrize("remat,remat_mask", [
    *((r, None) for r in REMATS), ("selective", (False, True))])
def test_gpt_tiny_loss_and_every_grad_match_jax(tiny, no_remat, remat,
                                                remat_mask):
    loss, grads = _port_loss_and_grads(tiny["model"], tiny["x"], tiny["y"],
                                       remat=remat, remat_mask=remat_mask)
    np.testing.assert_allclose(float(loss), tiny["loss"], rtol=1e-5,
                               atol=1e-5)
    assert set(grads) == set(tiny["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), tiny["grads"][name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # remat changes what is kept, never the numbers
    assert torch.equal(loss, no_remat[0])
    for name, g in grads.items():
        assert torch.equal(g, no_remat[1][name]), name


def test_gpt_tiny_bf16_compute_tracks_jax(tiny):
    cfg = tiny["model"].cfg
    x, y = jnp.asarray(tiny["x"]), jnp.asarray(tiny["y"])
    with jax_autocast(JAX_BF16):
        jloss, jgrads = jax.jit(jax.value_and_grad(tiny["jmodel"].loss))(
            tiny["params"], x, y)
    want = grads_from_jax(_np_tree(jgrads), cfg)
    with autocast(BF16_COMPUTE):
        loss, grads = _port_loss_and_grads(tiny["model"], tiny["x"],
                                           tiny["y"], remat="selective")
    assert abs(float(loss) - float(jloss)) < 2e-3
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        assert g.dtype == torch.float32, name       # fp32 params, fp32 grads
        err = float((g - want[name]).abs().max())
        assert err <= 0.05 * gmax, (name, err, gmax)


@pytest.mark.parametrize("remat,fwd_per_layer", [
    ("none", 1), ("selective", 1), ("full", 2)])
def test_selective_remat_keeps_the_flash_forward(tiny, monkeypatch, remat,
                                                 fwd_per_layer):
    """Selective remat saves the flash forward's out/lse by naming its
    op: the backward runs the forward once per layer, as without remat;
    full remat runs it twice. The backward runs once per layer always."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash_mod.flash_attention_fwd, flash_mod.flash_attention_bwd

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(flash_mod, "flash_attention_fwd", count("fwd", fwd))
    monkeypatch.setattr(flash_mod, "flash_attention_bwd", count("bwd", bwd))
    model = tiny["model"]
    _port_loss_and_grads(model, tiny["x"], tiny["y"], remat=remat)
    layers = model.cfg.num_layers
    assert calls == {"fwd": fwd_per_layer * layers, "bwd": layers}


def test_chunked_lm_loss_value_and_grads_match_jax():
    """S = 10 is not a multiple of the 3-step chunk (6 tokens over a
    batch of 2), so the tail is padded with ignored labels; some labels
    are ignored too."""
    rng = np.random.default_rng(4)
    B, S, E, V = 2, 10, 16, 40
    h = rng.normal(size=(B, S, E)).astype(np.float32)
    w = rng.normal(size=(V, E)).astype(np.float32) * 0.3
    y = rng.integers(0, V, (B, S))
    y[1, 4:7] = -100
    jloss, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: jax_chunked_lm_loss(h, w, jnp.asarray(y),
                                         chunk_tokens=6),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    loss = chunked_lm_loss(th, tw, _t(y), chunk_tokens=6)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-5)


def test_fused_lm_loss_env_routes_through_fused_lm_ce(monkeypatch):
    """``HETU_LM_LOSS_IMPL=fused`` sends a vocab of 8192 or more through
    the fused CE (on the CPU, the plain versions of kernels #5-#7, each
    called once by a forward and backward) and never through the chunked
    loss; without it the chunked loss runs. Both give log V here."""
    calls = {"fwd": 0, "dh": 0, "dw": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    for key in calls:
        name = ("fused_lse_tgt_reference" if key == "fwd"
                else f"fused_ce_{key}_reference")
        monkeypatch.setattr(fused_mod, name,
                            count(key, getattr(fused_mod, name)))
    h = torch.zeros(1, 4, 8, requires_grad=True)
    w = torch.zeros(8192, 8, requires_grad=True)
    y = torch.zeros(1, 4, dtype=torch.long)
    base = vocab_parallel_lm_loss(h, w, y)
    np.testing.assert_allclose(float(base.detach()), np.log(8192),
                               rtol=1e-6)
    assert calls == {"fwd": 0, "dh": 0, "dw": 0}

    def no_chunks(*a, **kw):
        raise AssertionError("the fused path ran the chunked loss")

    monkeypatch.setattr(losses_mod, "chunked_lm_loss", no_chunks)
    monkeypatch.setenv("HETU_LM_LOSS_IMPL", "fused")
    loss = vocab_parallel_lm_loss(h, w, y)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), np.log(8192),
                               rtol=1e-6)
    assert calls == {"fwd": 1, "dh": 1, "dw": 1}
    assert w.grad.shape == w.shape and h.grad.shape == h.shape


def _fused_cfgs():
    return (dataclasses.replace(JaxGPTConfig.tiny(), vocab_size=FUSED_VOCAB),
            dataclasses.replace(GPTConfig.tiny(), vocab_size=FUSED_VOCAB))


@pytest.fixture
def fused_env(monkeypatch):
    """The fused LM loss on both sides: the env variable for the port;
    for ``hetu_tpu`` also its backend gate, which is False on the CPU
    (a test-only patch)."""
    monkeypatch.setenv("HETU_LM_LOSS_IMPL", "fused")
    monkeypatch.setattr(jax_losses, "_use_fused_ce", lambda: True)


def test_gpt_fused_lm_loss_and_every_grad_match_jax(fused_env):
    jcfg, cfg = _fused_cfgs()
    jmodel = JaxGPT(jcfg)
    params = jmodel.init(jax.random.key(1), dtype=jnp.float32)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(params), cfg))
    x, y = _batch(seed=11, vocab=FUSED_VOCAB)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        params, jnp.asarray(x), jnp.asarray(y))
    want = grads_from_jax(_np_tree(jgrads), cfg)
    loss, grads = _port_loss_and_grads(model, x, y, remat="selective")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_bf16_params_fused_ce_lockstep_matches_jax(fused_env):
    """``bench.py``'s fused-CE combo at test size: bf16 params and
    compute, selective remat, AdamW(1e-3, wd 0.01), the fused LM loss;
    10 steps of the port's ``build_train_step`` against ``hetu_tpu``'s on
    one repeated batch. The port's params stay bf16 and its AdamW state
    fp32."""
    jcfg, cfg = _fused_cfgs()
    jmodel = JaxGPT(jcfg)
    jopt = jax_optim.adamw(1e-3, weight_decay=0.01)
    x, y = _batch(seed=12, vocab=FUSED_VOCAB)
    with jax_autocast(JAX_BF16_PARAMS):
        jplan = jax_make_plan(jmodel, jopt, JaxStrategy(remat="selective"),
                              devices=jax.devices()[:1])
        jstate = jax_init_state(jmodel, jopt, jplan, jax.random.key(2))
        jstep = jax_build_train_step(jmodel, jopt, jplan)
        jbatch = jplan.shard_batch({"input_ids": jnp.asarray(x),
                                    "labels": jnp.asarray(y)})
        assert jstate.params["wte"]["weight"].dtype == jnp.bfloat16
        model = GPTLMHeadModel(cfg, device="cpu")
        model.load_state_dict(params_from_jax(jstate.params, cfg))
        opt = optim.adamw(1e-3, weight_decay=0.01)
        with autocast(BF16_PARAMS):
            plan = make_plan(model, opt, Strategy(remat="selective"),
                             device="cpu")
        state = init_state(model, opt, plan)
        assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
        step = build_train_step(model, opt, plan)
        batch = {"input_ids": _t(x), "labels": _t(y)}
        jl, tl = [], []
        for _ in range(10):
            jstate, jm = jstep(jstate, jbatch)
            state, m = step(state, batch)
            jl.append(float(jm["loss"]))
            tl.append(float(m["loss"]))
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-2)
    np.testing.assert_allclose(tl, jl, atol=2e-3)
    assert tl[-1] < tl[0] - 0.5
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    moments = [v for st in state.optimizer.state.values()
               for k, v in st.items() if k in ("mu", "nu")]
    assert moments and {v.dtype for v in moments} == {torch.float32}


def test_adamw_update_of_a_bf16_param_matches_jax():
    """Two AdamW updates of a bf16 matrix (decayed) and a bf16 vector:
    the port's params equal ``adamw`` + ``apply_updates``'s to within 1
    bf16 ulp, its moments are fp32 and equal JAX's to 1e-6."""
    rng = np.random.default_rng(13)
    p0 = {"m": rng.normal(size=(6, 5)).astype(np.float32),
          "v": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=a.shape) * 1e-2).astype(np.float32)
              for k, a in p0.items()} for _ in range(2)]
    jopt = jax_optim.adamw(3e-2, weight_decay=0.1)
    jp = {k: jnp.asarray(a, jnp.bfloat16) for k, a in p0.items()}
    jst = jopt.init(jp)
    tp = {k: torch.from_numpy(np.array(jp[k].astype(jnp.float32))).to(
        torch.bfloat16) for k in p0}
    mod = torch.nn.Module()
    mod.m = torch.nn.Parameter(tp["m"])
    mod.v = torch.nn.Parameter(tp["v"])
    spec = optim.adamw(3e-2, weight_decay=0.1)
    opt = spec.build(mod)
    for count, g in enumerate(grads):
        jg = {k: jnp.asarray(a, jnp.bfloat16) for k, a in g.items()}
        upd, jst = jopt.update(jg, jst, jp)
        jp = jax_apply_updates(jp, upd)
        spec.step(opt, count, {mod.m: torch.from_numpy(np.array(
            jg["m"].astype(jnp.float32))).to(torch.bfloat16),
            mod.v: torch.from_numpy(np.array(
                jg["v"].astype(jnp.float32))).to(torch.bfloat16)})
    for k in p0:
        got = getattr(mod, k).detach()
        assert got.dtype == torch.bfloat16
        want = np.array(jp[k].astype(jnp.float32))
        ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
        assert np.all(np.abs(got.float().numpy() - want) <= ulp), k
        mu = opt.state[getattr(mod, k)]["mu"]
        assert mu.dtype == torch.float32
    jmu = jst[0].mu
    np.testing.assert_allclose(opt.state[mod.m]["mu"].numpy(),
                               np.asarray(jmu["m"]), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(opt.state[mod.v]["nu"].numpy(),
                               np.asarray(jst[0].nu["v"]), rtol=1e-6,
                               atol=1e-12)


def test_params_from_jax_round_trips_bf16_leaves():
    """A bf16 ``hetu_tpu`` tree converts leaf by leaf to bf16 tensors of
    the same values (through fp32, which holds every bf16 exactly), and
    a model loads them."""
    jmodel = JaxGPT(JaxGPTConfig.tiny())
    with jax_autocast(JAX_BF16_PARAMS):
        params = jmodel.init(jax.random.key(3))
    cfg = GPTConfig.tiny()
    state = params_from_jax(params, cfg)
    flat = _flatten(params)
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    np.testing.assert_array_equal(
        state["wte.weight"].float().numpy(),
        np.asarray(flat["wte.weight"].astype(jnp.float32)))
    np.testing.assert_array_equal(
        state["blocks.1.attn.q_proj.weight"].float().numpy(),
        np.asarray(flat["blocks.attn.q_proj.weight"][1].astype(
            jnp.float32)).T)
    model = GPTLMHeadModel(cfg, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(state)
    assert torch.equal(model.wte.weight.detach(), state["wte.weight"])


def test_adamw_decay_mask_matches_jax_stacked_rule(tiny):
    """JAX decays params with ndim >= 2 and sees block params stacked on
    the layer axis: every ``blocks.*`` param (biases and LayerNorm
    scales too) is decayed, ``ln_f`` is not, the embeddings are."""
    jax_decays = {k: np.ndim(v) >= 2
                  for k, v in _flatten(tiny["params"]).items()}
    model = tiny["model"]
    opt = optim.adamw(1e-3, weight_decay=0.01).build(model)
    decayed = {id(p) for g in opt.param_groups if g["weight_decay"] > 0
               for p in g["params"]}
    names = dict(model.named_parameters())
    for name, p in names.items():
        jax_key = re.sub(r"^blocks\.\d+\.", "blocks.", name)
        assert (id(p) in decayed) == jax_decays[jax_key], name
    assert id(names["blocks.0.ln_1.scale"]) in decayed
    assert id(names["blocks.1.attn.q_proj.bias"]) in decayed
    assert id(names["ln_f.scale"]) not in decayed
    assert id(names["wte.weight"]) in decayed


def test_train_step_lockstep_loss_curve_matches_jax():
    """10 AdamW steps of the port's ``build_train_step`` against
    ``hetu_tpu``'s on one repeated batch (``tests/test_models.py:197``)."""
    jmodel = JaxGPT(JaxGPTConfig.tiny())
    jopt = jax_optim.adamw(1e-3, weight_decay=0.01)
    jplan = jax_make_plan(jmodel, jopt, JaxStrategy(remat="selective"),
                          devices=jax.devices()[:1])
    jstate = jax_init_state(jmodel, jopt, jplan, jax.random.key(0))
    cfg = GPTConfig.tiny()
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jstate.params), cfg))
    jstep = jax_build_train_step(jmodel, jopt, jplan)
    opt = optim.adamw(1e-3, weight_decay=0.01)
    plan = make_plan(model, opt, Strategy(remat="selective"), device="cpu")
    state = init_state(model, opt, plan)
    step = build_train_step(model, opt, plan)
    x, y = _batch(seed=5)
    jbatch = jplan.shard_batch({"input_ids": jnp.asarray(x),
                                "labels": jnp.asarray(y)})
    batch = {"input_ids": _t(x), "labels": _t(y)}
    jl, tl = [], []
    for _ in range(10):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert state.step == 10 and tl[-1] < tl[0]


def test_microbatched_step_equals_the_whole_batch():
    """num_microbatches=2 accumulates fp32 grads and divides by 2: with
    equal halves of a batch the update equals the whole batch's."""
    cfg = GPTConfig.tiny()
    x, y = _batch(seed=6, b=4)
    x[2:], y[2:] = x[:2], y[:2]        # equal token counts in each half
    losses = []
    for nm in (1, 2):
        model = GPTLMHeadModel(cfg, device="cpu", seed=1)
        opt = optim.sgd(0.1)
        plan = make_plan(model, opt, Strategy(num_microbatches=nm),
                         device="cpu")
        step = build_train_step(model, opt, plan)
        state = init_state(model, opt, plan)
        batch = {"input_ids": _t(x), "labels": _t(y)}
        losses.append([float(step(state, batch)[1]["loss"])
                       for _ in range(2)])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_plan_keeps_the_precision_policy(tiny):
    """The plan records the policy in force at ``make_plan``, and every
    step (forward and backward) runs under it, wherever it is called."""
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    model.load_state_dict(tiny["model"].state_dict())
    x, y = _batch(seed=9)
    with autocast(BF16_COMPUTE):
        plan = make_plan(model, optim.sgd(0.0), Strategy(), device="cpu")
        want = float(model.loss(_t(x), _t(y)).detach())
    fp32 = float(model.loss(_t(x), _t(y)).detach())
    step = build_train_step(model, optim.sgd(0.0), plan)
    _, metrics = step(init_state(model, optim.sgd(0.0), plan),
                      {"input_ids": _t(x), "labels": _t(y)})
    assert float(metrics["loss"]) == want != fp32


def test_dropout_seeds_reproduce_masks_and_eval_is_deterministic():
    cfg = GPTConfig(vocab_size=256, max_positions=128, hidden_size=64,
                    num_layers=2, num_heads=4, embd_pdrop=0.1,
                    resid_pdrop=0.1, attn_pdrop=0.1)
    model = GPTLMHeadModel(cfg, device="cpu")
    plain = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    plain.load_state_dict(model.state_dict())
    x, y = (_t(a) for a in _batch(seed=7, s=16))
    with torch.no_grad():
        seeded = [float(model.loss(x, y, dropout_seed=s))
                  for s in (step_dropout_seed(3), step_dropout_seed(3),
                            step_dropout_seed(4))]
        assert seeded[0] == seeded[1] != seeded[2]
        # no seed: no dropout, whatever the rates
        assert float(model.loss(x, y)) == float(plain.loss(x, y))


def test_schedules_and_clipping_match_jax():
    pairs = [(optim.constant(0.3), jax_optim.constant(0.3)),
             (optim.linear_warmup(1e-3, 5),
              jax_optim.linear_warmup(1e-3, 5)),
             (optim.cosine_decay(1e-3, 10, warmup_steps=3, min_lr=1e-5),
              jax_optim.cosine_decay(1e-3, 10, warmup_steps=3,
                                     min_lr=1e-5))]
    for port, ref in pairs:
        for s in range(14):
            np.testing.assert_allclose(port(s), float(ref(jnp.int32(s))),
                                       rtol=1e-6)
    rng = np.random.default_rng(8)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    want, _ = jax_optim.clip_by_global_norm(1.0).update(
        jax.tree.map(jnp.asarray, tree), ())
    got = [_t(tree["a"]), _t(tree["b"])]
    norm = optim.global_norm(got)
    got = optim.clip_by_global_norm(1.0)(got)
    np.testing.assert_allclose(
        float(norm), float(jax_optim.global_norm(tree)), rtol=1e-6)
    for g, k in zip(got, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


def test_strategy_and_plan_refuse_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="slice 4"):
        Strategy(dp=2)
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    opt = optim.adamw(1e-3)
    with pytest.raises(NotImplementedError, match="offload"):
        make_plan(model, opt, Strategy(offload=True), device="cpu")
    if not torch.cuda.is_available():
        # the device rule: no silent CPU run
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_plan(model, opt, Strategy())
    with pytest.raises(ValueError, match="remat_mask"):
        model.loss(torch.zeros(1, 4, dtype=torch.long),
                   torch.zeros(1, 4, dtype=torch.long), remat="full",
                   remat_mask=(True,))
