"""The port's single-device mixture-of-experts (``hetu_tpu_torch/nn/
moe.py``, GPT-MoE and Llama-MoE) against ``hetu_tpu``'s, on the CPU.

Inputs are drawn with numpy from a seed; model params come from one
``hetu_tpu`` tree carried over with ``params_from_jax`` (grads back with
``grads_from_jax``). Routing is discrete, so every comparison of a gate
first compares the routing: it counts the tokens whose decision margin
(the gap between the last chosen and the first unchosen score, and
between consecutive choices) is under 1e-4, prints that count, and holds
the routing equal on every other token; values are then compared on the
tokens routed alike.

Tolerances:
- gates' weights and aux, fp32: 1e-6 (the same fp32 softmax, summed in
  other orders);
- ``MoEMLP`` out, aux and grads in fp32: 1e-5 (atol and rtol); in bf16
  compute: out and every grad within 1e-2 of its largest entry, about
  2.5 bf16 ulps (the frameworks round bf16 at different points: 0.25% to
  0.65% measured);
- model loss and every grad in fp32: 1e-5 (atol and rtol), the
  ``test_torch_train.py`` bound; remat none/full/selective and a
  ``remat_mask`` bit-identical to each other;
- a train step's loss and grad norm 1e-5 and its updated params 1e-5
  (AdamW at lr 1e-3, as ``test_torch_train.py``'s lockstep: its first
  update divides each grad by its own magnitude, so a small grad's
  relative summation noise reaches the param scaled by lr);
  a 6-step ``Trainer.train`` history at 1e-4 per loss and rtol 1e-4 per
  grad norm (``test_torch_trainer.py``'s lockstep).
"""

import dataclasses
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import data as jax_data
from hetu_tpu import optim as jax_optim
from hetu_tpu.core.dtypes import BF16_COMPUTE as JAX_BF16
from hetu_tpu.core.dtypes import autocast as jax_autocast
from hetu_tpu.engine import build_train_step as jax_build_train_step
from hetu_tpu.engine import init_state as jax_init_state
from hetu_tpu.engine import make_plan as jax_make_plan
from hetu_tpu.engine.trainer import Trainer as JaxTrainer
from hetu_tpu.engine.trainer import TrainerConfig as JaxTrainerConfig
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.nn import moe as jmoe
from hetu_tpu.parallel.strategy import Strategy as JaxStrategy

from hetu_tpu_torch import data, optim
from hetu_tpu_torch.core import BF16_COMPUTE, autocast
from hetu_tpu_torch.engine import (
    Trainer, TrainerConfig, build_train_step, init_state, make_plan,
)
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel,
    grads_from_jax, params_from_jax,
)
from hetu_tpu_torch.models import convert
from hetu_tpu_torch.nn import moe
from hetu_tpu_torch.parallel import Strategy

torch.set_num_threads(2)

GATES = ("topk", "ktop1", "sam", "balance")
NEAR_TIE = 1e-4
REMATS = (("none", None), ("full", None), ("selective", None),
          ("none", (True, False)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _quiet(fn, *a, **kw):
    """``fn`` with the balance gate's k-downgrade warning silenced (both
    packages warn; ``test_make_gate_refusals_and_downgrade`` reads it)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*a, **kw)


# -- routing margins ----------------------------------------------------------

class MarginSpy:
    """Forward hooks on every gate of a port model: each call's token
    margins, to count the near-ties a model comparison rests on."""

    def __init__(self, model):
        self.margins = []
        self.handles = [
            mod.gate.register_forward_hook(self._hook)
            for mod in model.modules() if isinstance(mod, moe.MoEMLP)]

    def _hook(self, gate, args, out):
        self.margins.append(moe.routing_margins(gate, args[0]))

    def near_ties(self) -> int:
        for h in self.handles:
            h.remove()
        return int(sum(int((m < NEAR_TIE).sum()) for m in self.margins))


# -- the gates ----------------------------------------------------------------

def _gate_pair(gate_type, d=16, E=8, seed=0, scale=0.5):
    """The JAX gate and the port's on one numpy weight ~ N(0, scale²) (a
    sharper router than the 0.02 init, so the routing is decided)."""
    rng = np.random.default_rng(seed)
    kw = {"num_groups": 2} if gate_type == "sam" else {}
    jg = _quiet(jmoe.make_gate, gate_type, d, E, k=2, **kw)
    pg = _quiet(moe.make_gate, gate_type, d, E, k=2, **kw)
    name = "centroids" if gate_type == "balance" else "weight"
    shape = (E, d) if gate_type == "balance" else (d, E)
    w = rng.normal(0.0, scale, shape).astype(np.float32)
    getattr(pg, name).data.copy_(_t(w))
    return jg, {name: jnp.asarray(w)}, pg


@pytest.mark.parametrize("gate_type", GATES)
def test_gate_routing_weights_and_aux_match_jax(gate_type):
    """Each gate's ``(idx, w, aux)`` on 96 tokens: the routing first
    (equal off the near-ties, whose count is printed), then the weights
    on the tokens routed alike and the aux."""
    jg, jparams, pg = _gate_pair(gate_type)
    x = np.random.default_rng(1).normal(size=(96, 16)).astype(np.float32)
    jidx, jw, jaux = jg(jparams, jnp.asarray(x))
    with torch.no_grad():
        idx, w, aux = pg(_t(x))
    margins = moe.routing_margins(pg, _t(x))
    ties = margins < NEAR_TIE
    print(f"{gate_type}: {int(ties.sum())} of {len(x)} tokens within "
          f"{NEAR_TIE} of a routing tie (min margin "
          f"{float(margins.min()):.3g})")
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    assert idx.shape == w.shape == (96, pg.k)
    same = (idx.numpy() == np.asarray(jidx)).all(-1)
    assert (same | ties.numpy()).all(), np.flatnonzero(~same)
    np.testing.assert_allclose(w.numpy()[same], np.asarray(jw)[same],
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6,
                               rtol=1e-6)


def test_routing_margins_flag_ties():
    """``routing_margins`` is 0 where a decision is a tie (two equal
    expert columns that lead every row: their order; two equal SAM
    groups) and positive for a random router."""
    rng = np.random.default_rng(4)
    x = _t(np.abs(rng.normal(size=(10, 8))).astype(np.float32))
    w = rng.normal(0.0, 0.1, (8, 4)).astype(np.float32)
    gate = moe.make_gate("topk", 8, 4, k=2)
    gate.weight.data.copy_(_t(w))
    assert (moe.routing_margins(gate, x) > 0).all()
    w[:, 0] = w[:, 1] = 5.0
    gate.weight.data.copy_(_t(w))
    assert (moe.routing_margins(gate, x) == 0).all()
    sam = moe.make_gate("sam", 8, 4, k=1, num_groups=2)
    sam.weight.data.copy_(_t(np.tile(w[:, 1:3], (1, 2))))
    assert (moe.routing_margins(sam, x) == 0).all()


def test_make_gate_refusals_and_downgrade():
    """``make_gate`` as ``hetu_tpu``'s: the balance gate downgrades k to
    1 with the same warning (and ``MoEMLP.k`` follows), unknown names and
    impossible groupings raise."""
    with pytest.warns(UserWarning) as rec:
        gate = moe.make_gate("balance", 8, 4, k=2)
    with pytest.warns(UserWarning) as jrec:
        jmoe.make_gate("balance", 8, 4, k=2)
    assert [str(r.message) for r in rec] == [str(r.message) for r in jrec]
    assert gate.k == 1 and gate.batch_coupled
    assert _quiet(moe.MoEMLP, 8, 16, 4, gate_type="balance").k == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert moe.make_gate("balance", 8, 4, k=1).k == 1
    with pytest.raises(ValueError, match="unknown gate"):
        moe.make_gate("nope", 8, 4)
    with pytest.raises(ValueError, match="prototype groups"):
        moe.make_gate("ktop1", 8, 5, k=2)
    with pytest.raises(ValueError, match="num_groups"):
        moe.make_gate("sam", 8, 6, k=2, num_groups=4)
    with pytest.raises(ValueError, match="experts per group"):
        moe.make_gate("sam", 8, 4, k=3, num_groups=2)


@pytest.mark.parametrize("capacity_factor", (0.5, 1.25))
def test_hash_gate_and_drop_stats_match_jax(capacity_factor):
    """``HashGate`` and ``gate_drop_stats`` (the capacity statistics of a
    top-2 decision) equal ``hetu_tpu``'s exactly."""
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1000, (3, 11))
    jidx, jw, jaux = jmoe.HashGate(8)({}, jnp.asarray(ids))
    idx, w, aux = moe.HashGate(8)(_t(ids))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert float(aux) == float(jaux) == 0.0 and idx.dtype == torch.int32
    top = rng.integers(0, 8, (40, 2)).astype(np.int32)
    got = moe.gate_drop_stats(_t(top), 8, 2, capacity_factor)
    want = jmoe.gate_drop_stats(jnp.asarray(top), 8, 2, capacity_factor)
    assert got["capacity"] == want["capacity"]
    np.testing.assert_array_equal(got["expert_load"].numpy(),
                                  np.asarray(want["expert_load"]))
    for key in ("drop_frac", "load_imbalance"):
        assert float(got[key]) == pytest.approx(float(want[key]), abs=1e-7)


# -- MoEMLP -------------------------------------------------------------------

def _mlp_pair(gated, d=16, H=32, E=4, seed=0):
    jm = jmoe.MoEMLP(d, H, E, k=2, gated=gated)
    params = jm.init(jax.random.key(seed), dtype=jnp.float32)
    # a decided router: the gate's weight redrawn ~ N(0, 0.5²)
    w = np.random.default_rng(seed).normal(0, 0.5, (d, E)).astype(np.float32)
    params = {**params, "gate": {"weight": jnp.asarray(w)}}
    pm = moe.MoEMLP(d, H, E, k=2, gated=gated)
    pm.load_state_dict({k: _t(v) for k, v in
                        convert._flatten(_np_tree(params)).items()})
    return jm, params, pm


@pytest.mark.parametrize("gated", (False, True), ids=("gelu", "swiglu"))
@pytest.mark.parametrize("bf16", (False, True), ids=("fp32", "bf16"))
def test_moe_mlp_out_aux_and_grads_match_jax(gated, bf16):
    """``MoEMLP``'s capacity-free forward (out, aux) and the grads of
    ``Σ out·r + 0.3·aux`` for x and every param, fp32 and bf16 compute."""
    jm, params, pm = _mlp_pair(gated)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    r = rng.normal(size=(2, 12, 16)).astype(np.float32)

    def jloss(p, xx):
        out, aux = jm(p, xx)
        return jnp.sum(out.astype(jnp.float32) * r) + 0.3 * aux, (out, aux)

    ctx = jax_autocast(JAX_BF16) if bf16 else jax_autocast("fp32")
    with ctx:
        (_, (jout, jaux)), (jg, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    with autocast(BF16_COMPUTE if bf16 else "fp32"):
        out, aux = pm(xt)
        assert out.dtype == xt.dtype and aux.dtype == torch.float32
        (torch.sum(out.float() * _t(r)) + 0.3 * aux).backward()
    margins = moe.routing_margins(pm.gate, _t(x).view(-1, 16))
    ties = int((margins < NEAR_TIE).sum())
    print(f"gated={gated} bf16={bf16}: {ties} near-ties")
    assert ties == 0
    jout = np.asarray(jout, np.float32)
    want = {"x": np.asarray(jgx)} | {
        k: v for k, v in convert._flatten(_np_tree(jg)).items()}
    got = {"x": xt.grad.numpy()} | {
        n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=1e-6)
    if not bf16:
        np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-5,
                                   rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       rtol=1e-5, err_msg=k)
        return
    scale = np.abs(jout).max()
    assert np.abs(out.detach().float().numpy() - jout).max() \
        <= 1e-2 * scale
    for k in want:
        assert np.abs(got[k] - want[k]).max() \
            <= 1e-2 * np.abs(want[k]).max(), k


def test_convert_leaves_moe_params_untransposed():
    """The MoE leaves are not Linear weights: ``_LINEAR_WEIGHTS``' suffix
    match catches none of them, and ``params_from_jax`` only un-stacks
    the layer axis (gate (d, E), experts (E, d, H) / (E, H, d))."""
    for gate in ("topk", "balance"):
        jcfg = JaxLlamaConfig(**{**dataclasses.asdict(
            JaxLlamaConfig.tiny()), "num_experts": 4, "moe_gate": gate})
        params = _quiet(JaxLlama(jcfg).init, jax.random.key(0),
                        dtype=jnp.float32)
        flat = convert._flatten(_np_tree(params))
        moe_keys = [k for k in flat if ".mlp." in k]
        assert moe_keys and not [k for k in moe_keys
                                 if k.endswith(convert._LINEAR_WEIGHTS)]
        cfg = LlamaConfig(**dataclasses.asdict(jcfg))
        state = params_from_jax(params, cfg)
        for k in moe_keys:
            for i in range(cfg.num_layers):
                np.testing.assert_array_equal(
                    state[k.replace("blocks.", f"blocks.{i}.", 1)].numpy(),
                    flat[k][i])
        model = _quiet(LlamaLMHeadModel, cfg, device="cpu")
        model.load_state_dict(state, strict=True)


# -- GPT-MoE and Llama-MoE: loss and grads under every remat ------------------

def _configs(family, gate):
    extra = {"moe_gate": gate, "moe_num_groups": 2 if gate == "sam" else 0}
    if family == "gpt":
        return (JaxGPTConfig.tiny_moe(**extra), GPTConfig.tiny_moe(**extra),
                JaxGPT, GPTLMHeadModel)
    base = dataclasses.asdict(JaxLlamaConfig.tiny())
    jcfg = JaxLlamaConfig(**{**base, "num_experts": 4, **extra})
    return (jcfg, LlamaConfig(**dataclasses.asdict(jcfg)), JaxLlama,
            LlamaLMHeadModel)


def _batch(seed=0, vocab=256):
    """Three packed rows of 32 (documents of 5-21 tokens, pad tails of
    label -100, positions restarting at each document)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, vocab, n) for n in (21, 9, 14, 17, 5, 19)]
    return jax_data.pack_sequences(docs, 32).as_batch()


_REF = {}


def _reference(family, gate):
    """``hetu_tpu``'s loss and grads of one (family, gate), the port's
    model on the same params; cached across the remat cases."""
    if (family, gate) not in _REF:
        jcfg, cfg, jcls, cls = _configs(family, gate)
        jmodel = _quiet(jcls, jcfg)
        params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
        batch = _batch()
        kw = dict(positions=jnp.asarray(batch["positions"]),
                  segment_ids=jnp.asarray(batch["segment_ids"]))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jnp.asarray(batch["input_ids"]),
                                  jnp.asarray(batch["labels"]), **kw)))(
            params)
        model = _quiet(cls, cfg, device="cpu")
        model.load_state_dict(params_from_jax(_np_tree(params), cfg))
        _REF[family, gate] = dict(
            model=model, batch=batch, loss=float(loss),
            grads=grads_from_jax(_np_tree(grads), cfg), runs={})
    return _REF[family, gate]


def _port_loss_and_grads(model, batch, **kw):
    model.zero_grad(set_to_none=True)
    spy = MarginSpy(model)
    loss = model.loss(_t(batch["input_ids"]), _t(batch["labels"]),
                      positions=_t(batch["positions"]),
                      segment_ids=_t(batch["segment_ids"]), **kw)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                         for n, p in model.named_parameters()}, spy


@pytest.mark.parametrize("remat,remat_mask", REMATS,
                         ids=("none", "full", "selective", "mask"))
@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("family", ("gpt", "llama"))
def test_moe_model_loss_and_grads_match_jax(family, gate, remat,
                                            remat_mask):
    """GPT-MoE / Llama-MoE ``loss`` (LM plus ``moe_aux_coef`` times the
    aux summed over layers) and every grad against
    ``jax.value_and_grad`` of ``hetu_tpu``'s, on a packed batch with pad
    tails, under remat none, full, selective and a ``remat_mask``; the
    remat modes agree bit for bit."""
    ref = _reference(family, gate)
    model = ref["model"]
    loss, grads, spy = _port_loss_and_grads(
        model, ref["batch"], remat=remat, remat_mask=remat_mask)
    ties = spy.near_ties()
    print(f"{family}/{gate}/{remat}/{remat_mask}: {ties} near-ties over "
          f"{len(spy.margins)} gate calls")
    assert ties == 0
    assert len(spy.margins) >= model.cfg.num_layers
    assert loss == pytest.approx(ref["loss"], abs=1e-5, rel=1e-5)
    assert sorted(grads) == sorted(ref["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref["grads"][name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    ref["runs"][remat, remat_mask] = (loss, grads)
    first_loss, first = next(iter(ref["runs"].values()))
    assert loss == first_loss
    assert all(torch.equal(g, first[n]) for n, g in grads.items())


@pytest.mark.parametrize("family", ("gpt", "llama"))
def test_moe_aux_is_summed_over_layers_and_added_once(family):
    """The backbone's aux is the sum of the layers' gate auxes (not
    their mean), and the loss adds ``moe_aux_coef`` times it once; a
    dense model's backbone returns an fp32 zero and its loss is the LM
    loss itself."""
    _, cfg, _, cls = _configs(family, "topk")
    model = cls(cfg, device="cpu", seed=3)
    auxes = []
    for mod in model.modules():
        if isinstance(mod, moe.MoEMLP):
            mod.gate.register_forward_hook(
                lambda g, a, out: auxes.append(out[2].detach()))
    batch = _batch(1)
    x, y = _t(batch["input_ids"]), _t(batch["labels"])
    with torch.no_grad():
        h, aux = model.backbone(x)
        assert len(auxes) == cfg.num_layers == 2
        assert float(aux) == float(auxes[0] + auxes[1])
        lm = model.head_loss(h, y)
        assert torch.equal(model.loss(x, y), lm + cfg.moe_aux_coef * aux)
        dense_cfg = dataclasses.replace(cfg, num_experts=0)
        dense = cls(dense_cfg, device="cpu", seed=3)
        h, aux = dense.backbone(x)
        assert aux.dtype == torch.float32 and float(aux) == 0.0
        assert torch.equal(dense.loss(x, y), dense.head_loss(h, y))


# -- the train step and the Trainer -------------------------------------------

def test_build_train_step_matches_jax():
    """One ``build_train_step`` step of GPT-MoE (AdamW, fp32, packed
    batch): loss, grad norm and every updated param against
    ``hetu_tpu``'s step."""
    jcfg, cfg, jcls, cls = _configs("gpt", "topk")
    jmodel = jcls(jcfg)
    jopt = jax_optim.adamw(1e-3, weight_decay=0.01)
    jplan = jax_make_plan(jmodel, jopt, JaxStrategy(),
                          devices=jax.devices()[:1])
    jstate = jax_init_state(jmodel, jopt, jplan, jax.random.key(0))
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jstate.params), cfg))
    batch = _batch(2)
    jstate, jm = jax_build_train_step(jmodel, jopt, jplan)(
        jstate, jplan.shard_batch({k: jnp.asarray(v)
                                   for k, v in batch.items()}))
    opt = optim.adamw(1e-3, weight_decay=0.01)
    plan = make_plan(model, opt, Strategy(), device="cpu")
    state = init_state(model, opt, plan)
    state, m = build_train_step(model, opt, plan)(
        state, {k: _t(v) for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    want = params_from_jax(_np_tree(jstate.params), cfg)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_trainer_train_history_matches_jax():
    """Six steps of ``Trainer.train`` on GPT-MoE over the packed loader
    (fp32, AdamW) in lockstep with ``hetu_tpu``'s ``Trainer``."""
    jcfg, cfg, _, _ = _configs("gpt", "topk")

    def loader(mod):
        ds = mod.SyntheticLMDataset(256, num_docs=64, min_len=8,
                                    max_len=40, seed=0)
        return mod.build_data_loader(ds, seq_len=32, batch_rows=2,
                                     pack=True)

    jtr = JaxTrainer(JaxGPT(jcfg), jax_optim.adamw(3e-3), JaxStrategy(),
                     config=JaxTrainerConfig(total_steps=6, log_every=1,
                                             precision="fp32", seed=0),
                     devices=jax.devices()[:1])
    jtr.initialize()
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jtr.state.params), cfg))
    want = [r for r in jtr.train(loader(jax_data)) if "loss" in r]
    tr = Trainer(model, optim.adamw(3e-3), Strategy(), device="cpu",
                 config=TrainerConfig(total_steps=6, log_every=1,
                                      precision="fp32"))
    got = [r for r in tr.train(loader(data)) if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want] \
        == list(range(1, 7))
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], atol=1e-4)
    np.testing.assert_allclose([r["grad_norm"] for r in got],
                               [r["grad_norm"] for r in want], rtol=1e-4)
