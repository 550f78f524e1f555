"""The port's LoRA (``hetu_tpu_torch.peft``, ``optim.masked``) against
``hetu_tpu.peft`` on ``GPTConfig.tiny`` and ``LlamaConfig.tiny``, the JAX
params carried over with ``params_from_jax``.

Tolerances: a fresh injection (B = 0) leaves the fp32 forward within
1e-5 of the plain one (``tests/test_lora_quant.py``'s); the 5-step
masked-AdamW fine-tune and the ``SFTTrainer.fit`` one match JAX's loss at
every step within 1e-5 and the adapters after it within 1e-5, and leave
every base param bit for bit as it was; ``merge_lora`` matches JAX's
merged tree and the adapter forward within 2e-4."""

import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import optim as jax_optim
from hetu_tpu.core.tree import flatten_with_paths
from hetu_tpu.engine.sft_trainer import SFTTrainer as JaxSFTTrainer
from hetu_tpu.engine.trainer import Trainer as JaxTrainer
from hetu_tpu.engine.trainer import TrainerConfig as JaxTrainerConfig
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.parallel.strategy import Strategy as JaxStrategy
from hetu_tpu.peft import LoraConfig as JaxLoraConfig
from hetu_tpu.peft import inject_lora as jax_inject_lora
from hetu_tpu.peft import lora_trainable_mask as jax_trainable_mask
from hetu_tpu.peft import merge_lora as jax_merge_lora
from hetu_tpu.peft import wrap_params_for_lora as jax_wrap

from hetu_tpu_torch import optim
from hetu_tpu_torch.engine import SFTTrainer, Trainer, TrainerConfig
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel, params_from_jax,
)
from hetu_tpu_torch.parallel import Strategy
from hetu_tpu_torch.peft import (
    LoraConfig, LoraLinear, inject_lora, lora_trainable_mask, merge_lora,
    wrap_params_for_lora,
)

torch.set_num_threads(2)

FAMILIES = {"gpt": (JaxGPTConfig, JaxGPT, GPTConfig, GPTLMHeadModel),
            "llama": (JaxLlamaConfig, JaxLlama, LlamaConfig,
                      LlamaLMHeadModel)}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _randomize_b(tree, key):
    """Every ``lora_B`` ~ N(0, 0.02), so the adapters change the output."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            key, sub = jax.random.split(key)
            out[k] = 0.02 * jax.random.normal(sub, v.shape, v.dtype) \
                if k == "lora_B" else _randomize_b(v, sub)
        return out
    return tree


def _pair(family, *, num_tasks=1, random_b=True, seed=0):
    """A JAX model + LoRA tree and the port's injected model holding it."""
    jcfg_cls, jcls, cfg_cls, cls = FAMILIES[family]
    jcfg = jcfg_cls.tiny()
    jmodel = jcls(jcfg)
    base = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    lcfg = dict(r=4, alpha=8.0, num_tasks=num_tasks)
    jwrapped = jax_inject_lora(jmodel, JaxLoraConfig(**lcfg))
    lp = jax_wrap(jmodel, base, jax.random.key(1), dtype=jnp.float32)
    if random_b:
        lp = _randomize_b(lp, jax.random.key(7))
    cfg = cfg_cls(**{f.name: getattr(jcfg, f.name)
                     for f in dataclasses.fields(cfg_cls)})
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np(base), cfg))
    wrapped = inject_lora(model, LoraConfig(**lcfg))
    model.load_state_dict(params_from_jax(_np(lp), cfg))
    return dict(jmodel=jmodel, base=base, lp=lp, jwrapped=jwrapped,
                model=model, wrapped=wrapped, cfg=cfg)


def _ids(vocab, b=2, s=16, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_fresh_injection_preserves_the_forward(family):
    """B = 0: the wrapped model's forward is the plain one's, in JAX and
    in the port (fp32, 1e-5), and the port's equals JAX's."""
    p = _pair(family, random_b=False)
    ids = _ids(p["cfg"].vocab_size)
    ref_model = FAMILIES[family][3](p["cfg"], device="cpu")
    ref_model.load_state_dict(params_from_jax(_np(p["base"]), p["cfg"]))
    with torch.no_grad():
        got = p["model"](torch.as_tensor(ids))
        ref = ref_model(torch.as_tensor(ids))
    want = np.asarray(p["jmodel"](p["lp"], jnp.asarray(ids)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_wrapped_paths_and_adapter_forward_match_jax(family):
    """The wrapped paths are JAX's with the layer index (JAX's one
    stacked ``blocks.block`` is the port's ``blocks.{i}``), and with
    random B the adapter forward is JAX's (fp32, 1e-5)."""
    p = _pair(family)
    L = p["cfg"].num_layers
    strip = sorted(re.sub(r"^blocks\.\d+\.", "blocks.block.", w)
                   for w in p["wrapped"])
    assert strip == sorted(p["jwrapped"] * L)
    assert all(isinstance(p["model"].get_submodule(w), LoraLinear)
               for w in p["wrapped"])
    ids = _ids(p["cfg"].vocab_size)
    with torch.no_grad():
        got = p["model"](torch.as_tensor(ids)).numpy()
    want = np.asarray(p["jmodel"](p["lp"], jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_num_tasks_gives_jax_shapes():
    p = _pair("llama", num_tasks=3)
    flat = {k: np.shape(v) for k, v in flatten_with_paths(p["lp"]).items()}
    for name, t in p["model"].state_dict().items():
        if not name.endswith(("lora_A", "lora_B")):
            continue
        jkey = re.sub(r"^blocks\.\d+\.", "blocks.", name)
        assert (p["cfg"].num_layers,) + tuple(t.shape) == flat[jkey], name
    assert p["model"].blocks[0].attn.q_proj.lora_A.shape[0] == 3


def test_wrap_params_and_mask():
    """``wrap_params_for_lora`` moves a pre-injection state dict under
    ``.base.`` (values exactly kept), A ~ N(0, 0.02) from its seed, B = 0;
    the mask marks exactly the factors."""
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu", seed=5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    inject_lora(model, LoraConfig(r=4))
    state = wrap_params_for_lora(model, before, seed=11)
    again = wrap_params_for_lora(model, before, seed=11)
    for name, t in state.items():
        if name.endswith("lora_B"):
            assert not t.any()
        elif name.endswith("lora_A"):
            assert torch.equal(t, again[name])
            assert 0.01 < float(t.std()) < 0.03
        else:
            assert torch.equal(t, before[name.replace(".base.", ".")])
    model.load_state_dict(state)
    mask = lora_trainable_mask(model)
    assert set(mask) == {n for n, _ in model.named_parameters()}
    assert {n for n, m in mask.items() if m} == {
        n for n in mask if n.endswith(("lora_A", "lora_B"))}
    # a seeded re-draw (``TrainerConfig(seed=...)``) starts B at zero
    for m in (model, _pair("llama")["model"]):
        m.reset_parameters(3)
        assert all(not p.any() for n, p in m.named_parameters()
                   if n.endswith("lora_B"))


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_merge_lora_matches_jax(family):
    """The merged state dict is JAX's merged tree carried over, and the
    plain model under it gives the adapter forward (2e-4)."""
    p = _pair(family)
    merged = merge_lora(p["model"])
    want = params_from_jax(_np(jax_merge_lora(p["jmodel"], p["lp"])),
                           p["cfg"])
    assert sorted(merged) == sorted(want)
    for k in want:
        np.testing.assert_allclose(merged[k].numpy(), want[k].numpy(),
                                   atol=2e-4, rtol=0, err_msg=k)
    plain = FAMILIES[family][3](p["cfg"], device="cpu")
    plain.load_state_dict(merged)
    ids = torch.as_tensor(_ids(p["cfg"].vocab_size))
    with torch.no_grad():
        np.testing.assert_allclose(plain(ids).numpy(),
                                   p["model"](ids).numpy(), atol=2e-4)


def test_decay_mask_matches_jax_on_a_lora_tree():
    """``jax_decay_mask`` decays what JAX's ``ndim >= 2`` rule decays on
    the stacked LoRA tree, the 4-D factors included."""
    p = _pair("llama")
    flat = flatten_with_paths(p["lp"])
    seen = 0
    for name, t in p["model"].named_parameters():
        jkey = re.sub(r"^blocks\.\d+\.", "blocks.", name)
        assert optim.jax_decay_mask(name, t) == (np.ndim(flat[jkey]) >= 2), \
            name
        seen += name.endswith(("lora_A", "lora_B"))
    assert seen and np.ndim(flat["blocks.attn.q_proj.lora_A"]) == 4


def _jax_trainer(cls, p, jopt, steps):
    tr = cls(p["jmodel"], jopt, JaxStrategy(),
             config=JaxTrainerConfig(total_steps=steps, log_every=1,
                                     precision="fp32", seed=0),
             devices=jax.devices()[:1])
    tr.initialize()
    tr.state = tr.state._replace(params=jax.device_put(
        p["lp"], tr.plan.state_shardings.params))
    return tr


def _check_lockstep(got, want, tr, p, base_before):
    got = [r["loss"] for r in got if "loss" in r]
    want_l = [r["loss"] for r in want if "loss" in r]
    assert len(got) == len(want_l) > 0
    np.testing.assert_allclose(got, want_l, atol=1e-5, rtol=0)
    jflat = flatten_with_paths(_np(p["jtr"].state.params))
    for name, t in p["model"].named_parameters():
        if name.endswith(("lora_A", "lora_B")):
            layer = re.match(r"^blocks\.(\d+)\.", name)
            jkey = re.sub(r"^blocks\.\d+\.", "blocks.", name)
            np.testing.assert_allclose(
                t.detach().numpy(), jflat[jkey][int(layer.group(1))],
                atol=1e-5, rtol=0, err_msg=name)
            assert not torch.equal(t, base_before[name]), name
        else:
            assert not t.requires_grad
            assert torch.equal(t, base_before[name]), name
    held = {id(q) for st in tr.state.optimizer.state.values()
            for q in st.values() if torch.is_tensor(q)}
    trained = {q for g in tr.state.optimizer.param_groups
               for q in g["params"]}
    assert {n for n, q in p["model"].named_parameters() if q in trained} \
        == {n for n in base_before if n.endswith(("lora_A", "lora_B"))}
    assert held


def _masks(p):
    return (jax_trainable_mask(p["lp"]), lora_trainable_mask(p["model"]))


def test_masked_adamw_five_steps_match_jax():
    """``optim.masked(adamw)`` through ``Trainer.train`` for 5 steps on
    ``GPTConfig.tiny``: JAX's losses and adapters; the base untouched and
    outside the optimizer."""
    p = _pair("gpt")
    jmask, mask = _masks(p)
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (2, 16)).astype(np.int32),
                "labels": rng.integers(0, 256, (2, 16)).astype(np.int32)}
               for _ in range(5)]
    p["jtr"] = _jax_trainer(JaxTrainer, p, jax_optim.masked(
        jax_optim.adamw(1e-3, weight_decay=0.01), jmask), 5)
    want = p["jtr"].train(iter(batches))
    before = {n: t.detach().clone()
              for n, t in p["model"].named_parameters()}
    tr = Trainer(p["model"], optim.masked(optim.adamw(
        1e-3, weight_decay=0.01), mask), Strategy(), device="cpu",
        config=TrainerConfig(total_steps=5, log_every=1, precision="fp32"))
    got = tr.train(iter(batches))
    _check_lockstep(got, want, tr, p, before)


def test_sft_trainer_lora_fit_matches_jax():
    """``examples/lora_sft.py``'s flow on ``LlamaConfig.tiny``:
    ``SFTTrainer.fit`` under ``masked(chain(clip_by_global_norm,
    adamw))``, 5 steps, against ``hetu_tpu``'s."""
    p = _pair("llama")
    jmask, mask = _masks(p)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, int(rng.integers(4, 12)))
               for _ in range(20)]
    responses = [rng.integers(1, 256, int(rng.integers(4, 16)))
                 for _ in range(20)]
    p["jtr"] = _jax_trainer(JaxSFTTrainer, p, jax_optim.masked(
        jax_optim.chain(jax_optim.clip_by_global_norm(1.0),
                        jax_optim.adamw(1e-3)), jmask), 5)
    want = p["jtr"].fit(prompts, responses, seq_len=24, batch_size=4)
    before = {n: t.detach().clone()
              for n, t in p["model"].named_parameters()}
    tr = SFTTrainer(p["model"], optim.masked(optim.chain(
        optim.clip_by_global_norm(1.0), optim.adamw(1e-3)), mask),
        Strategy(remat="selective"), device="cpu",
        config=TrainerConfig(total_steps=5, log_every=1, precision="fp32"))
    got = tr.fit(prompts, responses, seq_len=24, batch_size=4)
    _check_lockstep(got, want, tr, p, before)


def test_masked_refuses_a_mask_that_misses_params():
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="does not name"):
        optim.masked(optim.adamw(1e-3), {"wte.weight": True}).build(model)
