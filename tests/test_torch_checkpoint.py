"""The port's checkpoints (``hetu_tpu_torch/utils/checkpoint.py``,
``Trainer.save`` / ``resume``) against ``hetu_tpu``'s
(``hetu_tpu/utils/checkpoint.py``) on ``GPTConfig.tiny`` and
``LlamaConfig.tiny``.

- The port's safetensors writer gives the bytes ``safetensors.numpy``
  writes (bf16, int32 scalars, empty shapes, int8), and its reader reads
  what ``safetensors.numpy`` writes.
- A port run saved every 2 steps and resumed into a new model and
  Trainer is bit-equal to the run without a stop: losses, params,
  moments and counts.
- An async save holds the state of its call, though a step runs while
  its write does; split archives and ``quantize="int8"`` are ``hetu_tpu``'s
  to the byte (codes and scales).
- Cross-loads, for ``adamw``, ``chain(clip_by_global_norm, adamw)`` and
  LoRA's ``masked(chain(...))``: a checkpoint ``hetu_tpu`` wrote loads into
  the port bit for bit, and the port's next 2 steps match ``hetu_tpu``'s own
  continuation (loss at 1e-5, the fp32 lockstep bound of
  ``tests/test_torch_lora.py``); a checkpoint the port wrote loads through
  ``hetu_tpu``'s ``load_checkpoint`` bit for bit (params, moments, counts,
  step).
"""

import dataclasses
import json
import os
import threading

import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy as st_numpy

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import optim as jax_optim
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
from hetu_tpu.peft import wrap_params_for_lora as jax_wrap
from hetu_tpu.utils import checkpoint as jax_ckpt

from hetu_tpu_torch import optim
from hetu_tpu_torch.engine import Trainer, TrainerConfig
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel, grads_from_jax,
    params_from_jax,
)
from hetu_tpu_torch.parallel import Strategy
from hetu_tpu_torch.peft import LoraConfig, inject_lora, lora_trainable_mask
from hetu_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

FAMILIES = {"gpt": (JaxGPTConfig, JaxGPT, GPTConfig, GPTLMHeadModel),
            "llama": (JaxLlamaConfig, JaxLlama, LlamaConfig,
                      LlamaLMHeadModel)}
LORA = dict(r=4, alpha=8.0, num_tasks=1)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batches(n, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, vocab, (2, 16)).astype(np.int32)}
            for _ in range(n)]


def _opts(kind, jmask=None, mask=None):
    """(hetu_tpu's optimizer, the port's) of one kind."""
    if kind == "adamw":
        return (jax_optim.adamw(1e-3, weight_decay=0.01),
                optim.adamw(1e-3, weight_decay=0.01))
    clip = (jax_optim.chain(jax_optim.clip_by_global_norm(1.0),
                            jax_optim.adamw(1e-3, weight_decay=0.01)),
            optim.chain(optim.clip_by_global_norm(1.0),
                        optim.adamw(1e-3, weight_decay=0.01)))
    if kind == "chain":
        return clip
    return jax_optim.masked(clip[0], jmask), optim.masked(clip[1], mask)


def _models(family, kind):
    """hetu_tpu's model and its params, and a port model holding them (a
    LoRA-wrapped pair, random B, for ``kind == "lora"``)."""
    jcfg_cls, jcls, cfg_cls, cls = FAMILIES[family]
    jcfg = jcfg_cls.tiny()
    jmodel = jcls(jcfg)
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = cfg_cls(**{f.name: getattr(jcfg, f.name)
                     for f in dataclasses.fields(cfg_cls)})
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np(params), cfg))
    if kind == "lora":
        jax_inject_lora(jmodel, JaxLoraConfig(**LORA))
        params = jax_wrap(jmodel, params, jax.random.key(1),
                          dtype=jnp.float32)
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: 0.02 * jax.random.normal(
                jax.random.key(7), a.shape, a.dtype)
            if str(path[-1]) == "['lora_B']" else a, params)
        inject_lora(model, LoraConfig(**LORA))
        model.load_state_dict(params_from_jax(_np(params), cfg))
    return jmodel, params, model, cfg


def _port_trainer(model, opt, **kw):
    return Trainer(model, opt, Strategy(), device="cpu",
                   config=TrainerConfig(log_every=1, precision="fp32",
                                        prefetch=0, **kw))


def _jax_trainer(jmodel, jopt, params):
    tr = JaxTrainer(jmodel, jopt, JaxStrategy(),
                    config=JaxTrainerConfig(log_every=1, precision="fp32",
                                            seed=0),
                    devices=jax.devices()[:1])
    tr.initialize()
    tr.state = tr.state._replace(params=jax.device_put(
        params, tr.plan.state_shardings.params))
    return tr


def _losses(records):
    return [r["loss"] for r in records if "loss" in r]


def _port_state(tr):
    """``{name: tensor}`` of params, and ``{name: {field: tensor or
    count}}`` of the optimizer state, copied."""
    names = {p: n for n, p in tr.model.named_parameters()}
    params = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    opt = {names[p]: {k: v.clone() if torch.is_tensor(v) else v
                      for k, v in st.items()}
           for p, st in tr.state.optimizer.state.items()}
    return params, opt


def _assert_port_states_equal(a, b):
    (pa, oa), (pb, ob) = a, b
    assert sorted(pa) == sorted(pb) and sorted(oa) == sorted(ob)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    for n in oa:
        assert sorted(oa[n]) == sorted(ob[n]), n
        for k in oa[n]:
            x, y = oa[n][k], ob[n][k]
            assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), \
                (n, k)


# -- the file format -----------------------------------------------------------

def _sample():
    rng = np.random.default_rng(3)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    return {"w": f32,
            "w_bf16": f32.astype(ml_dtypes.bfloat16),
            "count": np.asarray(np.int32(7)),
            "empty": np.zeros((0, 4), np.float32),
            "q": rng.integers(-127, 128, (2, 3)).astype(np.int8),
            "a.b.c": rng.normal(size=(4,)).astype(np.float32)}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_safetensors_writer_gives_the_bytes_safetensors_writes(tmp_path):
    sample = _sample()
    ckpt.save_tensors(str(tmp_path / "port.safetensors"),
                      {k: _torch(v) for k, v in sample.items()})
    st_numpy.save_file(sample, str(tmp_path / "ref.safetensors"))
    assert (tmp_path / "port.safetensors").read_bytes() \
        == (tmp_path / "ref.safetensors").read_bytes()
    back = st_numpy.load_file(str(tmp_path / "port.safetensors"))
    assert sorted(back) == sorted(sample)
    for k, v in sample.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert back[k].tobytes() == v.tobytes(), k


def test_safetensors_reader_reads_what_safetensors_writes(tmp_path):
    sample = _sample()
    st_numpy.save_file(sample, str(tmp_path / "ref.safetensors"),
                       metadata={"format": "np"})
    got = ckpt.load_tensors(str(tmp_path / "ref.safetensors"))
    assert sorted(got) == sorted(sample)
    assert got["w_bf16"].dtype == torch.bfloat16
    assert got["count"].shape == () and got["count"].dtype == torch.int32
    assert got["empty"].shape == (0, 4)
    for k, v in sample.items():
        assert torch.equal(got[k], _torch(v)), k


# -- resume --------------------------------------------------------------------

@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_resumed_run_is_bit_equal_to_one_without_a_stop(family, tmp_path):
    """6 steps straight against 4 steps saved every 2 (async) and 2 more
    from the last save in a new model and Trainer."""
    batches = _batches(6)
    cfg_cls, cls = FAMILIES[family][2:]
    cfg = cfg_cls.tiny()
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(1e-3))
    a = _port_trainer(cls(cfg, device="cpu", seed=0), opt)
    want = _losses(a.train(iter(batches), steps=6))
    b = _port_trainer(cls(cfg, device="cpu", seed=0), opt,
                      ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    got = _losses(b.train(iter(batches[:4]), steps=4))
    with open(tmp_path / "ck" / "meta.json") as f:
        assert json.load(f)["step"] == 4
    c = _port_trainer(cls(cfg, device="cpu", seed=5), opt)
    c.resume(str(tmp_path / "ck"))
    assert c.state.step == 4
    got += _losses(c.train(iter(batches[4:]), steps=2))
    assert got == want
    assert c.state.step == a.state.step == 6
    _assert_port_states_equal(_port_state(c), _port_state(a))
    counts = {st["count"] for st in c.state.optimizer.state.values()}
    assert counts == {6}


def test_async_save_holds_the_state_of_its_call(tmp_path, monkeypatch):
    """The write of an async save is held until a step has run (and
    changed every param and moment in place): its files equal a sync save
    made before that step, and differ from one made after it."""
    batches = _batches(3)
    cfg = GPTConfig.tiny()
    tr = _port_trainer(GPTLMHeadModel(cfg, device="cpu", seed=0),
                       optim.adamw(1e-3))
    tr.train(iter(batches[:1]), steps=1)
    ckpt.save_checkpoint(str(tmp_path / "sync"), tr.state)
    stepped = threading.Event()
    real = ckpt.save_tensors

    def held(*a, **kw):
        assert stepped.wait(60)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "save_tensors", held)
    writer = ckpt.save_checkpoint(str(tmp_path / "async"), tr.state,
                                  async_save=True)
    assert writer.snapshot_seconds is not None
    tr.train(iter(batches[1:2]), steps=1)
    stepped.set()
    writer.wait()
    monkeypatch.setattr(ckpt, "save_tensors", real)
    ckpt.save_checkpoint(str(tmp_path / "after"), tr.state)
    name = "checkpoint.safetensors"
    sync = (tmp_path / "sync" / name).read_bytes()
    assert (tmp_path / "async" / name).read_bytes() == sync
    assert (tmp_path / "after" / name).read_bytes() != sync
    assert writer.write_seconds is not None and writer.nbytes > 0


def _jax_saved_like(tmp_path, port_dir, jmodel, jopt, **kw):
    """hetu_tpu's save of the state it loads from ``port_dir``."""
    state = jax_ckpt.load_checkpoint(str(port_dir), jmodel, jopt)
    out = tmp_path / "jax"
    jax_ckpt.save_checkpoint(str(out), state, **kw)
    return out


def test_split_archives_are_hetu_tpus_to_the_byte(tmp_path):
    jmodel, params, model, _ = _models("llama", "adamw")
    jopt, opt = _opts("adamw")
    tr = _port_trainer(model, opt)
    tr.train(iter(_batches(2)), steps=2)
    ckpt.save_checkpoint(str(tmp_path / "whole"), tr.state)
    ckpt.save_checkpoint(str(tmp_path / "split"), tr.state,
                         max_shard_bytes=64 * 1024)
    ref = _jax_saved_like(tmp_path, tmp_path / "whole", jmodel, jopt,
                          max_shard_bytes=64 * 1024)
    files = sorted(f for f in os.listdir(ref) if f != "meta.json")
    assert len(files) > 3
    assert sorted(f for f in os.listdir(tmp_path / "split")
                  if f != "meta.json") == files
    for f in files:
        assert (tmp_path / "split" / f).read_bytes() \
            == (ref / f).read_bytes(), f
    whole = ckpt.load_tensors(str(tmp_path / "whole"))
    split = ckpt.load_tensors(str(tmp_path / "split"))
    assert sorted(whole) == sorted(split)
    for k in whole:
        assert torch.equal(whole[k], split[k]), k
    back = _port_trainer(LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu"),
                         opt)
    back.resume(str(tmp_path / "split"))
    _assert_port_states_equal(_port_state(back), _port_state(tr))


def test_int8_storage_codes_and_scales_are_hetu_tpus(tmp_path):
    jmodel, params, model, cfg = _models("gpt", "adamw")
    jopt, opt = _opts("adamw")
    tr = _port_trainer(model, opt)
    tr.train(iter(_batches(1)), steps=1)
    ckpt.save_checkpoint(str(tmp_path / "whole"), tr.state)
    ckpt.save_checkpoint(str(tmp_path / "q"), tr.state, quantize="int8")
    ref = _jax_saved_like(tmp_path, tmp_path / "whole", jmodel, jopt,
                          quantize="int8")
    got, want = (ckpt.load_tensors(str(d)) for d in (tmp_path / "q", ref))
    assert sorted(got) == sorted(want)
    scales = [k for k in got if k.endswith(".q8scale")]
    assert "model.blocks.attn.q_proj.weight.q8scale" in scales
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    with open(tmp_path / "q" / "meta.json") as f:
        meta = json.load(f)
    with open(ref / "meta.json") as f:
        assert sorted(meta["quantized"]) == sorted(json.load(f)["quantized"])
    # loaded back, each package dequantizes to the same params
    back = GPTLMHeadModel(cfg, device="cpu")
    ckpt.load_checkpoint(str(tmp_path / "q"), back, opt)
    jstate = jax_ckpt.load_checkpoint(str(tmp_path / "q"), jmodel, jopt)
    for name, t in params_from_jax(_np(jstate.params), cfg).items():
        assert torch.equal(dict(back.named_parameters())[name].detach(),
                           t), name


# -- both ways with hetu_tpu ---------------------------------------------------

def _kinds(family, kind):
    jmodel, params, model, cfg = _models(family, kind)
    jmask = jax_trainable_mask(params) if kind == "lora" else None
    mask = lora_trainable_mask(model) if kind == "lora" else None
    jopt, opt = _opts(kind, jmask, mask)
    return jmodel, params, model, cfg, jopt, opt


KINDS = [("gpt", "adamw"), ("llama", "chain"), ("llama", "lora")]


@pytest.mark.parametrize("family,kind", KINDS)
def test_hetu_tpu_checkpoint_loads_into_the_port_and_steps_in_lockstep(
        family, kind, tmp_path):
    jmodel, params, model, cfg, jopt, opt = _kinds(family, kind)
    batches = _batches(4)
    jtr = _jax_trainer(jmodel, jopt, params)
    jtr.train(iter(batches[:2]), steps=2)
    jtr.save(str(tmp_path / "ck"), wait=True)
    # copies: the steps below donate the state's buffers
    saved_params = jax.tree.map(lambda a: np.array(a, np.float32),
                                jtr.state.params)
    saved_opt = {k: np.array(v) for k, v in
                 jax_ckpt._flatten(jtr.state.opt_state).items()}
    want = _losses(jtr.train(iter(batches[2:]), steps=2))
    tr = _port_trainer(model, opt)
    tr.resume(str(tmp_path / "ck"))
    assert tr.state.step == 2
    # bit for bit: params, the moments of every trained param, the count
    for name, t in params_from_jax(saved_params, cfg).items():
        assert torch.equal(dict(model.named_parameters())[name].detach(),
                           t), name
    slots = opt.jax_state_layout()
    names = {p: n for n, p in model.named_parameters()}
    for field in ("mu", "nu"):
        prefix = f"{slots['adam']}.{field}."
        tree = {k[len(prefix):]: np.asarray(v) for k, v in saved_opt.items()
                if k.startswith(prefix)}
        ref = grads_from_jax(tree, cfg)
        held = {names[p]: st[field] for p, st in tr.state.optimizer.state.items()}
        assert sorted(held) == sorted(n for n, p in model.named_parameters()
                                      if p.requires_grad)
        for n, t in held.items():
            assert torch.equal(t, ref[n]), (field, n)
    count = int(saved_opt[f"{slots['adam']}.count"])
    assert count == 2
    assert {st["count"] for st in tr.state.optimizer.state.values()} == {2}
    got = _losses(tr.train(iter(batches[2:]), steps=2))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family,kind", KINDS)
def test_port_checkpoint_loads_through_hetu_tpu_bit_for_bit(family, kind,
                                                            tmp_path):
    jmodel, params, model, cfg, jopt, opt = _kinds(family, kind)
    tr = _port_trainer(model, opt)
    tr.train(iter(_batches(2)), steps=2)
    tr.save(str(tmp_path / "ck"), wait=True)
    state = jax_ckpt.load_checkpoint(str(tmp_path / "ck"), jmodel, jopt)
    assert int(state.step) == 2
    for name, t in params_from_jax(_np(state.params), cfg).items():
        assert torch.equal(dict(model.named_parameters())[name].detach(),
                           t), name
    flat = jax_ckpt._flatten(state.opt_state)
    slots = opt.jax_state_layout()
    names = {p: n for n, p in model.named_parameters()}
    for field in ("mu", "nu"):
        prefix = f"{slots['adam']}.{field}."
        tree = {k[len(prefix):]: np.asarray(v) for k, v in flat.items()
                if k.startswith(prefix)}
        got = grads_from_jax(tree, cfg)
        assert sorted(got) == sorted(names.values())
        for p, n in names.items():
            want = tr.state.optimizer.state[p][field] if p.requires_grad \
                else torch.zeros(p.shape)
            assert torch.equal(got[n], want), (field, n)
    assert int(flat[f"{slots['adam']}.count"]) == 2
    assert int(flat[slots["count"]]) == 2
    assert flat[f"{slots['adam']}.count"].dtype == np.int32
    jflat = jax_ckpt._flatten(jopt.init(jmodel.abstract_params()))
    assert sorted(flat) == sorted(jflat)


def test_trainer_save_without_a_path_raises_as_hetu_tpus_does():
    tr = _port_trainer(GPTLMHeadModel(GPTConfig.tiny(), device="cpu"),
                       optim.adamw(1e-3))
    tr.initialize()
    with pytest.raises(ValueError, match="no checkpoint path configured"):
        tr.save()
    jtr = JaxTrainer(JaxGPT(JaxGPTConfig.tiny()), jax_optim.adamw(1e-3),
                     JaxStrategy(), config=JaxTrainerConfig(),
                     devices=jax.devices()[:1])
    jtr.initialize()
    with pytest.raises(ValueError, match="no checkpoint path configured"):
        jtr.save()
