"""The port's Llama training forward and backward against ``hetu_tpu``'s
on ``LlamaConfig.tiny`` (GQA 4/2, head_dim 16).

One ``hetu_tpu`` parameter tree is carried into the port with
``params_from_jax``; grads come back with ``grads_from_jax``; the batch
is packed with numpy from a seed (``hetu_tpu.data.pack_sequences``:
positions restart at each document, segment ids isolate them).
Tolerances, those of the GPT counterparts in ``test_torch_train.py``:
- fp32 loss and every grad: 1e-5 (atol and rtol; sums in other orders);
- bf16 compute: loss within 2e-3 and every grad within 5% of the largest
  grad (the frameworks round bf16 at different points);
- remat none/full/selective and a ``remat_mask``: bit-identical losses
  and grads;
- ``apply_rotary``'s grads (no GPT counterpart): fp32 1e-6 (the same
  fp32 products, summed in other orders), bf16 one bf16 ulp (both
  rotate in fp32 and round once).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.core.dtypes import BF16_COMPUTE as JAX_BF16
from hetu_tpu.core.dtypes import autocast as jax_autocast
from hetu_tpu.data import pack_sequences as jax_pack_sequences
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.ops import rotary as jax_rot

from hetu_tpu_torch import optim
from hetu_tpu_torch.core import BF16_COMPUTE, autocast
from hetu_tpu_torch.engine import (
    build_train_step, init_state, make_plan, model_dropout_active,
    step_dropout_seed,
)
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel,
    grads_from_jax, params_from_jax,
)
from hetu_tpu_torch.nn import parallel as parallel_mod
from hetu_tpu_torch.ops import apply_rotary, rope_frequencies
from hetu_tpu_torch.ops import flash as flash_mod
from hetu_tpu_torch.parallel import Strategy

torch.set_num_threads(2)

REMATS = ("none", "full", "selective")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def packed_batch(seed=0, seq_len=48, vocab=256, lengths=(20, 9, 17, 30,
                                                         11, 14)):
    """Documents of ``lengths`` packed into rows of ``seq_len`` (three
    rows, two or three documents and a pad tail each)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, vocab, size=n) for n in lengths]
    return jax_pack_sequences(docs, seq_len).as_batch()


def _jax_kw(batch):
    return dict(positions=jnp.asarray(batch["positions"]),
                segment_ids=jnp.asarray(batch["segment_ids"]))


def _port_kw(batch):
    return dict(positions=_t(batch["positions"]),
                segment_ids=_t(batch["segment_ids"]))


def _jax_loss_and_grads(jmodel, params, batch, policy=None):
    def loss(p):
        return jmodel.loss(p, jnp.asarray(batch["input_ids"]),
                           jnp.asarray(batch["labels"]), **_jax_kw(batch))
    if policy is None:
        return jax.jit(jax.value_and_grad(loss))(params)
    with jax_autocast(policy):
        return jax.jit(jax.value_and_grad(loss))(params)


def _port_loss_and_grads(model, batch, **kw):
    model.zero_grad(set_to_none=True)
    loss = model.loss(_t(batch["input_ids"]), _t(batch["labels"]),
                      **_port_kw(batch), **kw)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def _carry(jcfg, cfg, seed=0):
    jmodel = JaxLlama(jcfg)
    params = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    model = LlamaLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(params), cfg))
    return jmodel, params, model


@pytest.fixture(scope="module")
def tiny():
    jmodel, params, model = _carry(JaxLlamaConfig.tiny(), LlamaConfig.tiny())
    batch = packed_batch()
    loss, grads = _jax_loss_and_grads(jmodel, params, batch)
    return dict(jmodel=jmodel, params=params, model=model, batch=batch,
                loss=float(loss),
                grads=grads_from_jax(_np_tree(grads), model.cfg))


@pytest.fixture(scope="module")
def no_remat(tiny):
    return _port_loss_and_grads(tiny["model"], tiny["batch"])


@pytest.mark.parametrize("remat,remat_mask", [
    *((r, None) for r in REMATS), ("selective", (False, True)),
    ("none", (True, False))])
def test_llama_tiny_packed_loss_and_every_grad_match_jax(
        tiny, no_remat, remat, remat_mask):
    loss, grads = _port_loss_and_grads(tiny["model"], tiny["batch"],
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


def test_llama_tiny_bf16_compute_tracks_jax(tiny):
    cfg = tiny["model"].cfg
    jloss, jgrads = _jax_loss_and_grads(tiny["jmodel"], tiny["params"],
                                        tiny["batch"], JAX_BF16)
    want = grads_from_jax(_np_tree(jgrads), cfg)
    with autocast(BF16_COMPUTE):
        loss, grads = _port_loss_and_grads(tiny["model"], tiny["batch"],
                                           remat="selective")
    assert abs(float(loss) - float(jloss)) < 2e-3
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        assert g.dtype == torch.float32, name       # fp32 params, fp32 grads
        err = float((g - want[name]).abs().max())
        assert err <= 0.05 * gmax, (name, err, gmax)


def test_llama_chunked_loss_at_a_large_vocab_matches_jax():
    """A vocab of 8192 or more takes the chunked CE through the untied
    head (Llama-7B's 32,000 does): fp32 loss and every grad at 1e-5."""
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), vocab_size=8269,
                               num_layers=1)
    cfg = dataclasses.replace(LlamaConfig.tiny(), vocab_size=8269,
                              num_layers=1)
    jmodel, params, model = _carry(jcfg, cfg, seed=3)
    batch = packed_batch(seed=4, vocab=8269, lengths=(40, 24, 31))
    jloss, jgrads = _jax_loss_and_grads(jmodel, params, batch)
    want = grads_from_jax(_np_tree(jgrads), cfg)
    loss, grads = _port_loss_and_grads(model, batch, remat="selective")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2.0 ** -8)])
def test_apply_rotary_grads_match_jax_grad(dtype, tol):
    """The RoPE backward (autograd of the port's ``apply_rotary``) against
    ``jax.grad``, at (b, s) positions that restart per segment."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 24, 3, 16)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    pos = np.stack([np.r_[np.arange(10), np.arange(14)],
                    np.r_[np.arange(5), np.arange(7), np.arange(12)]])
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jc, js = jax_rot.rope_frequencies(16, 64)
    jx, jct = jnp.asarray(x, jdt), jnp.asarray(ct, jdt)

    def f(a):
        return jnp.sum((jax_rot.apply_rotary(a, jc, js, jnp.asarray(pos))
                        * jct).astype(jnp.float32))

    want = np.asarray(jax.grad(f)(jx).astype(jnp.float32))
    c, s = rope_frequencies(16, 64)
    tx = _t(x).to(dtype).requires_grad_()
    out = apply_rotary(tx, c, s, _t(pos))
    assert out.dtype == dtype
    (out * _t(ct).to(dtype)).float().sum().backward()
    assert tx.grad.dtype == dtype
    np.testing.assert_allclose(tx.grad.float().numpy(), want, rtol=tol,
                               atol=1e-6)


class _Spy(torch.nn.Module):
    """A block that records the keyword arguments it is called with."""

    def __init__(self, seen):
        super().__init__()
        self.seen = seen
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x, **kw):
        self.seen.append(kw)
        return x * self.w


@pytest.mark.parametrize("remat", REMATS)
def test_stacked_blocks_pass_positions_to_every_block(remat):
    """``StackedBlocks.forward`` hands each block its ``positions`` on the
    plain and on the checkpointed call, as the JAX scan passes them on:
    a packed batch restarts RoPE's positions at each document."""
    seen = []
    blocks = parallel_mod.StackedBlocks(lambda: _Spy(seen), 3)
    x = torch.randn(2, 8, 4, requires_grad=True)
    pos = torch.tensor([[0, 1, 2, 0, 1, 0, 1, 2]] * 2)
    seg = torch.tensor([[0, 0, 0, 1, 1, 2, 2, 2]] * 2)
    blocks(x, remat=remat, positions=pos, segment_ids=seg,
           dropout_seed=5).sum().backward()
    runs = 6 if remat != "none" else 3        # a checkpoint recomputes
    assert len(seen) == runs
    for kw in seen:
        assert kw["positions"] is pos and kw["segment_ids"] is seg
    assert len({kw["dropout_seed"] for kw in seen}) == 3


def test_gpt_ignores_positions_in_its_blocks():
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    x = torch.randint(0, 256, (2, 16))
    with torch.no_grad():
        want = model.blocks(model.embed(x))
        got = model.blocks(model.embed(x), positions=torch.zeros_like(x))
    assert torch.equal(got, want)


@pytest.mark.parametrize("remat,remat_mask,fwd", [
    ("none", None, (1, 1)), ("selective", None, (1, 1)),
    ("full", None, (2, 2)), ("none", (True, False), (2, 1))])
def test_llama_backbone_runs_through_stacked_blocks(tiny, monkeypatch,
                                                    remat, remat_mask, fwd):
    """The training backbone goes through ``StackedBlocks.forward``, so
    remat reaches Llama: selective remat keeps the flash forward (one a
    layer, as without remat), full remat runs it again in the backward,
    and a ``remat_mask`` picks the layers."""
    calls = {"stacked": 0, "fwd": 0}
    stacked = parallel_mod.StackedBlocks.forward
    fwd_fn = flash_mod.flash_attention_fwd

    def count_stacked(self, *a, **kw):
        calls["stacked"] += 1
        return stacked(self, *a, **kw)

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd_fn(*a, **kw)

    monkeypatch.setattr(parallel_mod.StackedBlocks, "forward", count_stacked)
    monkeypatch.setattr(flash_mod, "flash_attention_fwd", count_fwd)
    _port_loss_and_grads(tiny["model"], tiny["batch"], remat=remat,
                         remat_mask=remat_mask)
    assert calls == {"stacked": 1, "fwd": sum(fwd)}


def test_llama_dropout_replays_from_its_seed_and_eval_is_plain():
    cfg = dataclasses.replace(LlamaConfig.tiny(), resid_pdrop=0.1,
                              attn_pdrop=0.1)
    model = LlamaLMHeadModel(cfg, device="cpu")
    plain = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    plain.load_state_dict(model.state_dict())
    assert model_dropout_active(model) and not model_dropout_active(plain)
    batch = packed_batch(seed=7)
    x, y = _t(batch["input_ids"]), _t(batch["labels"])
    kw = _port_kw(batch)
    with torch.no_grad():
        seeded = [float(model.loss(x, y, dropout_seed=s, **kw))
                  for s in (step_dropout_seed(3), step_dropout_seed(3),
                            step_dropout_seed(4))]
        assert seeded[0] == seeded[1] != seeded[2]
        # no seed: no dropout, whatever the rates
        assert float(model.loss(x, y, **kw)) == float(plain.loss(x, y, **kw))
    # attention dropout alone splits the seed three ways, residual
    # dropout alone two ways: each rate changes the loss by itself
    for rates in ({"resid_pdrop": 0.1}, {"attn_pdrop": 0.1}):
        one = LlamaLMHeadModel(dataclasses.replace(LlamaConfig.tiny(),
                                                   **rates), device="cpu")
        one.load_state_dict(model.state_dict())
        with torch.no_grad():
            assert float(one.loss(x, y, dropout_seed=9, **kw)) \
                != float(plain.loss(x, y, **kw))


def test_llama_train_step_threads_positions_and_segments(tiny):
    """``build_train_step`` hands the batch's positions and segment ids to
    Llama: one SGD(0) step's loss equals the packed loss, not the loss of
    the same tokens as unpacked rows."""
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    model.load_state_dict(tiny["model"].state_dict())
    opt = optim.sgd(0.0)
    plan = make_plan(model, opt, Strategy(remat="selective"), device="cpu")
    step = build_train_step(model, opt, plan)
    batch = {k: _t(v) for k, v in tiny["batch"].items()}
    _, m = step(init_state(model, opt, plan), batch)
    np.testing.assert_allclose(float(m["loss"]), tiny["loss"], rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():
        unpacked = float(model.loss(batch["input_ids"], batch["labels"]))
    assert abs(unpacked - tiny["loss"]) > 1e-4      # well above fp32 noise


def test_moe_llama_still_refuses():
    """A Llama-MoE trains on one device (``tests/test_torch_moe.py``
    holds it to ``hetu_tpu``); expert parallelism still refuses."""
    model = LlamaLMHeadModel(dataclasses.replace(LlamaConfig.tiny(),
                                                 num_experts=4), device="cpu")
    assert model.blocks.returns_aux
    with pytest.raises(NotImplementedError, match="slice 4"):
        make_plan(model, optim.adamw(1e-3), Strategy(ep=4), device="cpu")
