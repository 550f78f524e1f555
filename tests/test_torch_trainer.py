"""The port's trainer stack against ``hetu_tpu``'s: the data modules
(array for array), ``chain(clip_by_global_norm, adamw)``, the device
prefetcher, and 10-step histories of ``Trainer.train`` (packed
pretraining) and ``SFTTrainer.fit`` on ``LlamaConfig.tiny``, each run
from one ``hetu_tpu`` parameter tree carried over with
``params_from_jax``.

Tolerances, those of the GPT counterparts in ``test_torch_train.py``:
data arrays exactly equal; a 10-step loss history at 1e-4 per step and
each grad norm at rtol 1e-4 (the 10-step AdamW lockstep); the
optimizer's params after three fp32 updates at rtol 1e-6 (the AdamW
update's)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import data as jax_data
from hetu_tpu import optim as jax_optim
from hetu_tpu.engine.sft_trainer import SFTTrainer as JaxSFTTrainer
from hetu_tpu.engine.sft_trainer import make_sft_batch as jax_make_sft_batch
from hetu_tpu.engine.sft_trainer import sft_batches as jax_sft_batches
from hetu_tpu.engine.trainer import Trainer as JaxTrainer
from hetu_tpu.engine.trainer import TrainerConfig as JaxTrainerConfig
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.optim.base import apply_updates as jax_apply_updates
from hetu_tpu.parallel.strategy import Strategy as JaxStrategy

from hetu_tpu_torch import data, optim
from hetu_tpu_torch.engine import (
    SFTTrainer, Trainer, TrainerConfig, make_sft_batch, sft_batches,
)
from hetu_tpu_torch.models import (
    LlamaConfig, LlamaLMHeadModel, params_from_jax,
)
from hetu_tpu_torch.parallel import Strategy

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if not isinstance(w, dict):
            assert g == w
            continue
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -- data ----------------------------------------------------------------------

def _docs(seed=0, n=23, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(1, 40))
            for _ in range(n)]


def test_pack_sequences_and_pad_batch_equal_jax():
    docs = _docs() + [np.arange(70)]          # one longer than a row
    for fn, jfn, kw in (
            (data.pack_sequences, jax_data.pack_sequences,
             dict(pad_id=3, ignore_index=-1)),
            (data.pad_batch, jax_data.packing.pad_batch, dict(pad_id=3))):
        got, want = fn(docs, 64, **kw), jfn(docs, 64, **kw)
        _assert_batches_equal([got.as_batch()], [want.as_batch()])


def test_samplers_equal_jax():
    for kw in (dict(shuffle=True, seed=4), dict(shuffle=False),
               dict(drop_last=False, seed=1)):
        _assert_batches_equal(data.sample_batches(23, 5, **kw),
                              jax_data.sample_batches(23, 5, **kw))
    lengths = [len(d) for d in _docs(seed=2)]
    for kw in (dict(seed=7), dict(shuffle=False)):
        _assert_batches_equal(data.token_batches(lengths, 60, **kw),
                              jax_data.token_batches(lengths, 60, **kw))


@pytest.mark.parametrize("kw", [
    dict(pack=True), dict(pack=False), dict(pack=True, max_tokens=90),
    dict(pack=True, drop_last=False, shuffle=False)])
def test_build_data_loader_equals_jax(kw):
    ds = data.SyntheticLMDataset(256, num_docs=64, min_len=4, max_len=40,
                                 seed=5)
    jds = jax_data.SyntheticLMDataset(256, num_docs=64, min_len=4,
                                      max_len=40, seed=5)
    for a, b in zip(ds, jds):
        np.testing.assert_array_equal(a, b)
    _assert_batches_equal(
        data.build_data_loader(ds, seq_len=48, batch_rows=3, **kw),
        jax_data.build_data_loader(jds, seq_len=48, batch_rows=3, **kw))


def test_json_dataset_equals_jax(tmp_path):
    path = tmp_path / "docs.jsonl"
    path.write_text('{"tokens": [5, 6, 7]}\n\n{"text": "ab c"}\n'
                    '{"tokens": [9]}\n{"text": "zz"}\n')
    tok = lambda text: [ord(c) for c in text]  # noqa: E731
    for kw in (dict(tokenizer=tok), dict(tokenizer=tok, max_items=3)):
        got = data.JsonDataset(str(path), **kw)
        want = jax_data.JsonDataset(str(path), **kw)
        assert len(got) == len(want)
        _assert_batches_equal([{"r": r} for r in got],
                              [{"r": r} for r in want])
    with pytest.raises(ValueError, match="tokenizer"):
        data.JsonDataset(str(path))


def test_context_parallel_packing_raises():
    with pytest.raises(NotImplementedError, match="slice 4"):
        data.pack_sequences(_docs(), 64, cp=2)
    with pytest.raises(NotImplementedError, match="slice 4"):
        next(data.build_data_loader(data.SyntheticLMDataset(256), seq_len=64,
                                    batch_rows=2, cp=2))


def _sft_pairs(n=12, vocab=256, seed=3):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, size=rng.integers(1, 12))
               for _ in range(n)]
    responses = [rng.integers(1, vocab, size=rng.integers(1, 30))
                 for _ in range(n)]
    return prompts, responses


def test_sft_batches_equal_jax():
    prompts, responses = _sft_pairs()
    _assert_batches_equal([make_sft_batch(prompts, responses, 24)],
                          [jax_make_sft_batch(prompts, responses, 24)])
    for kw in (dict(seed=2), dict(shuffle=False)):
        _assert_batches_equal(
            sft_batches(prompts, responses, seq_len=32, batch_size=5, **kw),
            jax_sft_batches(prompts, responses, seq_len=32, batch_size=5,
                            **kw))


# -- the optimizer chain ---------------------------------------------------------

class _Two(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.bias = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("max_norm", [0.05, 100.0])
def test_chain_clip_adamw_updates_match_jax(max_norm):
    """Three updates of ``chain(clip_by_global_norm, adamw)`` (clipping
    active, then idle): the weight is decayed, the bias not (JAX's ndim
    rule), and the grads are clipped in fp32 before Adam sees them."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    grads = [(rng.normal(size=(4, 3)).astype(np.float32),
              rng.normal(size=(3,)).astype(np.float32)) for _ in range(3)]
    jopt = jax_optim.chain(jax_optim.clip_by_global_norm(max_norm),
                           jax_optim.adamw(1e-2, weight_decay=0.1))
    params = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    jstate = jopt.init(params)
    model = _Two(w, b)
    spec = optim.chain(optim.clip_by_global_norm(max_norm),
                       optim.adamw(1e-2, weight_decay=0.1))
    torch_opt = spec.build(model)
    for i, (gw, gb) in enumerate(grads):
        upd, jstate = jopt.update({"weight": jnp.asarray(gw),
                                   "bias": jnp.asarray(gb)}, jstate, params)
        params = jax_apply_updates(params, upd)
        spec.step(torch_opt, i, {model.weight: torch.from_numpy(gw.copy()),
                                 model.bias: torch.from_numpy(gb.copy())})
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   np.asarray(params[name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_clip_promotes_bf16_grads_to_fp32_and_chain_checks_its_parts():
    g = [torch.full((3,), 2.0, dtype=torch.bfloat16), torch.ones(2)]
    out = optim.clip_by_global_norm(1.0)(g)
    assert [t.dtype for t in out] == [torch.float32, torch.float32]
    norm = float(np.sqrt(3 * 4 + 2))
    np.testing.assert_allclose(out[0].numpy(), 2.0 / (norm + 1e-6),
                               rtol=1e-6)
    with pytest.raises(TypeError, match="last part"):
        optim.chain(optim.adamw(1e-3), optim.clip_by_global_norm(1.0))
    with pytest.raises(TypeError, match="gradient transform"):
        optim.chain(optim.sgd(0.1), optim.adamw(1e-3))


# -- the prefetcher ----------------------------------------------------------------

def test_device_prefetcher_keeps_order_and_honours_max_items():
    host = [{"input_ids": np.full((2, 4), i, np.int32)} for i in range(7)]
    it = iter(host)
    with data.DevicePrefetcher(it, "cpu", max_items=3) as pf:
        got = [int(b["input_ids"][0, 0]) for b in pf]
        assert isinstance(pf, data.DevicePrefetcher)
    assert got == [0, 1, 2]
    # a shared iterator loses nothing past the cap
    assert [int(b["input_ids"][0, 0]) for b in
            data.DevicePrefetcher(it, "cpu")] == [3, 4, 5, 6]
    with pytest.raises(ValueError, match="buffer_size"):
        data.DevicePrefetcher(iter(host), "cpu", buffer_size=0)


# -- the Trainer ------------------------------------------------------------------

def _jax_trainer(cls, jcfg, jopt, steps, seed=0, **kw):
    """A ``hetu_tpu`` trainer with its state drawn from ``seed``, and the
    port's model holding the same params."""
    tr = cls(JaxLlama(jcfg), jopt, JaxStrategy(),
             config=JaxTrainerConfig(total_steps=steps, log_every=1,
                                     precision="fp32", seed=seed, **kw),
             devices=jax.devices()[:1])
    tr.initialize()
    cfg = LlamaConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(LlamaConfig)})
    model = LlamaLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(tr.state.params), cfg))
    return tr, model


def _lockstep(got, want):
    got = [r for r in got if "loss" in r]
    want = [r for r in want if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], atol=1e-4)
    np.testing.assert_allclose([r["grad_norm"] for r in got],
                               [r["grad_norm"] for r in want], rtol=1e-4)


def test_trainer_train_packed_history_matches_jax():
    """10 steps of ``Trainer.train`` over the packed loader (fp32), with
    a validation pass every 5 steps, against ``hetu_tpu``'s."""
    def loader(mod):
        ds = mod.SyntheticLMDataset(256, num_docs=128, min_len=8,
                                    max_len=40, seed=0)
        return mod.build_data_loader(ds, seq_len=64, batch_rows=2,
                                     pack=True)

    def held_out(mod):
        return lambda: list(mod.build_data_loader(
            mod.SyntheticLMDataset(256, num_docs=8, seed=9), seq_len=64,
            batch_rows=2))

    jtr, model = _jax_trainer(JaxTrainer, JaxLlamaConfig.tiny(),
                              jax_optim.adamw(3e-3, weight_decay=0.01), 10,
                              eval_every=5)
    want = jtr.train(loader(jax_data), eval_batches=held_out(jax_data))
    tr = Trainer(model, optim.adamw(3e-3, weight_decay=0.01), Strategy(),
                 config=TrainerConfig(total_steps=10, log_every=1,
                                      precision="fp32", eval_every=5,
                                      peak_flops=1e12),
                 device="cpu")
    got = tr.train(loader(data), eval_batches=held_out(data))
    _lockstep(got, want)
    steps = [r for r in got if "loss" in r]
    assert tr.state.step == 10 and steps[-1]["tokens_total"] == 10 * 2 * 64
    assert all(r["tokens_per_sec"] > 0 and r["mfu"] > 0 for r in steps)
    evals = [r["eval_loss"] for r in got if "eval_loss" in r]
    jevals = [r["eval_loss"] for r in want if "eval_loss" in r]
    assert len(evals) == 2
    np.testing.assert_allclose(evals, jevals, atol=1e-4)


def test_sft_trainer_fit_history_matches_jax():
    """10 steps of ``SFTTrainer.fit`` (response-only loss) with
    ``chain(clip_by_global_norm(0.5), adamw(5e-4, weight_decay=0.01))``,
    as ``examples/sft.py`` builds it, against ``hetu_tpu``'s; the clip
    is active (each reported norm, taken before clipping, is above it)."""
    prompts, responses = _sft_pairs(n=40)
    jtr, model = _jax_trainer(JaxSFTTrainer, JaxLlamaConfig.tiny(),
                              jax_optim.chain(
                                  jax_optim.clip_by_global_norm(0.5),
                                  jax_optim.adamw(5e-4, weight_decay=0.01)),
                              10, seed=2)
    want = jtr.fit(prompts, responses, seq_len=32, batch_size=4)
    tr = SFTTrainer(model, optim.chain(optim.clip_by_global_norm(0.5),
                                       optim.adamw(5e-4, weight_decay=0.01)),
                    Strategy(), device="cpu",
                    config=TrainerConfig(total_steps=10, log_every=1,
                                         precision="fp32"))
    got = tr.fit(prompts, responses, seq_len=32, batch_size=4)
    assert len(got) == 10
    _lockstep(got, want)
    assert min(r["grad_norm"] for r in got) > 0.5


def test_dropout_runs_replay_from_their_seed():
    """Two SFT runs with residual and attention dropout from the same
    weights log the same history (each step's seed comes from its step
    count); without dropout the history differs."""
    prompts, responses = _sft_pairs(n=16)
    cfg = dataclasses.replace(LlamaConfig.tiny(), resid_pdrop=0.1,
                              attn_pdrop=0.1)
    runs = []
    for c in (cfg, LlamaConfig.tiny(), cfg):
        tr = SFTTrainer(LlamaLMHeadModel(c, device="cpu", seed=4),
                        optim.adamw(1e-3), Strategy(remat="selective"),
                        device="cpu",
                        config=TrainerConfig(total_steps=4, log_every=1,
                                             precision="fp32", prefetch=0))
        runs.append([(r["loss"], r["grad_norm"]) for r in
                     tr.fit(prompts, responses, seq_len=32, batch_size=4)])
    assert runs[0] == runs[2] != runs[1]


def test_trainer_seed_redraws_the_weights_and_bf16_policy_applies():
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu", seed=1)
    ref = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu", seed=6)
    tr = Trainer(model, optim.sgd(0.0), Strategy(), device="cpu",
                 config=TrainerConfig(seed=6))
    assert tr.plan.policy.compute_dtype == torch.bfloat16
    tr.initialize()
    for (n, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), n
    # one step on a host batch; SGD(0) leaves the weights as they are
    ids = np.random.default_rng(0).integers(0, 256, (2, 17))
    metrics = tr.train_step({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    assert tr.state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert torch.equal(model.wte.weight, ref.wte.weight)
    with pytest.raises(ValueError, match="precision"):
        TrainerConfig(precision="fp16")


def test_trainer_refuses_a_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, optim.adamw(1e-3), Strategy())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SFTTrainer(model, optim.adamw(1e-3), Strategy())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaLMHeadModel(LlamaConfig.tiny())
