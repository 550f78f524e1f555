"""The port's shape plane against ``hetu_tpu``'s: the bucket ladder and
``ShapeBucketer`` (fit and stats) array for array, the ragged-epoch
re-trace audit (``tests/test_shape_plane.py:302``) on the captured step
(3 ``train_step`` captures for six ragged batches, none in a second
pass, ``real_tokens == 290``), and a bucketed ``Trainer``'s losses equal
to JAX's bucketed ``Trainer`` step for step at 1e-5 (atol and rtol, the
fp32 training tolerance of ``test_torch_train.py``)."""

import dataclasses
import warnings

import numpy as np
import pytest

import jax
import torch

from hetu_tpu import optim as jax_optim
from hetu_tpu.data import bucket as jax_bucket
from hetu_tpu.engine.trainer import Trainer as JaxTrainer
from hetu_tpu.engine.trainer import TrainerConfig as JaxTrainerConfig
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.parallel.strategy import Strategy as JaxStrategy

from hetu_tpu_torch import optim
from hetu_tpu_torch.data import bucket
from hetu_tpu_torch.engine import StepCache, Trainer, TrainerConfig, \
    trace_counts
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from hetu_tpu_torch.parallel import Strategy

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def test_bucket_ladder_matches_jax():
    for kw in (dict(sizes=(64, 16, 32, 32)), dict(sizes=[32, 64, 16]),
               dict(), dict(min_len=64, max_len=1000),
               dict(sizes=(16, 48), multiple_of=16)):
        a, b = bucket.SeqLenBuckets(**kw), jax_bucket.SeqLenBuckets(**kw)
        assert a.sizes == b.sizes
        lens = [1, 15, 16, 17, 40, 64, 200, 5000, 9000]
        assert [a.bucket_for(n) for n in lens] \
            == [b.bucket_for(n) for n in lens]
        assert a.group(lens) == b.group(lens)
    for mod in (bucket, jax_bucket):
        with pytest.raises(ValueError, match="multiple of 4"):
            mod.SeqLenBuckets(sizes=(10,), multiple_of=4)
    assert bucket.PAD_SEGMENT == jax_bucket.PAD_SEGMENT


def _ragged(seed, n=8):
    """Host batches of random widths and real lengths, with positions and
    segment ids; some without labels."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows, w = int(rng.integers(1, 4)), int(rng.integers(3, 90))
        lab = np.full((rows, w), -100, np.int32)
        for r in range(rows):
            lab[r, :rng.integers(0, w + 1)] = rng.integers(0, 50)
        b = {"input_ids": rng.integers(1, 50, (rows, w)).astype(np.int32),
             "labels": lab,
             "positions": np.tile(np.arange(w, dtype=np.int32), (rows, 1)),
             "segment_ids": rng.integers(0, 3, (rows, w)).astype(np.int32),
             "weights": np.ones((rows,), np.float32)}
        if i % 3 == 2:
            del b["labels"]
            b["input_ids"][:, w // 2:] = 0
        out.append(b)
    return out


def test_shape_bucketer_fit_and_stats_match_jax():
    mine = bucket.ShapeBucketer(bucket.SeqLenBuckets(sizes=(16, 32, 64)))
    theirs = jax_bucket.ShapeBucketer(
        jax_bucket.SeqLenBuckets(sizes=(16, 32, 64)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for b in _ragged(0):
            np.testing.assert_array_equal(mine.lengths(b), theirs.lengths(b))
            assert mine.bucket_for_batch(b) == theirs.bucket_for_batch(b)
            got, want = mine.fit(dict(b)), theirs.fit(dict(b))
            assert sorted(got) == sorted(want)
            for k in want:
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert dataclasses.asdict(mine.stats) == dataclasses.asdict(theirs.stats)
    assert mine.stats.to_record() == theirs.stats.to_record()
    assert mine.stats.truncated_tokens > 0       # rows past 64 were cut
    assert sum("largest seq bucket" in str(w.message) for w in caught) == 2


def _tiny(**kw):
    return dataclasses.replace(GPTConfig.tiny(), **kw)


def _audit_batches(vocab):
    """``test_ragged_epoch_retrace_audit``'s six batches."""
    rng = np.random.default_rng(0)

    def mk(width, real):
        ids = rng.integers(1, vocab, (2, width)).astype(np.int32)
        labels = np.full((2, width), -100, np.int32)
        for r, t in enumerate(real):
            labels[r, :t] = ids[r, :t]
        return {"input_ids": ids, "labels": labels}

    return [mk(13, (13, 5)), mk(30, (30, 22)), mk(64, (60, 10)),
            mk(20, (20, 11)), mk(7, (7, 3)), mk(55, (55, 54))]


def test_ragged_epoch_retrace_audit():
    """An epoch of ragged widths through a ``seq_buckets`` Trainer
    captures one step graph a bucket (3), a second pass none, and the
    pad accounting prices the win (the JAX audit's numbers)."""
    cfg = GPTConfig.tiny()
    tr = Trainer(GPTLMHeadModel(cfg, device="cpu"), optim.adamw(1e-3),
                 Strategy(), device="cpu", step_cache=StepCache(),
                 config=TrainerConfig(total_steps=10, log_every=0,
                                      prefetch=0, precision="fp32",
                                      seq_buckets=(16, 32, 64)))
    batches = _audit_batches(cfg.vocab_size)
    before = trace_counts().get("train_step", 0)
    tr.initialize()
    tr.train(iter(batches), steps=len(batches))
    first = trace_counts().get("train_step", 0) - before
    assert first == 3
    st = tr.bucketer.stats
    assert st.batches == len(batches)
    assert st.bucket_tokens < len(batches) * 2 * 64
    assert st.real_tokens == 290
    assert sorted(tr._bucket_entries) == [16, 32, 64]
    assert {b: c for b, (c, _) in tr.captures().items()} \
        == {0: 0, 16: 1, 32: 1, 64: 1}
    tr.train(iter(batches), steps=len(batches))
    assert trace_counts().get("train_step", 0) - before == 3


def test_bucketed_trainer_losses_match_jax():
    """The audit's batches through both packages' bucketed Trainers, one
    log record a step: losses at 1e-5, the tokens of the fitted widths."""
    jcfg = JaxGPTConfig.tiny()
    jtr = JaxTrainer(JaxGPT(jcfg), jax_optim.adamw(3e-3), JaxStrategy(),
                     config=JaxTrainerConfig(log_every=1, precision="fp32",
                                             seed=0, prefetch=0,
                                             seq_buckets=(16, 32, 64)),
                     devices=jax.devices()[:1])
    jtr.initialize()
    cfg = GPTConfig(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(GPTConfig)})
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jtr.state.params),
        cfg))
    tr = Trainer(model, optim.adamw(3e-3), Strategy(), device="cpu",
                 step_cache=StepCache(),
                 config=TrainerConfig(log_every=1, precision="fp32",
                                      prefetch=0, seq_buckets=(16, 32, 64)))
    batches = _audit_batches(cfg.vocab_size)
    want = [r for r in jtr.train(iter(batches), steps=6) if "loss" in r]
    got = [r for r in tr.train(iter(batches), steps=6) if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], **TOL)
    assert got[-1]["tokens_total"] == want[-1]["tokens_total"] \
        == 2 * (16 + 32 + 64 + 32 + 16 + 64)


def test_train_step_fits_and_the_eval_is_unbucketed():
    """``train_step`` fits its batch to the bucket too; an unbucketed
    Trainer keeps each width's own graph in the base entry."""
    cfg = _tiny()
    batches = _audit_batches(cfg.vocab_size)
    tr = Trainer(GPTLMHeadModel(cfg, device="cpu"), optim.adamw(1e-3),
                 Strategy(), device="cpu", step_cache=StepCache(),
                 config=TrainerConfig(precision="fp32", prefetch=0,
                                      seq_buckets=(16, 32, 64)))
    for b in batches:
        tr.train_step(b)
    assert sorted(tr._bucket_entries) == [16, 32, 64]
    plain = Trainer(GPTLMHeadModel(cfg, device="cpu"), optim.adamw(1e-3),
                    Strategy(), device="cpu", step_cache=StepCache(),
                    config=TrainerConfig(precision="fp32", prefetch=0))
    for b in batches:
        plain.train_step(b)
    assert len(plain._step_fn.entry.graphs) == 6
    assert plain.bucketer is None
