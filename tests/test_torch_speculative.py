"""The port's speculative-decoding pieces against ``hetu_tpu``'s, on the CPU:
the verify rule (greedy: bit for bit for every accept/reject pattern;
sampled: the committed marginal against the target), the n-gram
draftsman, the configuration errors and ``generation.decode(row_mask=)``
over a paged arena.

The sampled rule follows the port's own PRNG rule
(``hetu_tpu_torch/serving/speculative.py``), so it is held to the target
distribution (total variation 0.04 over 8192 generators, as
``tests/test_spec_qos.py:96-149`` holds JAX's) and to the spec-off
sampler at depth 0, not to JAX's draws.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.models import generation as jax_generation
from hetu_tpu.serving import speculative as jax_spec

from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel, decode,
    init_kv_caches, params_from_jax,
)
from hetu_tpu_torch.serving import sample_slots, speculative as spec
from hetu_tpu_torch.serving.sampling import adjust_logits

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the verify rule
# ---------------------------------------------------------------------------

def _jax_verify(logits, drafts, depth, q, temp, topk, topp, seeds):
    keys = np.stack([np.asarray(jax.random.key_data(jax.random.key(s)))
                     for s in seeds])
    committed, n, _, _ = jax.vmap(jax_spec.speculative_verify)(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
        jnp.asarray(depth, jnp.int32), jnp.asarray(q, jnp.float32),
        jnp.asarray(temp, jnp.float32), jnp.asarray(topk, jnp.int32),
        jnp.asarray(topp, jnp.float32), jnp.asarray(keys))
    return np.asarray(committed), np.asarray(n)


def test_greedy_verify_matches_jax_for_every_pattern_and_depth():
    """Temperature 0: for all 2^K accept/reject patterns at every depth
    0..K, the committed tokens and ``ncommit`` equal JAX's vmapped
    ``speculative_verify`` (``tests/test_spec_qos.py:152``): the leading
    matches plus the argmax at the first miss."""
    V, K = 7, 3
    rng = np.random.default_rng(11)
    base = rng.normal(0.0, 2.0, (K + 1, V)).astype(np.float32)
    greedy = base.argmax(-1)
    drafts, depth = [], []
    for pattern in range(2 ** K):
        d = [greedy[i] if (pattern >> i) & 1 else (greedy[i] + 1) % V
             for i in range(K)]
        for dep in range(K + 1):
            drafts.append(d)
            depth.append(dep)
    S = len(drafts)
    logits = np.broadcast_to(base, (S, K + 1, V)).copy()
    drafts = np.asarray(drafts, np.int64)
    depth = np.asarray(depth, np.int64)
    zeros = np.zeros(S, np.float32)
    want_c, want_n = _jax_verify(logits, drafts, depth,
                                 np.zeros((S, K, V), np.float32), zeros,
                                 np.zeros(S, np.int32), np.ones(S), range(S))
    got_c, got_n = spec.speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts), depth, None,
        zeros, np.zeros(S, np.int64), np.ones(S, np.float32), [None] * S)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got_c, want_c)
    # the lane's own argmax gives the same commits
    again = spec.speculative_verify(
        torch.from_numpy(logits), drafts, depth, None, zeros,
        np.zeros(S, np.int64), np.ones(S, np.float32), [None] * S,
        greedy=torch.from_numpy(logits).argmax(-1))
    np.testing.assert_array_equal(again[0], want_c)


@pytest.mark.parametrize("proposal", ["smooth", "one_hot"])
def test_sampled_verify_keeps_the_target_distribution(proposal):
    """Temperature > 0: the first committed token over 8192 slots, each
    with its own generator, lies within total variation 0.04 of the
    target softmax (the same bound as JAX's test): for drafts sampled from
    a deliberately wrong smooth q, and for a fixed draft (one-hot q,
    the n-gram draftsman's case), whose lane-0 accept rate must be p(d)
    within 0.03."""
    V, K, N = 5, 2, 8192
    rng = np.random.default_rng(7)
    base = rng.normal(0.0, 1.5, (K + 1, V)).astype(np.float32)
    temp, topk, topp = 0.7, 0, 1.0
    target = torch.softmax(adjust_logits(torch.from_numpy(base)[0], temp,
                                         topk, topp), -1).numpy()
    jtarget = np.asarray(jax.nn.softmax(
        jax_spec.adjust_logits(jnp.asarray(base), temp, topk, topp)[0]))
    np.testing.assert_allclose(target, jtarget, atol=1e-6)
    if proposal == "smooth":
        qp = torch.softmax(torch.from_numpy(
            rng.normal(0.0, 1.0, (K, V)).astype(np.float32)), -1)
        drafts = np.stack([rng.choice(V, size=N, p=qp[i].double().numpy()
                                      / float(qp[i].double().sum()))
                           for i in range(K)], axis=1)
        q = qp[None].expand(N, K, V)
    else:
        drafts = np.full((N, K), 3, np.int64)
        q = None
    gens = [torch.Generator().manual_seed(s) for s in range(N)]
    committed, n = spec.speculative_verify(
        torch.from_numpy(base)[None].expand(N, K + 1, V), drafts,
        np.full(N, K), q, np.full(N, temp, np.float32),
        np.full(N, topk), np.full(N, topp, np.float32), gens)
    emp = np.bincount(committed[:, 0], minlength=V) / N
    assert 0.5 * np.abs(emp - target).sum() < 0.04
    if proposal == "one_hot":
        assert abs(float((n >= 2).mean()) - target[3]) < 0.03
    # the commits are drafts up to the first rejection
    for c, m, d in zip(committed[:64], n[:64], drafts[:64]):
        assert list(c[:m - 1]) == list(d[:m - 1])


def test_depth_zero_sampled_slot_is_the_spec_off_sampler():
    """A sampled slot with no draft draws exactly what ``sample_slots``
    draws from the same row and seed, and leaves its generator in the
    same state; slots with drafts beside it do not disturb it."""
    S, K, V = 6, 3, 40
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(0.0, 2.0, (S, K + 1, V))
                              .astype(np.float32))
    temp = np.array([0.7, 1.0, 0.0, 0.8, 1.3, 0.9], np.float32)
    topk = np.array([0, 5, 0, 0, 4, 0], np.int64)
    topp = np.array([0.0, 0.0, 0.0, 0.9, 0.8, 0.0], np.float32)
    depth = np.array([0, 0, 2, 3, 0, 1], np.int64)
    drafts = rng.integers(0, V, (S, K))
    gens = [torch.Generator().manual_seed(100 + s) for s in range(S)]
    committed, n = spec.speculative_verify(logits, drafts, depth, None, temp,
                                           topk, topp, gens)
    ref = [torch.Generator().manual_seed(100 + s) for s in range(S)]
    want = sample_slots(logits[:, 0], temp, topk, topp, ref)
    for s in np.nonzero(depth == 0)[0]:
        assert n[s] == 1 and committed[s, 0] == want[s]
        assert torch.equal(gens[s].get_state(), ref[s].get_state())


# ---------------------------------------------------------------------------
# the n-gram draftsman and the configuration errors
# ---------------------------------------------------------------------------

def _ngram_trace(mod, seed):
    rng = np.random.default_rng(seed)
    d = mod.NgramDraftsman(3, ngram=3)
    out = []
    for step in range(300):
        slot = int(rng.integers(0, 3))
        op = rng.random()
        if op < 0.05 or step < 3:
            pat = rng.integers(0, 9, int(rng.integers(1, 6))).tolist()
            d.reset(slot, pat * int(rng.integers(1, 4))
                    + rng.integers(0, 9, int(rng.integers(0, 5))).tolist())
            out.append(("reset", slot))
        elif op < 0.55:
            d.extend(slot, rng.integers(0, 9, int(rng.integers(1, 4)))
                     .tolist())
        else:
            k = int(rng.integers(0, 6))
            out.append(("propose", slot, k, d.propose(slot, k)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_proposals_match_jax(seed):
    """Seeded random streams with ``reset``/``extend``/``propose``
    interleaved over three slots: every proposal equals JAX's."""
    got = _ngram_trace(spec, seed)
    assert got == _ngram_trace(jax_spec, seed)
    assert any(p[3] for p in got if p[0] == "propose")


def test_ngram_draftsman_proposes_continuations():
    d = spec.NgramDraftsman(2, ngram=3)
    pat = [5, 9, 2, 7]
    d.reset(0, pat * 4)
    assert d.propose(0, 4) == pat
    assert d.propose(0, 2) == pat[:2]
    d.reset(1, [1, 2, 3, 4, 5, 6, 7])
    assert d.propose(1, 4) == []
    d.extend(1, [1, 2])
    assert d.propose(1, 3) == [3, 4, 5]
    assert d.propose(0, 0) == []


def _raises(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("depth,max_len", [(-1, 32), (32, 32), (31, 32),
                                           (4, 32), (0, 32), (0, 0)])
def test_check_draft_depth_matches_jax(depth, max_len):
    assert _raises(spec.check_draft_depth, depth, max_len) \
        == _raises(jax_spec.check_draft_depth, depth, max_len)
    if _raises(spec.check_draft_depth, depth, max_len) is None:
        assert spec.check_draft_depth(depth, max_len) == depth


@pytest.mark.parametrize("gate", ["topk", "balance"])
def test_check_draft_model_matches_jax(gate):
    """The balance gate (batch-coupled) is refused by both packages with
    the named error; a per-token gate and a dense model pass."""
    jmodel = JaxGPT(JaxGPTConfig.tiny_moe(moe_gate=gate))
    model = GPTLMHeadModel(GPTConfig.tiny_moe(moe_gate=gate), device="cpu")
    want = _raises(jax_spec.check_draft_model, jmodel)
    got = _raises(spec.check_draft_model, model)
    assert (got is None) == (want is None) == (gate == "topk")
    if gate == "balance":
        assert got[0] == want[0] == "SpeculativeConfigError"
        assert "batch-coupled gate (BalanceGate)" in got[1]
    assert spec.check_draft_model(GPTLMHeadModel(GPTConfig.tiny(),
                                                 device="cpu")) is None


def test_check_sampled_draft_matches_jax():
    class NoQ:
        pass

    for draftsman in (None, NoQ(), spec.NgramDraftsman(1)):
        jd = jax_spec.NgramDraftsman(1) \
            if isinstance(draftsman, spec.NgramDraftsman) else draftsman
        assert _raises(spec.check_sampled_draft, draftsman) \
            == _raises(jax_spec.check_sampled_draft, jd)
    msg = _raises(spec.check_sampled_draft, NoQ())[1]
    for needle in ("NoQ", "surfaces_q", "SamplingParams.seed", "temperature"):
        assert needle in msg
    assert spec.ModelDraftsman.surfaces_q and not spec.ModelDraftsman.host_only


# ---------------------------------------------------------------------------
# decode(row_mask=) over a paged arena
# ---------------------------------------------------------------------------

MODELS = {"gpt": (JaxGPTConfig, JaxGPT, GPTConfig, GPTLMHeadModel),
          "llama": (JaxLlamaConfig, JaxLlama, LlamaConfig, LlamaLMHeadModel)}


@pytest.mark.parametrize("name", ["gpt", "llama"])
@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_row_mask_decode_matches_jax(name, cache):
    """Three slots verify 4 rows each over a paged arena of 4-row blocks
    and 3-block tables: a slot at depth 3, one at depth 1, and one at
    position 10 with depth 0, whose masked rows (11-13) lie past its
    table. The live rows' logits equal JAX's within 1e-5; the arena rows
    the live cells write agree with JAX's (fp32 within 1e-6; int8 code
    for code, scales at 1e-6); every other arena row keeps its bits, the
    table's last block included."""
    jcfg_cls, jcls, cfg_cls, cls = MODELS[name]
    jmodel = jcls(jcfg_cls.tiny())
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = cfg_cls.tiny()
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    bs, W, n_blocks, s = 4, 3, 10, 4
    dt = torch.int8 if cache == "int8" else None
    caches = init_kv_caches(model, n_blocks, bs, dt)
    gen = torch.Generator().manual_seed(3)
    for c in caches:                       # a live arena: non-zero rows
        if c.dtype == torch.int8:
            c.copy_(torch.randint(-127, 128, c.shape, generator=gen,
                                  dtype=torch.int8))
        else:
            c.copy_(torch.rand(c.shape, generator=gen) * 0.1)
    before = [c.clone() for c in caches]
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    pos = np.array([2, 5, 10], np.int64)
    depth = np.array([3, 1, 0])
    row_mask = np.arange(s)[None, :] <= depth[:, None]
    ids = np.random.default_rng(4).integers(1, cfg.vocab_size, (3, s))
    positions = pos[:, None] + np.arange(s)[None, :]

    got = decode(model, torch.from_numpy(ids), torch.from_numpy(positions),
                 caches, slot_mask=torch.ones(3, dtype=torch.bool),
                 block_tables=torch.from_numpy(tables),
                 row_mask=torch.from_numpy(row_mask))
    jcaches = tuple(jnp.asarray(b.numpy()) for b in before)
    want, jcaches = jax_generation.decode(
        jmodel, params, jnp.asarray(ids, jnp.int32),
        jnp.asarray(positions, jnp.int32), jcaches,
        slot_mask=jnp.ones(3, bool), block_tables=jnp.asarray(tables),
        row_mask=jnp.asarray(row_mask))
    want = np.asarray(want)
    for r in range(3):
        np.testing.assert_allclose(got[r, :depth[r] + 1].numpy(),
                                   want[r, :depth[r] + 1], atol=1e-5)
    written = np.zeros((n_blocks, bs), bool)
    for r in range(3):
        for i in range(depth[r] + 1):
            p = pos[r] + i
            written[tables[r, p // bs], p % bs] = True
    assert written.sum() == 7
    for c, b, j in zip(caches, before, jcaches):
        j = np.asarray(j)
        kept = ~written
        np.testing.assert_array_equal(c.numpy()[:, kept], b.numpy()[:, kept])
        np.testing.assert_array_equal(j[:, kept], b.numpy()[:, kept])
        if c.dtype == torch.int8:
            np.testing.assert_array_equal(c.numpy()[:, written],
                                          j[:, written])
        else:
            np.testing.assert_allclose(c.numpy()[:, written], j[:, written],
                                       rtol=1e-6, atol=1e-6)
    # without row_mask the port's clamped block index would overwrite the
    # live block 8 with slot 2's row 12
    plain = [b.clone() for b in before]
    decode(model, torch.from_numpy(ids), torch.from_numpy(positions), plain,
           slot_mask=torch.ones(3, dtype=torch.bool),
           block_tables=torch.from_numpy(tables))
    assert not torch.equal(plain[0][:, 8], before[0][:, 8])


def test_row_mask_needs_block_tables():
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    caches = init_kv_caches(model, 1, 8)
    with pytest.raises(ValueError, match="row_mask requires block_tables"):
        decode(model, torch.ones((1, 2), dtype=torch.long),
               torch.arange(2)[None], caches,
               row_mask=torch.ones((1, 2), dtype=torch.bool))
