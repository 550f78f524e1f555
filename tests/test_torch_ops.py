"""The port's ops against ``hetu_tpu``'s: each kernel's plain PyTorch
version (what the CUDA kernel is held to on the card) against the Pallas
kernel run in interpret mode, plus the plain ops around them.

Inputs are made with numpy from a seed and handed to both. Tolerance:
atol 1e-5 on out and lse (both sides are fp32 with sums in different
orders); fully masked rows must be exactly 0 and -1e30 on both sides.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.ops import activations as jax_act
from hetu_tpu.ops import normalization as jax_norm
from hetu_tpu.ops.attention import attention_with_lse as jax_attn_lse
from hetu_tpu.ops.flash_pallas import _flash_fwd
from hetu_tpu.ops.paged_pallas import (
    combine_attention_lse as jax_combine, paged_attention_pallas,
)
from hetu_tpu.serving.speculative import adjust_logits as jax_adjust

from hetu_tpu_torch.ops import (
    NEG_INF, attention_with_lse, combine_attention_lse, flash_attention_fwd,
    flash_attention_fwd_reference, gelu, layer_norm, paged_attention,
    paged_attention_reference,
)
from hetu_tpu_torch.serving.sampling import adjust_logits

torch.set_num_threads(2)

ATOL = 1e-5
NEG = np.float32(NEG_INF)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol)


# -- flash forward ------------------------------------------------------------

@pytest.mark.parametrize("causal,use_seg,hkv", [
    (True, True, 2), (True, False, 4), (False, True, 1)])
def test_attention_with_lse_matches_pallas_interpret(causal, use_seg, hkv):
    rng = np.random.default_rng(0)
    b, s, hq, d = 2, 12, 4, 16
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    # two documents then pads (-1), which attend each other
    seg = np.array([[0] * 5 + [1] * 4 + [-1] * 3,
                    [3] * 9 + [-1] * 3], np.int32) if use_seg else None
    want_o, want_l = jax_attn_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg),
        impl="pallas", interpret=True)
    got_o, got_l = attention_with_lse(
        _t(q), _t(k), _t(v), causal=causal,
        segment_ids=None if seg is None else _t(seg))
    assert got_o.shape == (b, s, hq, d) and got_l.shape == (b, hq, s)
    _close(got_o, want_o)
    _close(got_l, want_l)


def test_flash_fwd_offsets_and_fully_masked_rows():
    """Static causal offsets (kv_offset > q_offset leaves the first rows
    with no visible key): those rows are exactly 0 / -1e30 in both."""
    rng = np.random.default_rng(1)
    b, hq, hkv, sq, sk, d = 1, 4, 2, 8, 12, 16
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    kw = dict(causal=True, scale=0.25, q_offset=0, kv_offset=3)
    want_o, want_l = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), None, None,
                                interpret=True, **kw)
    got_o, got_l = flash_attention_fwd(_t(q), _t(k), _t(v), None, None, **kw)
    ref_o, ref_l = flash_attention_fwd_reference(_t(q), _t(k), _t(v), None,
                                                 None, **kw)
    _close(got_o, want_o)
    _close(got_l, want_l)
    assert torch.equal(got_o, ref_o) and torch.equal(got_l, ref_l)
    dead = slice(0, 3)                   # q positions 0..2 < first key 3
    assert np.all(np.asarray(got_o)[:, :, dead] == 0.0)
    assert np.all(np.asarray(got_l)[:, :, dead] == NEG)
    assert np.all(np.asarray(want_o)[:, :, dead] == 0.0)
    assert np.all(np.asarray(want_l)[:, :, dead] == NEG)


def test_flash_fwd_dropout_lane_matches_pallas_interpret():
    """The forward's dropout lane with GQA and static offsets: the mask
    hashes absolute positions, so the offsets shift it exactly as in the
    TPU kernel. Dropout scales only what meets v: the lse is the
    undropped one. Tolerance 2e-4 (the port multiplies by 1/(1-rate)
    where JAX divides by (1-rate))."""
    rng = np.random.default_rng(9)
    b, hq, hkv, sq, sk, d = 2, 4, 2, 8, 12, 16
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    kw = dict(causal=True, scale=0.25, q_offset=6, kv_offset=2)
    want_o, want_l = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), None, None, interpret=True,
                                dropout_rate=0.2, seed=77, **kw)
    got_o, got_l = flash_attention_fwd(_t(q), _t(k), _t(v), None, None,
                                       dropout_rate=0.2, seed=77, **kw)
    _close(got_o, want_o, atol=2e-4)
    _close(got_l, want_l, atol=2e-4)
    _, plain_l = flash_attention_fwd(_t(q), _t(k), _t(v), None, None, **kw)
    assert torch.equal(plain_l, got_l)
    with pytest.raises(ValueError, match="seed"):
        flash_attention_fwd(_t(q), _t(k), _t(v), None, None,
                            dropout_rate=0.2, **kw)


@pytest.mark.parametrize("seed", [77, 0xDEADBEEF])
def test_flash_seed_as_a_device_word_draws_the_same_mask(seed):
    """The kernels read the dropout seed from a device word: an int32
    word holding the seed's 32 bits (a uint32 above 2**31 wraps to a
    negative int32), a staged seed of a ``SeedTable`` and the int give
    the same outputs bit for bit, forward and backward, and the keep
    mask is ``dropout_keep_bh``'s."""
    from hetu_tpu_torch.ops.dropout import SeedTable, seed_word
    from hetu_tpu_torch.ops.flash import (
        dropout_keep_bh, flash_attention_bwd,
    )
    rng = np.random.default_rng(11)
    b, hq, hkv, s, d = 1, 4, 2, 12, 16
    q, k, v, do = (_t(rng.normal(size=shape).astype(np.float32))
                   for shape in ((b, hq, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d), (b, hq, s, d)))
    kw = dict(causal=True, scale=0.25, dropout_rate=0.3)
    word = seed_word(seed, "cpu")
    assert word.dtype == torch.int32 and word.shape == (1,)
    assert int(word) & 0xFFFFFFFF == seed
    table = SeedTable("cpu")
    staged = table.seed()
    table.stage(seed)
    assert int(table.word(staged.path)) & 0xFFFFFFFF == seed
    outs = [flash_attention_fwd(q, k, v, None, None, seed=x, **kw)
            for x in (seed, word, staged)]
    for o, lse in outs[1:]:
        assert torch.equal(o, outs[0][0]) and torch.equal(lse, outs[0][1])
    o, lse = outs[0]
    grads = [flash_attention_bwd(q, k, v, None, None, o, lse, do, seed=x,
                                 **kw) for x in (seed, word, staged)]
    for g in grads[1:]:
        assert all(torch.equal(a, c) for a, c in zip(g, grads[0]))
    keep = dropout_keep_bh(seed, b, hq, s, s, rate=0.3)
    assert torch.equal(keep, dropout_keep_bh(word, b, hq, s, s, rate=0.3))
    want = dropout_keep_bh(seed + 1, b, hq, s, s, rate=0.3)
    assert not torch.equal(keep, want)


# -- paged attention ----------------------------------------------------------

def _arena(rng, *, S=3, R=1, hq=4, hkv=2, d=16, n_blocks=9, bs=4, W=8):
    q = rng.normal(size=(S, R, hq, d)).astype(np.float32)
    k = rng.normal(size=(n_blocks, bs, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_blocks, bs, hkv, d)).astype(np.float32)
    tbl = np.zeros((S, W), np.int32)
    for s in range(S):
        # W - 1 live pages, the last lane padded with the null block
        tbl[s] = np.concatenate(
            [rng.permutation(np.arange(1, n_blocks))[:W - 1], [0]])
    return q, k, v, tbl


@pytest.mark.parametrize("R", [1, 3])
def test_paged_reference_matches_pallas_interpret(R):
    rng = np.random.default_rng(2 + R)
    q, k, v, tbl = _arena(rng, R=R)
    off = np.array([-1, 5, 17], np.int32)   # slot 0: empty history
    want_o, want_l = paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
        jnp.asarray(off), interpret=True, return_lse=True)
    got_o, got_l = paged_attention(_t(q), _t(k), _t(v), _t(tbl), _t(off),
                                   return_lse=True)
    ref_o, ref_l = paged_attention_reference(_t(q), _t(k), _t(v), _t(tbl),
                                             _t(off), return_lse=True)
    assert got_o.shape == (3, R, 4, 16) and got_l.shape == (3, 4, R)
    assert torch.equal(got_o, ref_o) and torch.equal(got_l, ref_l)
    _close(got_o, want_o)
    _close(got_l, want_l)
    # row 0 of slot 0 sits at position -1: it attends nothing
    for o, lse in ((got_o, got_l), (want_o, want_l)):
        assert np.all(np.asarray(o)[0, 0] == 0.0)
        assert np.all(np.asarray(lse)[0, :, 0] == NEG)


def test_paged_null_block_pad_lanes_stay_masked():
    """Poisoning the null block (which only pad lanes map) changes
    nothing: its lanes lie past every live position."""
    rng = np.random.default_rng(5)
    q, k, v, tbl = _arena(rng, R=2)
    off = np.array([3, 10, 25], np.int32)   # <= (W - 1) * bs - R
    base = paged_attention(_t(q), _t(k), _t(v), _t(tbl), _t(off))
    k2, v2 = k.copy(), v.copy()
    k2[0] += 1e3
    v2[0] += 1e3
    got = paged_attention(_t(q), _t(k2), _t(v2), _t(tbl), _t(off))
    assert torch.equal(got, base)
    want = paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2), jnp.asarray(tbl),
        jnp.asarray(off), interpret=True)
    _close(got, want)


# -- the plain ops around the kernels ----------------------------------------

def test_combine_attention_lse_matches_jax():
    rng = np.random.default_rng(6)
    o1, o2 = (rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.normal(size=(2, 4, 5)).astype(np.float32)
              for _ in range(2))
    l2[0, :, 1] = NEG                       # one side empty
    l1[1, :, 2] = NEG                       # both sides empty
    l2[1, :, 2] = NEG
    o1[1, 2] = 0.0
    o2[1, 2] = 0.0
    want = jax_combine(*(jnp.asarray(a) for a in (o1, l1, o2, l2)))
    got = combine_attention_lse(_t(o1), _t(l1), _t(o2), _t(l2))
    _close(got, want, atol=1e-6)
    assert np.all(np.asarray(got)[1, 2] == 0.0)


def test_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    sc = rng.normal(size=(32,)).astype(np.float32)
    bi = rng.normal(size=(32,)).astype(np.float32)
    _close(layer_norm(_t(x), _t(sc), _t(bi), eps=1e-5),
           jax_norm.layer_norm(jnp.asarray(x), jnp.asarray(sc),
                               jnp.asarray(bi), eps=1e-5), atol=1e-5)
    _close(gelu(_t(x)), jax_act.gelu(jnp.asarray(x)), atol=1e-6)
    _close(gelu(_t(x), approximate=False),
           jax_act.gelu(jnp.asarray(x), approximate=False), atol=1e-6)


def test_adjust_logits_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(5, 40)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 12, 1], np.int32)
    top_p = np.array([0.0, 0.0, 0.8, 0.9, 1.0], np.float32)
    want = np.asarray(jax_adjust(jnp.asarray(logits), jnp.asarray(temp),
                                 jnp.asarray(top_k), jnp.asarray(top_p)))
    got = adjust_logits(_t(logits), _t(temp), _t(top_k), _t(top_p)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
