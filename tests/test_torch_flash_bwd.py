"""The port's flash backward and dropout lane against ``hetu_tpu``'s.

The plain versions (what the CUDA kernels are held to on the card) run
against the Pallas kernels in interpret mode on numpy inputs from a seed.
Tolerances: 5e-5 on grads without dropout (fp32 on both sides, sums in
other orders; as ``tests/test_flash_pallas.py:62``), 2e-4 with dropout
(the port scales kept probabilities by 1/(1-rate), JAX divides by
(1-rate); as ``tests/test_flash_pallas.py:210``). The keep mask itself
must be bit-identical.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.ops.flash_pallas import (
    _flash_bwd, _flash_fwd, dropout_keep_bh as jax_keep_bh,
)

from hetu_tpu_torch.ops import (
    attention_reference, dropout_keep, dropout_keep_bh, flash_attention,
    flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
)

torch.set_num_threads(2)

ATOL = 5e-5
ATOL_DROP = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=atol)


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    do = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    return q, k, v, do


SEG = np.array([[0] * 6 + [1] * 7 + [-1] * 3,
                [2] * 11 + [-1] * 5], np.int32)


@pytest.mark.parametrize("causal,hkv,seg,kv_offset,external_delta", [
    (True, 4, None, 0, False),
    (True, 2, SEG, 0, False),
    (False, 2, SEG, 0, False),
    (True, 4, None, 3, True),      # q rows 0..2 see no key
])
def test_flash_bwd_reference_matches_pallas_interpret(
        causal, hkv, seg, kv_offset, external_delta):
    q, k, v, do = _inputs(10 + hkv + kv_offset, 2, 4, hkv, 16, 16)
    kw = dict(causal=causal, scale=0.3, q_offset=0, kv_offset=kv_offset)
    jseg = None if seg is None else jnp.asarray(seg)
    out, lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jseg, jseg, interpret=True, **kw)
    out, lse = np.asarray(out), np.asarray(lse)
    delta = None
    if external_delta:        # what a ring hop would pass: any (b, hq, sq)
        delta = np.random.default_rng(3).normal(
            size=lse.shape).astype(np.float32)
    want = _flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg,
                      jseg, jnp.asarray(out), jnp.asarray(lse),
                      jnp.asarray(do), interpret=True,
                      delta=None if delta is None else jnp.asarray(delta),
                      **kw)
    tseg = None if seg is None else _t(seg)
    got = flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), tseg, tseg, _t(out), _t(lse), _t(do),
        delta=None if delta is None else _t(delta), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, ATOL)
    # the CPU wrapper is the plain version
    same = flash_attention_bwd(
        _t(q), _t(k), _t(v), tseg, tseg, _t(out), _t(lse), _t(do),
        delta=None if delta is None else _t(delta), **kw)
    assert all(torch.equal(a, b) for a, b in zip(same, got))
    if kv_offset:             # rows with no key get exactly zero dq
        assert torch.all(got[0][:, :, :kv_offset] == 0)


@pytest.mark.parametrize("seed,rate", [(1234, 0.1), (-7, 0.5), (0, 0.9)])
def test_dropout_keep_twins_bit_identical_to_jax(seed, rate):
    want = np.asarray(jax_keep_bh(jnp.int32(seed), 2, 3, 24, 40, rate=rate))
    got = dropout_keep_bh(seed, 2, 3, 24, 40, rate=rate)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # the mask is addressed by absolute position: any tiling, and any
    # offset that moves the origin, reads the same stream
    shifted = dropout_keep_bh(seed, 2, 3, 16, 24, rate=rate, q_offset=8,
                              kv_offset=16)
    np.testing.assert_array_equal(shifted.numpy(), want[:, :, 8:, 16:])
    for bq, bk in ((8, 8), (24, 5)):
        for iq in range(24 // bq):
            for ik in range(40 // bk):
                tile = dropout_keep(seed, 1, 2, iq, ik, rate=rate,
                                    block_q=bq, block_k=bk)
                np.testing.assert_array_equal(
                    tile.numpy(),
                    want[1, 2, iq * bq:(iq + 1) * bq, ik * bk:(ik + 1) * bk])


@pytest.mark.parametrize("hkv,causal", [(2, True), (4, False)])
def test_flash_dropout_fwd_bwd_match_pallas_interpret(hkv, causal):
    rate, seed = 0.1, 1234
    q, k, v, do = _inputs(20 + hkv, 2, 4, hkv, 16, 16)
    kw = dict(causal=causal, scale=0.25, q_offset=0, kv_offset=0)
    drop = dict(dropout_rate=rate, seed=seed)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None)
    want_o, want_l = _flash_fwd(*jargs, interpret=True, **kw, **drop)
    got_o, got_l = flash_attention_fwd(_t(q), _t(k), _t(v), None, None,
                                       **kw, **drop)
    _close(got_o, want_o, ATOL_DROP)
    _close(got_l, want_l, ATOL_DROP)
    want = _flash_bwd(*jargs, want_o, want_l, jnp.asarray(do),
                      interpret=True, **kw, **drop)
    got = flash_attention_bwd(_t(q), _t(k), _t(v), None, None, got_o, got_l,
                              _t(do), **kw, **drop)
    for g, w in zip(got, want):
        _close(g, w, ATOL_DROP)
    # without the seed's mask the values differ: the lane is really on
    plain = flash_attention_fwd(_t(q), _t(k), _t(v), None, None, **kw)[0]
    assert not torch.allclose(plain, got_o, atol=1e-3)


def test_flash_attention_grads_match_autograd_through_reference():
    """The differentiable op (custom forward and backward) on CPU gives
    the grads that autograd takes through the plain attention."""
    rng = np.random.default_rng(30)
    b, s, hq, hkv, d = 2, 16, 4, 2, 16
    arrays = [rng.normal(size=(b, s, h, d)).astype(np.float32)
              for h in (hq, hkv, hkv)]
    seg = _t(SEG)
    g = _t(rng.normal(size=(b, s, hq, d)).astype(np.float32))
    grads = []
    for fn in (flash_attention, attention_reference):
        q, k, v = (_t(a).requires_grad_() for a in arrays)
        out = fn(q, k, v, causal=True, segment_ids=seg, scale=0.3)
        out.backward(g)
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    for a, b_ in zip(*grads):
        _close(a, b_, 1e-5)
