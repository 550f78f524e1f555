"""The port's fused LM-head CE (``hetu_tpu_torch/ops/fused_ce.py``) against
``hetu_tpu``'s Pallas kernels in interpret mode, as
``tests/test_fused_ce.py`` runs them (``block_n=128, block_v=256``).

Inputs are made with numpy from a seed and handed to both; the vocab
(1013) is not a multiple of any tile, some labels are -1 (a token outside
this weight: ``tgt = 0``), and the backward takes random general
``(glse, gtgt)`` cotangents through ``jax.vjp``. h is fp32 or bf16 and w
fp32 or bf16, in all four pairings. Tolerances:
- lse/tgt: 1e-4 absolute (fp32 sums in other orders; a bf16 product is
  exact in fp32 on both sides);
- dh/dw in fp32: 1e-5 of the largest |reference| (summation order), or
  2e-3 when h is bf16 (the dlogits tile is rounded to bf16 on both
  sides, and a last-bit difference of s can flip that rounding);
- dh/dw in bf16: 1e-2 of the largest |reference| (one bf16 rounding of
  the output, about 0.4% relative, plus the above).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.ops.fused_ce_pallas import fused_lm_ce as jax_fused_lm_ce
from hetu_tpu.ops.fused_ce_pallas import fused_lse_tgt as jax_fused_lse_tgt

from hetu_tpu_torch.ops import cross_entropy_mean, fused_ce
from hetu_tpu_torch.ops.fused_ce import (
    fused_ce_dh, fused_ce_dw, fused_ce_fwd, fused_lm_ce,
)

torch.set_num_threads(2)

N, E, V = 256, 64, 1013
DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
PAIRS = [(hd, wd) for hd in DTYPES for wd in DTYPES]


def _data(h_dt, w_dt, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, E)).astype(np.float32)
    w = (rng.normal(size=(V, E)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[::7] = -1
    labels[3] = V - 1                      # the last, ragged tile's column
    jh = jnp.asarray(h, DTYPES[h_dt][1])
    jw = jnp.asarray(w, DTYPES[w_dt][1])
    # the port gets the values JAX holds (rounded once to bf16 where bf16)
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(
        DTYPES[h_dt][2])
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        DTYPES[w_dt][2])
    return jh, jw, th, tw, labels


def _np(t):
    return t.float().numpy()


def _jax_lse_tgt(h, w, labels):
    return jax_fused_lse_tgt(h, w, jnp.asarray(labels), 128, 256, True)


@pytest.mark.parametrize("h_dt,w_dt", PAIRS)
def test_forward_lse_tgt_matches_pallas_interpret(h_dt, w_dt):
    jh, jw, th, tw, labels = _data(h_dt, w_dt)
    jlse, jtgt = _jax_lse_tgt(jh, jw, labels)
    lse, tgt = fused_ce_fwd(th, tw, torch.from_numpy(labels))
    assert lse.dtype == tgt.dtype == torch.float32
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), atol=1e-4)
    np.testing.assert_allclose(_np(tgt), np.asarray(jtgt), atol=1e-4)
    assert bool((tgt[torch.from_numpy(labels) == -1] == 0).all())


def _tol(out_dtype, h_dt):
    if out_dtype == torch.bfloat16:
        return 1e-2
    return 2e-3 if h_dt == "bf16" else 1e-5


@pytest.mark.parametrize("h_dt,w_dt", PAIRS)
def test_backward_general_cotangents_match_pallas_interpret(h_dt, w_dt):
    jh, jw, th, tw, labels = _data(h_dt, w_dt, seed=1)
    rng = np.random.default_rng(2)
    glse = rng.normal(size=N).astype(np.float32)
    gtgt = rng.normal(size=N).astype(np.float32)
    (jlse, _), vjp = jax.vjp(lambda h, w: _jax_lse_tgt(h, w, labels), jh, jw)
    jdh, jdw = vjp((jnp.asarray(glse), jnp.asarray(gtgt)))
    tl = torch.from_numpy(labels)
    lse = torch.from_numpy(np.array(jlse))
    args = (th, tw, tl, lse, torch.from_numpy(glse), torch.from_numpy(gtgt))
    dh, dw = fused_ce_dh(*args), fused_ce_dw(*args)
    assert dh.dtype == th.dtype and dw.dtype == tw.dtype
    for name, got, want in (("dh", dh, jdh), ("dw", dw, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(_np(got) - want).max()
        bound = _tol(got.dtype, h_dt) * np.abs(want).max()
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("h_dt,w_dt", [("fp32", "fp32"), ("bf16", "fp32"),
                                       ("bf16", "bf16")])
def test_fused_lm_ce_ignore_index_value_and_grads_match_jax(h_dt, w_dt):
    """(B, S) = (2, 100): 200 tokens, not a multiple of JAX's token block
    (its wrapper pads; the port's kernels mask in place); some labels
    are ``ignore_index``."""
    jh, jw, th, tw, labels = _data(h_dt, w_dt, seed=3)
    y = np.abs(labels[:200]).reshape(2, 100)
    y[0, :9] = -100
    y[1, 50:55] = -100
    hs = (lambda a: a[:200].reshape(2, 100, E))
    jloss, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: jax_fused_lm_ce(hs(h), w, jnp.asarray(y), block_n=128,
                                     block_v=256, interpret=True),
        argnums=(0, 1))(jh, jw)
    th = th.clone().requires_grad_()
    tw = tw.clone().requires_grad_()
    loss = fused_lm_ce(hs(th), tw, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for name, got, want in (("dh", th.grad, jdh), ("dw", tw.grad, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(_np(got) - want).max()
        bound = _tol(got.dtype, h_dt) * np.abs(want).max()
        assert err <= bound, (name, err, bound)
    # ignored tokens give zero grads
    assert float(th.grad[:9].abs().max()) == 0.0


def test_custom_op_grads_equal_autograd_through_dense_logits():
    """fp32: the op's backward (kernels #6/#7's plain versions) against
    autograd through the full logits and ``cross_entropy_mean``, 1e-5."""
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.normal(size=(3, 40, E)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(V, E)) * 0.3).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, V, (3, 40)))
    y[2, :11] = -100
    grads = []
    for fn in (lambda h, w: fused_lm_ce(h, w, y),
               lambda h, w: cross_entropy_mean(h @ w.t(), y)):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        loss = fn(hh, ww)
        loss.backward()
        grads.append((float(loss.detach()), hh.grad, ww.grad))
    (l0, dh0, dw0), (l1, dh1, dw1) = grads
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    np.testing.assert_allclose(dh0.numpy(), dh1.numpy(), atol=1e-5)
    np.testing.assert_allclose(dw0.numpy(), dw1.numpy(), atol=1e-5)


def test_plain_versions_block_the_vocab(monkeypatch):
    """The plain versions' answer does not depend on their vocab block
    (1013 columns in blocks of 100 against one block), to 1e-5."""
    _, _, th, tw, labels = _data("fp32", "fp32", seed=5)
    tl = torch.from_numpy(labels)
    whole = fused_ce_fwd(th, tw, tl)
    g = torch.ones(N)
    whole_d = (fused_ce_dh(th, tw, tl, whole[0], g, -g),
               fused_ce_dw(th, tw, tl, whole[0], g, -g))
    monkeypatch.setattr(fused_ce, "PLAIN_BLOCK_V", 100)
    blocked = fused_ce_fwd(th, tw, tl)
    blocked_d = (fused_ce_dh(th, tw, tl, whole[0], g, -g),
                 fused_ce_dw(th, tw, tl, whole[0], g, -g))
    for a, b in zip(whole + whole_d, blocked + blocked_d):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the CPU a wrapper launches or raises: a meta tensor (no
    kernel, no plain version) and a width the kernels do not take are
    refused before any build."""
    h = torch.empty(8, E, device="meta")
    w = torch.empty(V, E, device="meta")
    lab = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ce_fwd(h, w, lab)
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_ce._check("fused_ce_fwd", torch.empty(8, 96, device="meta"),
                        torch.empty(V, 96, device="meta"), lab)
