"""The fp lanes of the port's paged kernel (#1) at bf16 against
``hetu_tpu``'s, and the fp32 plain version held bit for bit to the dense
oracle's formula.

The bf16 plain version is what the bf16 arena lane of
``csrc/paged_attention.cu`` is held to on the card. It rounds where the
TPU kernel rounds: q~ = q * scale to q's dtype (``paged_pallas.py:215``)
and p to v's dtype before p v (:148). Here it runs against
``paged_attention_pallas`` in interpret mode at bf16, on numpy inputs
from a seed.

Tolerance on out, element by element: 1 bf16 ulp of the reference's
magnitude (both round an fp32 sum taken in another order to bf16 once)
plus 1e-3 absolute (a p one fp32 ulp apart may round to the
neighbouring bf16 value before its product), as in
``tests/test_torch_flash_tc.py``. lse: 1e-4 (fp32 on both sides).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.ops.paged_pallas import paged_attention_pallas

from hetu_tpu_torch.ops import (
    NEG_INF, gather_block_rows, paged_attention, paged_attention_reference,
)
from hetu_tpu_torch.ops import paged as paged_mod

torch.set_num_threads(2)

ABS = 1e-3
LSE_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _arena(rng, *, S=3, R=1, hq=4, hkv=2, d=32, n_blocks=11, bs=4, W=8):
    """q (S, R, hq, d), an fp arena of ``n_blocks`` pages and per-slot
    tables of W - 1 live pages, the last lane padded with the null
    block."""
    q = rng.normal(size=(S, R, hq, d)).astype(np.float32)
    k = rng.normal(size=(n_blocks, bs, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_blocks, bs, hkv, d)).astype(np.float32)
    tbl = np.zeros((S, W), np.int32)
    for s in range(S):
        tbl[s] = np.concatenate(
            [rng.permutation(np.arange(1, n_blocks))[:W - 1], [0]])
    return q, k, v, tbl


@pytest.mark.parametrize("R", [1, 3])
def test_bf16_paged_plain_version_matches_pallas_interpret(R, monkeypatch):
    rng = np.random.default_rng(40 + R)
    q, k, v, tbl = _arena(rng, R=R)                     # GQA 2
    off = np.array([-1, 6, 24 - R], np.int32)           # slot 0: no history
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want_o, want_l = paged_attention_pallas(
        *bf, jnp.asarray(tbl), jnp.asarray(off), interpret=True,
        return_lse=True)
    want_o = np.asarray(jnp.asarray(want_o, jnp.float32), np.float64)
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got_o, got_l = paged_attention_reference(*tb, _t(tbl), _t(off),
                                             return_lse=True)
    assert got_o.dtype == torch.bfloat16 and got_l.dtype == torch.float32
    assert got_o.shape == (3, R, 4, 32) and got_l.shape == (3, 4, R)
    err = np.abs(got_o.double().numpy() - want_o)
    lim = _ulp(want_o) + ABS
    assert (err <= lim).all(), \
        f"max err {err.max()}, {(err / lim).max()} of the bound"
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=LSE_TOL, rtol=0)
    # on the CPU the wrapper is the plain version (a spy, since MKL's
    # products may round differently between two calls)
    calls = []

    def spy(*args, **kw):
        calls.append(args)
        return got_o, got_l

    monkeypatch.setattr(paged_mod, "paged_attention_reference", spy)
    same = paged_attention(*tb, _t(tbl), _t(off), return_lse=True)
    assert same[0] is got_o and same[1] is got_l
    assert len(calls) == 1 and all(a is b for a, b in zip(calls[0], tb))
    # row 0 of slot 0 sits at position -1: it attends nothing
    assert torch.all(got_o[0, 0] == 0)
    assert torch.all(got_l[0, :, 0] == NEG_INF)


def _paged_fp32_before(q, k, v, tbl, off, scale):
    """The fp32 plain version as it stood before the bf16 rounding point:
    the gathered table view through the dense oracle's formula."""
    k = gather_block_rows(k, tbl)
    v = gather_block_rows(v, tbl)
    S, R, hq, _ = q.shape
    L = k.shape[1]
    k = k.repeat_interleave(hq // k.shape[2], dim=-2)
    v = v.repeat_interleave(hq // v.shape[2], dim=-2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    qpos = torch.arange(R)[None, :, None] + off.reshape(-1, 1, 1)
    kpos = torch.arange(L)[None, None, :] + torch.zeros(1, 1, 1,
                                                        dtype=torch.long)
    mask = torch.ones((S, 1, R, L), dtype=torch.bool) & (qpos >= kpos)[:, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.where(mask, torch.exp(logits - lse[..., None]),
                        torch.zeros_like(logits))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()), lse


@pytest.mark.parametrize("R", [1, 3])
def test_fp32_paged_plain_version_bit_identical_to_before(R):
    rng = np.random.default_rng(50 + R)
    q, k, v, tbl = _arena(rng, R=R, hq=6, hkv=3, d=16)
    off = np.array([-1, 9, 27 - R], np.int32)
    args = (_t(q), _t(k), _t(v), _t(tbl), _t(off))
    for scale in (None, 0.3):
        out, lse = paged_attention_reference(*args, scale=scale,
                                             return_lse=True)
        want_o, want_l = _paged_fp32_before(
            *args, 16 ** -0.5 if scale is None else scale)
        assert out.dtype == torch.float32
        assert torch.equal(out, want_o) and torch.equal(lse, want_l)
