"""The numerics of #2's fp32 tensor-core lane (``flash_fwd_tf32x3_kernel``
in ``csrc/flash_fwd.cu``) against ``hetu_tpu``'s forward.

The kernel runs only on the card. Here a plain-torch model of its
arithmetic runs instead: operands rounded to tf32 by bit operations as
``cvt.rna`` rounds them (to nearest, ties away from zero), each split
into hi and lo, every product taken as lo_a hi_b + hi_a lo_b + hi_a hi_b
one 8-wide k-step at a time (the m16n8k8 product), the small terms
first, S's terms in the kernel's accumulator chains (``kTfSChains``);
the online softmax over each warp's key slices in the kernel's order
(``TfGrid``: tiles of ``kKeys`` keys, each split ``kWarpsK`` ways), the
slices' states merged at the end; both read from the source. The model
runs at GPT-2's packed-prefill shape (1, 12, 64, 64) and at a narrowed
Llama pack (4 heads, d = 128, 256 tokens, the pack's segments), on numpy
inputs from a seed, against ``_flash_fwd`` in interpret mode at fp32.

Tolerance: ``TF32X3_TOL`` = 1e-5 on out and lse, a tenth of the card's
fp32 bound ``TOL[float32]`` = 1e-4: the split drops terms of about
2^-22 of each product, and both sides sum fp32 in other orders. The same
model with hi hi alone (plain TF32, 2^-11 of each product) is printed
beside it and lies past the card's bound: the split is what makes the
lane fp32.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.ops.flash_pallas import _flash_fwd

from hetu_tpu_torch.ops import NEG_INF, flash_attention_fwd_reference

torch.set_num_threads(2)

TF32X3_TOL = 1e-5
CARD_TOL = 1e-4          # chip_smoke.py TOL[torch.float32]
CSRC = Path(__file__).resolve().parents[1] / "hetu_tpu_torch" / "csrc"


def tf_grid() -> dict:
    """``{head_dim: (kWarpsQ, kWarpsK, kKeys)}`` of the lane, from the
    source."""
    text = (CSRC / "flash_fwd.cu").read_text()
    found = re.findall(r"template <> struct TfGrid<(\d+)> \{ static "
                       r"constexpr int kWarpsQ = (\d+), kWarpsK = (\d+), "
                       r"kKeys = (\d+); \};", text)
    return {int(d): tuple(map(int, rest)) for d, *rest in found}


def s_chains() -> int:
    """S's accumulator chains in the lane (``kTfSChains``)."""
    text = (CSRC / "flash_fwd.cu").read_text()
    return int(re.search(r"constexpr int kTfSChains = (\d+);", text)[1])


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32``: 10 mantissa
    bits, to nearest, ties away from zero (adding half of the dropped
    range to the magnitude's bits carries a tie up)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_tf32(a, b, passes: int = 3, chains: int = 1):
    """``a @ b`` (fp32, k innermost of a) as the lane takes it: k-steps of
    8, each adding lo_a hi_b, then hi_a lo_b, then hi_a hi_b to fp32
    accumulators (``passes=1``: hi_a hi_b alone): one, or with ``chains``
    2 the small terms and hi hi in two, or with 4 each of those by k-step
    parity, summed as (small) + (big) at the end."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = [torch.zeros(*a.shape[:-1], b.shape[-1]) for _ in range(chains)]
    big = 0 if chains == 1 else 1
    for kk, k0 in enumerate(range(0, a.shape[-1], 8)):
        ks = slice(k0, k0 + 8)
        c0 = 2 * (kk & 1) if chains == 4 else 0
        terms = [(ah, bh, c0 + big)] if passes == 1 else \
            [(al, bh, c0), (ah, bl, c0), (ah, bh, c0 + big)]
        for x, y, c in terms:
            acc[c] = acc[c] + x[..., ks] @ y[..., ks, :]
    if chains == 1:
        return acc[0]
    if chains == 2:
        return acc[0] + acc[1]
    return (acc[0] + acc[2]) + (acc[1] + acc[3])


def tf32x3_fwd(q, k, v, seg, *, causal, scale, passes=3):
    """The lane's forward in plain torch: out, lse."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _, warps_k, keys = tf_grid()[d]
    kw = keys // warps_k
    kf = k.repeat_interleave(hq // hkv, dim=1)
    vf = v.repeat_interleave(hq // hkv, dim=1)
    s = mm_tf32(q * scale, kf.transpose(-1, -2), passes, s_chains())
    qi = torch.arange(sq)[:, None]
    ki = torch.arange(sk)[None, :]
    mask = ((qi >= ki) if causal else torch.ones(sq, sk, dtype=torch.bool)
            )[None, None]
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    s = torch.where(mask, s, torch.full((), NEG_INF))
    states = []
    for wk in range(warps_k):                   # the warps' key slices
        m = torch.full((b, hq, sq, 1), -torch.inf)
        l = torch.zeros(b, hq, sq, 1)
        o = torch.zeros(b, hq, sq, d)
        for k0 in range(wk * kw, sk, keys):     # this slice of each tile
            cols = slice(k0, min(k0 + kw, sk))
            sc, live = s[..., cols], mask[..., cols]
            mx = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - mx)
            p = torch.where(live, torch.exp(sc - mx), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + mm_tf32(p, vf[..., cols, :], passes)
            m = mx
        states.append((m, l, o))
    big = torch.stack([m for m, _, _ in states]).amax(0)
    lt = torch.zeros_like(big)
    ot = torch.zeros(b, hq, sq, d)
    for m, l, o in states:                      # the merge
        f = torch.where(m == -torch.inf, 0.0, torch.exp(m - big))
        lt = lt + f * l
        ot = ot + f * o
    out = ot / torch.where(lt == 0, 1.0, lt)
    lse = torch.where(lt == 0, NEG_INF, big + torch.log(lt))[..., 0]
    return out, lse


def _pack_seg(runs, s):
    """Segment ids of a packed chunk: each run's slot, -1 on pads."""
    ids = np.full(s, -1, np.int32)
    at = 0
    for slot, n in runs:
        ids[at:at + n] = slot
        at += n
    return ids


# (b, hq, hkv, s, d, the pack's (slot, tokens) runs): GPT-2's packed
# prefill chunk (chip_smoke.py PACK) and a narrowed Llama pack
# (LLAMA_PACK, 256 tokens, 4 of its 32 heads)
SHAPES = {
    "gpt2_pack": (1, 12, 12, 64, 64, ((3, 20), (7, 9), (0, 30))),
    "llama_pack_narrow": (1, 4, 4, 256, 128, ((3, 100), (7, 60), (0, 80))),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_tf32x3_model_matches_pallas_interpret_at_fp32(name, capsys):
    b, hq, hkv, s, d, runs = SHAPES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    seg = np.stack([_pack_seg(runs, s)] * b)
    kw = dict(causal=True, scale=d ** -0.5)
    want_o, want_l = _flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                                jnp.asarray(seg), jnp.asarray(seg),
                                interpret=True, **kw)
    want_o, want_l = np.asarray(want_o), np.asarray(want_l)
    tq, tk, tv, tseg = map(torch.from_numpy, (q, k, v, seg))

    errs = {}
    for passes in (3, 1):
        out, lse = tf32x3_fwd(tq, tk, tv, tseg, passes=passes, **kw)
        errs[passes] = (float(np.abs(out.numpy() - want_o).max()),
                        float(np.abs(lse.numpy() - want_l).max()))
    plain = flash_attention_fwd_reference(tq, tk, tv, tseg, tseg, **kw)
    plain_err = max(float(np.abs(plain[0].numpy() - want_o).max()),
                    float(np.abs(plain[1].numpy() - want_l).max()))
    with capsys.disabled():
        print(f"\n{name}: max |err| (out, lse) against Pallas interpret "
              f"fp32: 3xTF32 {errs[3]}, 1xTF32 {errs[1]}, plain fp32 "
              f"{plain_err}")
    assert max(errs[3]) <= TF32X3_TOL, errs
    # plain TF32 misses the card's fp32 bound: the split is needed
    assert max(errs[1]) > CARD_TOL, errs
    # pad rows (-1) attend each other; no row is fully masked here
    assert np.isfinite(want_l).all()


def test_tf32_rounding_is_to_nearest_ties_away():
    """``tf32`` against exact cases: a tie (half of the dropped 13 bits)
    rounds away from zero on both signs, below and above it to nearest,
    and a carry into the exponent is right."""
    one = 0x3F800000
    cases = {one + 0x1000: one + 0x2000,          # a tie, up
             one + 0x0FFF: one,                   # below it
             one + 0x1001: one + 0x2000,
             one + 0x2000 + 0x1000: one + 0x4000,  # a tie on an odd hi
             0x3FFFF000: 0x40000000}              # carry into the exponent
    bits = torch.tensor(list(cases), dtype=torch.int32)
    want = torch.tensor(list(cases.values()), dtype=torch.int32)
    for sign in (1.0, -1.0):
        x = bits.view(torch.float32) * sign
        assert torch.equal(tf32(x), want.view(torch.float32) * sign)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096)
                         .astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros(4096, dtype=torch.int32))
    # hi + lo keeps about 22 bits of x
    assert float(((hi + lo - x).abs() / x.abs()).max()) < 2.0 ** -21


def test_tf_grid_is_read_from_the_source():
    """Every head_dim the fp32 lane takes has a grid, each warp's key
    slice holds whole 8-key k-steps, and S's chains are 1, 2 or 4."""
    assert s_chains() in (1, 2, 4)
    grid = tf_grid()
    assert sorted(grid) == [64, 128]
    for warps_q, warps_k, keys in grid.values():
        assert warps_q * warps_k <= 4
        assert keys % (8 * warps_k) == 0 and keys // warps_k <= 64
