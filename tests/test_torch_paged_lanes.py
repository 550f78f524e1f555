"""The lanes of the port's paged kernel (#1): the run-shared form of the
packed prefill's history (``row_slot``) and the split-KV decode lane's
arithmetic, on the CPU, against ``hetu_tpu``'s ``paged_attention_pallas``
in interpret mode.

On the CPU the wrapper runs the plain version, which for a ``row_slot``
call is that of the per-row tables ``block_tables[row_slot]``: the two
forms must agree bit for bit, and both must match the TPU kernel run on
the per-row tables, as ``hetu_tpu``'s packed prefill calls it. The pack
has a run that straddles a 64-row tile (the tensor-core tile lane's
rows), a run at offset -1 (a new prompt), pads, and two runs of one
prefix-sharing prompt (two slots whose tables share their first pages).

The split-KV decode lane computes each split of ``SPLIT`` keys on its
own (normalised out, lse) and combines a row's splits as
``combine_attention_lse`` does; that plain computation must equal the
one-pass plain version.

Tolerances on out, element by element: fp32 1e-5 (sums in other
orders); bf16 q (the bf16 arena, and bf16 q over the int8 arena) 1 bf16
ulp of the reference's magnitude plus 1e-3, lse 1e-4, as
``tests/test_torch_paged_rounding.py``; the split-then-combine
computation 1e-6 (fp32, the same sums regrouped).
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.ops.paged_pallas import paged_attention_pallas

from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.ops import (
    NEG_INF, combine_attention_lse, paged_attention,
    paged_attention_reference, paged_lane, quantize_int8,
)
from hetu_tpu_torch.ops import paged as paged_mod
from hetu_tpu_torch.serving import SamplingParams, ServingEngine

torch.set_num_threads(2)

BS, W = 16, 8
FP32_TOL = 1e-5
BF16_ABS = 1e-3
LSE_TOL = 1e-4
SPLIT_TOL = 1e-6
#: the engine's slots and the pack: (slot, tokens, chunk start) per run;
#: slot 5 repeats slot 3's prompt, whose first two pages it shares
SLOTS = 6
PACK = ((3, 50, 40), (1, 20, 0), (5, 6, 32))
C = 80                                      # then 4 pad tokens


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _pack_case(rng, *, hq, hkv, d, arena):
    """q (C, 1, hq, d) of the pack's history rows, the arena, the
    engine's (SLOTS, W) tables, each row's slot and offset (hist - 1;
    pads: slot 0 at -1)."""
    n_blocks = 1 + SLOTS * W
    q = rng.normal(size=(C, 1, hq, d)).astype(np.float32)
    k = rng.normal(size=(n_blocks, BS, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_blocks, BS, hkv, d)).astype(np.float32)
    tables = np.zeros((SLOTS, W), np.int32)
    pages = rng.permutation(np.arange(1, n_blocks))
    for s in range(SLOTS):
        tables[s, :W - 1] = pages[s * (W - 1):(s + 1) * (W - 1)]
    tables[5, :2] = tables[3, :2]           # the shared prefix's pages
    slot, off = [], []
    for s, n, start in PACK:
        slot += [s] * n
        off += [start - 1] * n
    slot += [0] * (C - len(slot))
    off += [-1] * (C - len(off))
    case = dict(q=q, k=k, v=v, tables=tables,
                slot=np.asarray(slot, np.int32), off=np.asarray(off, np.int32))
    if arena == "int8":
        for name in ("k", "v"):
            codes, scale = (a.numpy() for a in quantize_int8(_t(case[name])))
            case[name], case[f"{name}_scale"] = codes, scale
    return case


def _torch_args(case, q_dtype, arena):
    q = _t(case["q"]).to(q_dtype)
    kv = [_t(case[n]) for n in ("k", "v")]
    if arena == "bf16":
        kv = [x.to(torch.bfloat16) for x in kv]
    scales = {}
    if arena == "int8":
        scales = dict(k_scale=_t(case["k_scale"]),
                      v_scale=_t(case["v_scale"]))
    return q, kv, scales


ARENAS = [("fp32", torch.float32), ("bf16", torch.bfloat16),
          ("int8", torch.float32), ("int8", torch.bfloat16)]
SHAPES = [dict(hq=4, hkv=4, d=64), dict(hq=4, hkv=2, d=128)]


def _id(p):
    return f"{p[0]}-{str(p[1]).split('.')[1]}"


@pytest.mark.parametrize("shape", SHAPES, ids=["hkv4_d64", "hkv2_d128"])
@pytest.mark.parametrize("arena", ARENAS, ids=_id)
def test_run_shared_form_matches_per_row_tables_and_pallas(arena, shape):
    kind, q_dtype = arena
    rng = np.random.default_rng(80 + shape["d"] + shape["hkv"])
    case = _pack_case(rng, arena=kind, **shape)
    q, (k, v), scales = _torch_args(case, q_dtype, kind)
    tables, slot, off = (_t(case[n]) for n in ("tables", "slot", "off"))
    shared = paged_attention(q, k, v, tables, off, row_slot=slot,
                             return_lse=True, **scales)
    per_row = paged_attention(q, k, v, tables[slot.long()], off,
                              return_lse=True, **scales)
    assert all(torch.equal(a, b) for a, b in zip(shared, per_row))
    got_o, got_l = shared
    assert got_o.dtype == q_dtype and got_o.shape == q.shape
    assert got_l.shape == (C, shape["hq"], 1)

    jdt = jnp.bfloat16 if q_dtype == torch.bfloat16 else jnp.float32
    jkv = [jnp.asarray(case[n]) for n in ("k", "v")]
    if kind == "bf16":
        jkv = [x.astype(jnp.bfloat16) for x in jkv]
    jscales = {n: jnp.asarray(case[n]) for n in ("k_scale", "v_scale")
               if n in case}
    want_o, want_l = paged_attention_pallas(
        jnp.asarray(case["q"]).astype(jdt), *jkv,
        jnp.asarray(case["tables"][case["slot"]]), jnp.asarray(case["off"]),
        interpret=True, return_lse=True, **jscales)
    want_o = np.asarray(jnp.asarray(want_o, jnp.float32), np.float64)
    err = np.abs(got_o.double().numpy() - want_o)
    if q_dtype == torch.float32:
        assert err.max() <= FP32_TOL, err.max()
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                   atol=FP32_TOL, rtol=0)
    else:
        lim = _ulp(want_o) + BF16_ABS
        assert (err <= lim).all(), \
            f"max err {err.max()}, {(err / lim).max()} of the bound"
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                   atol=LSE_TOL, rtol=0)
    # offset -1 (the new prompt's run, the pads): exact 0 and -1e30
    dead = case["off"] < 0
    assert dead.sum() == 24
    assert torch.all(got_o[_t(dead)] == 0)
    assert torch.all(got_l[_t(dead)] == NEG_INF)


def _split_then_combine(q, k, v, tables, off, split):
    """The split-KV lane's arithmetic in plain ops: each split of
    ``split`` keys (a multiple of the page) attended on its own through
    its slice of the tables, at offset ``off - start`` (a row before the
    split sees none of it: out 0, lse -1e30), then the splits combined
    as ``combine_attention_lse`` combines two: m = max lse, w = exp(lse -
    m), out = sum of out * w / sum w, lse = m + log sum w."""
    per = split // BS
    parts = []
    for start in range(0, tables.shape[1] * BS, split):
        sub = tables[:, start // BS:start // BS + per].contiguous()
        parts.append(paged_attention_reference(
            q, k, v, sub, off - start, return_lse=True))
    lses = torch.stack([lse for _, lse in parts])
    m = lses.max(dim=0).values
    w = torch.exp(lses - m)
    den = w.sum(dim=0)
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    out = sum(o * (wi / den).movedim(1, 2)[..., None]
              for (o, _), wi in zip(parts, w))
    return out, m + torch.log(den)


@pytest.mark.parametrize("split", [16, 32])
@pytest.mark.parametrize("shape", SHAPES, ids=["hkv4_d64", "hkv2_d128"])
def test_split_kv_arithmetic_equals_the_plain_version(shape, split):
    rng = np.random.default_rng(90 + split + shape["d"])
    hq, hkv, d = shape["hq"], shape["hkv"], shape["d"]
    S = 5
    n_blocks = 1 + S * W
    q = _t(rng.normal(size=(S, 1, hq, d)).astype(np.float32))
    k = _t(rng.normal(size=(n_blocks, BS, hkv, d)).astype(np.float32))
    v = _t(rng.normal(size=(n_blocks, BS, hkv, d)).astype(np.float32))
    tables = _t(rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
                .reshape(S, W))
    # a fully empty row, one key, a split boundary, a row whose later
    # splits are all empty, the whole table
    off = _t(np.array([-1, 0, split - 1, 40, W * BS - 1], np.int32))
    want_o, want_l = paged_attention_reference(q, k, v, tables, off,
                                               return_lse=True)
    got_o, got_l = _split_then_combine(q, k, v, tables, off, split)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(),
                               atol=SPLIT_TOL, rtol=0)
    np.testing.assert_allclose(got_l.numpy(), want_l.numpy(),
                               atol=SPLIT_TOL, rtol=0)
    assert torch.all(got_o[0] == 0) and torch.all(got_l[0] == NEG_INF)
    # combine_attention_lse folding the splits two at a time agrees
    per = split // BS
    fold_o = fold_l = None
    for start in range(0, W * BS, split):
        o, lse = paged_attention_reference(
            q, k, v, tables[:, start // BS:start // BS + per].contiguous(),
            off - start, return_lse=True)
        if fold_o is None:
            fold_o, fold_l = o, lse
            continue
        fold_o = combine_attention_lse(fold_o, fold_l, o, lse)
        fold_l = torch.logaddexp(fold_l, lse)
    np.testing.assert_allclose(fold_o.numpy(), want_o.numpy(),
                               atol=SPLIT_TOL, rtol=0)


@pytest.mark.parametrize("dtype,d,rows,shared,lane", [
    (torch.float32, 64, 1, False, "split_kv"),      # GPT-2 decode
    (torch.bfloat16, 128, 1, False, "split_kv"),    # Llama decode
    (torch.bfloat16, 128, 4, False, "split_kv"),    # GQA 4 decode
    (torch.bfloat16, 128, 1, True, "tile_tc"),      # Llama history
    (torch.float32, 64, 1, True, "tile"),           # GPT-2 history
    (torch.bfloat16, 64, 12, False, "tile_tc"),     # GQA 4, R = 3
    (torch.float32, 128, 12, False, "tile"),
    (torch.bfloat16, 96, 1, False, "tile"),         # another head dim
])
def test_paged_lane_rule(dtype, d, rows, shared, lane):
    assert paged_lane(dtype, d, rows, shared) == lane


def test_lane_numbering_matches_the_kernel_source():
    """``ops.paged.LANES`` and ``SPLIT_MAX_ROWS`` as the C entry points
    read the lane argument (``csrc/paged_attention.cu``)."""
    src = (Path(paged_mod.__file__).resolve().parent.parent / "csrc"
           / "paged_attention.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert [int(consts[n]) for n in
            ("kLaneSplitKv", "kLaneTileTc", "kLaneTile")] == [0, 1, 2]
    assert paged_mod.LANES == ("split_kv", "tile_tc", "tile")
    assert int(consts["kSplitMaxRows"]) == paged_mod.SPLIT_MAX_ROWS


def test_engine_history_reads_its_own_tables_through_row_slot(monkeypatch):
    """The packed prefill's history call passes the engine's (slots, W)
    tables and each token's slot, and gives what the per-token tables
    (``hetu_tpu``'s form) give, bit for bit."""
    import hetu_tpu_torch.nn.parallel as par
    real = par.paged_attention
    seen = []

    def spy(q, k, v, tables, offsets, *, row_slot=None, **kw):
        got = real(q, k, v, tables, offsets, row_slot=row_slot, **kw)
        if row_slot is not None:
            want = real(q, k, v, tables.index_select(0, row_slot), offsets,
                        **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            seen.append((tuple(tables.shape), row_slot.clone(),
                         offsets.clone()))
        return got

    monkeypatch.setattr(par, "paged_attention", spy)
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    eng = ServingEngine(model, slots=3, max_len=64, prefill_chunk=8,
                        block_size=8, device="cpu")
    rng = np.random.default_rng(7)
    eng.generate_many([rng.integers(1, 100, n).tolist() for n in (19, 5)],
                      SamplingParams(max_tokens=2))
    assert seen and all(shape[0] == 3 for shape, _, _ in seen)
    # a later chunk of the 19-token prompt reads its history (offset 7)
    assert any(bool((off == 7).any()) for _, _, off in seen)
    assert all(rs.dtype == torch.int32 for _, rs, _ in seen)
