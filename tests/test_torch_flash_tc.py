"""The port's flash forward and backward at bf16 against ``hetu_tpu``'s,
and the fp32 plain versions held bit for bit to their earlier formulas.

The bf16 plain versions are what the lanes of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` are held to on the card: the tensor-core lanes at
head_dim 64/128, the CUDA-core lanes at 96. Each C entry point's lane
rule is read from its source and held to ``flash_lane``, the fp32
forward's 3xTF32 lane included (its numerics:
``tests/test_torch_flash_tf32x3.py``).
They round where the TPU kernels round (p to v's dtype before p v,
``flash_pallas.py:235``; p~ to dO's before dV, :466; ds to q's before dK,
:475, and to k's before dQ, :402) and run here against the Pallas kernels
in interpret mode at bf16, on numpy inputs from a seed. The backward of
both sides takes the Pallas forward's out and lse.

Tolerance, element by element on out, dq, dk and dv: 1 bf16 ulp of the
reference's magnitude (both round an fp32 sum taken in another order to
bf16 once) plus 1e-3 absolute (a probability or ds 1 fp32 ulp apart may
round to the neighbouring bf16 value before its product; JAX divides by
1 - rate where the port multiplies by its reciprocal). lse: 1e-4 (fp32 on
both sides).
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.ops.flash_pallas import _flash_bwd, _flash_fwd

from hetu_tpu_torch.ops import (
    NEG_INF, dropout_keep_bh, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference,
)
from hetu_tpu_torch.ops.flash import DKV, DQ, FWD, TC_HEAD_DIMS, flash_lane

torch.set_num_threads(2)

ABS = 1e-3
LSE_TOL = 1e-4
CSRC = Path(__file__).resolve().parents[1] / "hetu_tpu_torch" / "csrc"


def _ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _close_bf16(got, want):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    lim = _ulp(want) + ABS
    assert (err <= lim).all(), \
        f"max err {err.max()}, {(err / lim).max()} of the bound"


def _np(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _seg(s, cuts):
    """Segment ids of one packed row: runs of the given lengths, then -1
    pads to ``s``."""
    ids = np.full(s, -1, np.int32)
    at = 0
    for i, n in enumerate(cuts):
        ids[at:at + n] = i
        at += n
    return ids


# (hq, hkv, s, d, segments, causal, q_offset, kv_offset, dropout rate)
CASES = {
    "gqa2_d64": (4, 2, 160, 64, None, True, 0, 0, 0.0),
    "gqa4_d128_ragged": (8, 2, 100, 128, None, True, 0, 0, 0.0),
    "segments_pads_d64": (4, 2, 96, 64, (30, 50), True, 0, 0, 0.0),
    "non_causal_segments_d128": (4, 4, 72, 128, (20, 40), False, 0, 0, 0.0),
    "dead_rows_d64": (4, 4, 80, 64, None, True, 0, 5, 0.0),
    "dead_rows_d128": (4, 2, 70, 128, None, True, 3, 9, 0.0),
    "dropout_gqa2_d64": (4, 2, 128, 64, None, True, 0, 0, 0.1),
    "dropout_offsets_d128": (4, 4, 90, 128, None, True, 2, 6, 0.1),
    # the CUDA-core lanes' bf16 shape (chip_smoke.py's cuda_core_d96)
    "cuda_core_d96": (4, 2, 130, 96, None, True, 0, 0, 0.0),
}


def _inputs(seed, b, hq, hkv, s, d, cuts):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, hq, s, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    seg = None if cuts is None else np.stack([_seg(s, cuts)] * b)
    return q, k, v, do, seg


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_plain_versions_match_pallas_interpret(name):
    hq, hkv, s, d, cuts, causal, qo, ko, rate = CASES[name]
    b = 2 if rate else 1
    q, k, v, do, seg = _inputs(sum(map(ord, name)), b, hq, hkv, s, d, cuts)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, kv_offset=ko)
    drop = dict(dropout_rate=rate, seed=1234 if rate else None)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)

    want_o, want_l = _flash_fwd(*bf[:3], jseg, jseg, interpret=True, **kw,
                                **drop)
    got_o, got_l = flash_attention_fwd_reference(*tb[:3], tseg, tseg, **kw,
                                                 **drop)
    assert got_o.dtype == torch.bfloat16
    _close_bf16(got_o, _np(want_o))
    np.testing.assert_allclose(got_l.numpy(), _np(want_l), atol=LSE_TOL,
                               rtol=0)
    # on the CPU the wrapper is the plain version
    same = flash_attention_fwd(*tb[:3], tseg, tseg, **kw, **drop)
    assert torch.equal(same[0], got_o) and torch.equal(same[1], got_l)
    if ko > qo:               # rows before the first key: exact 0 / -1e30
        assert torch.all(got_o[:, :, :ko - qo] == 0)
        assert torch.all(got_l[:, :, :ko - qo] == NEG_INF)

    want = _flash_bwd(*bf[:3], jseg, jseg, want_o, want_l, bf[3],
                      interpret=True, **kw, **drop)
    t_o = torch.from_numpy(_np(want_o)).to(torch.bfloat16)
    t_l = torch.from_numpy(_np(want_l))
    got = flash_attention_bwd_reference(*tb[:3], tseg, tseg, t_o, t_l, tb[3],
                                        **kw, **drop)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close_bf16(g, _np(w))
    same = flash_attention_bwd(*tb[:3], tseg, tseg, t_o, t_l, tb[3], **kw,
                               **drop)
    assert all(torch.equal(a, b_) for a, b_ in zip(same, got))
    if ko > qo:
        assert torch.all(got[0][:, :, :ko - qo] == 0)


def _fwd_fp32_before(q, k, v, seg, *, causal, scale, q_offset, kv_offset,
                     rate, seed):
    """The fp32 plain forward as it stood before the bf16 rounding points
    were added: normalised p in fp32, then p v."""
    b, hq, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qs = (q.float() * scale).to(q.dtype).float()
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    qi = torch.arange(sq)[:, None] + q_offset
    ki = torch.arange(sk)[None, :] + kv_offset
    mask = ((qi >= ki) if causal else torch.ones(sq, sk, dtype=torch.bool)
            )[None, None]
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    s = torch.where(mask, qs @ kf.transpose(-1, -2), torch.full((), NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    keep = None
    if rate:
        keep = dropout_keep_bh(seed, b, hq, sq, sk, rate=rate,
                               q_offset=q_offset, kv_offset=kv_offset)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    return (p @ vf).to(q.dtype), lse, (s, mask, qs, kf, keep)


def _bwd_fp32_before(q, k, v, out, lse, do, parts, *, scale, rate):
    """The fp32 plain backward as it stood before: p, p~ and ds in fp32."""
    s, mask, qs, kf, keep = parts
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    drop = (lambda x: x) if keep is None else (
        lambda x: torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)))
    delta = (out.float() * do.float()).sum(-1)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = drop(do.float() @ v.float().repeat_interleave(g, dim=1)
              .transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qs).reshape(b, hkv, g, sk, d).sum(2)
    dv = (drop(p).transpose(-1, -2) @ do.float()).reshape(
        b, hkv, g, sk, d).sum(2)
    return dq, dk, dv


@pytest.mark.parametrize("name", ["gqa4_d128_ragged", "segments_pads_d64",
                                  "dead_rows_d64", "dropout_offsets_d128"])
def test_fp32_plain_versions_bit_identical_to_before(name):
    hq, hkv, s, d, cuts, causal, qo, ko, rate = CASES[name]
    q, k, v, do, seg = (None if a is None else torch.from_numpy(a)
                        for a in _inputs(7, 1, hq, hkv, s, d, cuts))
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, kv_offset=ko)
    seed = 99 if rate else None
    out, lse = flash_attention_fwd_reference(q, k, v, seg, seg, **kw,
                                             dropout_rate=rate, seed=seed)
    want_o, want_l, parts = _fwd_fp32_before(q, k, v, seg, **kw, rate=rate,
                                             seed=seed)
    assert torch.equal(out, want_o) and torch.equal(lse, want_l)
    got = flash_attention_bwd_reference(q, k, v, seg, seg, out, lse, do,
                                        **kw, dropout_rate=rate, seed=seed)
    want = _bwd_fp32_before(q, k, v, out, lse, do, parts,
                            scale=kw["scale"], rate=rate)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


# (dtype, head_dim, the lanes of the forward, dQ and dK/dV)
LANES = [
    (torch.bfloat16, 64, ("tensor_core",) * 3),
    (torch.bfloat16, 128, ("tensor_core",) * 3),
    (torch.bfloat16, 96, ("cuda_core",) * 3),
    (torch.bfloat16, 32, ("cuda_core",) * 3),
    (torch.float32, 64, ("tensor_core_f32", "cuda_core", "cuda_core")),
    (torch.float32, 128, ("tensor_core_f32", "cuda_core", "cuda_core")),
    (torch.float32, 96, ("cuda_core",) * 3),
]


@pytest.mark.parametrize("dtype,d,lanes", LANES)
def test_flash_lane_follows_dtype_and_head_dim(dtype, d, lanes):
    """Per kernel: fp32 at 64 and 128 takes the 3xTF32 lane in the
    forward only; the default kernel is the forward."""
    assert tuple(flash_lane(dtype, d, kernel) for kernel in (FWD, DQ, DKV)) \
        == lanes
    assert flash_lane(dtype, d) == lanes[0]
    with pytest.raises(ValueError, match="no flash kernel"):
        flash_lane(dtype, d, "flash_bwd")


@pytest.mark.parametrize("source,entry,tc_launch", [
    ("flash_fwd.cu", "hetu_flash_fwd", "launch_tc"),
    ("flash_bwd.cu", "hetu_flash_bwd_dq", "launch_dq_tc"),
    ("flash_bwd.cu", "hetu_flash_bwd_dkv", "launch_dkv_tc"),
])
def test_flash_entry_points_branch_on_the_lane_rule(source, entry,
                                                    tc_launch):
    """Each C entry point of #2, #3 and #4 picks its lane as
    ``flash_lane`` does, before the launch: bf16 at each of
    ``TC_HEAD_DIMS`` launches the tensor-core kernel of that head_dim,
    fp32 there the forward's 3xTF32 kernel (``hetu_flash_fwd`` only), and
    every other call the CUDA-core one."""
    text = (CSRC / source).read_text()
    body = text[text.index(f'extern "C" int {entry}('):]
    body = body[:body.index("\n}\n")]
    tc = re.findall(r"if \(bf16 && d == (\d+)\)\s*return (\w+)<(\d+)>",
                    body)
    assert [(int(d), fn, int(t)) for d, fn, t in tc] \
        == [(d, tc_launch, d) for d in TC_HEAD_DIMS]
    assert all(flash_lane(torch.bfloat16, d) == "tensor_core"
               for d in TC_HEAD_DIMS)
    # fp32 at each of TC_HEAD_DIMS: the forward's 3xTF32 kernel, before
    # the CUDA-core fallthrough; the backward's entries have no such branch
    f32 = re.findall(r"if \(!bf16 && d == (\d+)\)\s*return (\w+)<(\d+)>",
                     body)
    kernel = {"hetu_flash_fwd": FWD, "hetu_flash_bwd_dq": DQ,
              "hetu_flash_bwd_dkv": DKV}[entry]
    want = [(d, "launch_tf32x3", d) for d in TC_HEAD_DIMS
            if flash_lane(torch.float32, d, kernel) == "tensor_core_f32"]
    assert [(int(d), fn, int(t)) for d, fn, t in f32] == want
    assert bool(want) == (entry == "hetu_flash_fwd")
    assert all(flash_lane(torch.float32, d, kernel) == "cuda_core"
               for d in (32, 96, 160, 256))
    rest = body[body.rindex(f"{want[-1][1] if want else tc_launch}<"):]
    assert re.search(r"if \(bf16\)\s*return launch\w*<__nv_bfloat16>", rest)
    assert re.search(r"return launch\w*<float>", rest)
