"""The fused LM-head CE lanes of the port (``ops.fused_ce_lane``).

(a) The lane rule: ``fused_ce_lane`` against the branch of the C entry
    points ``hetu_fused_ce_fwd`` / ``_dh`` / ``_dw``, read from
    ``csrc/fused_ce.cu`` (as ``tests/test_torch_flash_tc.py`` pins
    ``flash_lane``): bf16 h takes the tensor-core kernels whatever w's
    dtype (the wrapper casts an fp32 w to bf16 once for the forward and
    dH; dW reads w in its own dtype), fp32 h the CUDA-core ones.
(b) The summation order of the dH and dW tensor-core lanes: a cluster of
    C CTAs splits E into 64-column chunks, CTA r summing its chunks'
    partial logits, and every CTA forms s as the rank-ordered fp32 sum of
    those partials before it rounds P to bf16. A plain helper does the
    same on the CPU (dH for C = 2 and C = 4, the pin of a later E split;
    dW, whose kernel shares dH's body, for C = 2), and its dh and dw are
    held to interpret-mode
    Pallas (``block_n=128, block_v=256``, as ``tests/test_torch_fused_ce.py``
    runs it) within the bound ``chip_smoke.py`` holds the card to
    (``fused_grad_bound``: 2 bf16 ulps of |reference| plus 2e-4 of max
    |reference|), on inputs drawn as ``chip_smoke.py`` draws them (h ~
    N(0, 1), w ~ N(0, 0.05^2), GPT-2's init scale): the kernel's order is
    inside the bound before the card sees it. With w ~ N(0, 0.3^2) the
    logits reach ~4 standard deviations, the softmax is peaky, and a
    last-bit change of s can round a large P entry the other way: there
    one draw at E = 192 leaves that bound (1.41 of it, 9 elements of one
    row) for the C = 2 order and for the port's plain version alike, so
    the peaky case is held to the bf16 tolerance of
    ``tests/test_torch_fused_ce.py`` (1e-2 of max |reference|).
(c) The wrapper's refusals under the lane rule, its w cast, and dW's
    dtype.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.ops.fused_ce_pallas import fused_lse_tgt as jax_fused_lse_tgt

from hetu_tpu_torch.ops import (
    fused_ce, fused_ce_dh_reference, fused_ce_dw_reference, fused_ce_lane,
)
from hetu_tpu_torch.ops.fused_ce import MAX_E

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parents[1] / "hetu_tpu_torch" / "csrc"
N, V = 333, 1013        # neither a multiple of any tile
PAD_N = 384             # JAX's kernels take whole 128-token blocks


# -- (a) the lane rule against the C entry points -----------------------------

def _entry(text, name):
    body = text[text.index(f'extern "C" int {name}('):]
    return body[:body.index("\n}\n")]


#: each entry's tensor-core launch past kMaxE, beside the one up to it
WIDE_TC_LAUNCH = {"launch_fwd_tc": "launch_fwd_wide_tc",
                  "launch_dh_tc": "launch_dh_wide_tc"}
WIDTHS = range(64, 6144 + 1, 64)


@pytest.mark.parametrize("entry,tc_launch", [
    ("hetu_fused_ce_fwd", "launch_fwd_tc"),
    ("hetu_fused_ce_dh", "launch_dh_tc"),
])
def test_fused_entry_points_branch_on_the_lane_rule(entry, tc_launch):
    """Every call first refuses (nothing launched) an E that is not a
    whole number of 64-column chunks, on either lane. bf16 h then
    refuses an fp32 w and launches the tensor-core kernel, the wide one
    past ``kMaxE``; fp32 h launches a CUDA-core kernel, the wide one past
    ``kMaxE``, in w's dtype."""
    text = (CSRC / "fused_ce.cu").read_text()
    assert int(re.search(r"constexpr int kMaxE = (\d+);", text).group(1)) \
        == MAX_E
    body = _entry(text, entry)
    wide = WIDE_TC_LAUNCH[tc_launch]
    narrow = tc_launch
    m = re.search(r"if \(E % 64 \|\| E < 64\) return \(int\)"
                  r"cudaErrorInvalidValue;\s*"
                  r"if \(h_bf16\) \{\s*"
                  r"if \(!w_bf16\) return \(int\)cudaErrorInvalidValue;\s*"
                  r"if \(E > kMaxE\)\s*return ([\w<>]+)\([^;]*;\s*"
                  r"return ([\w<>]+)\([^;]*;\s*\}", body)
    assert m and (m.group(1), m.group(2)) == (wide, narrow)
    rest = body[m.end():]
    assert "_tc" not in rest
    m = re.search(r"if \(E > kMaxE\) \{(.*?)\}", rest, re.S)
    assert m
    kind = "fwd" if entry.endswith("fwd") else "bwd"
    assert sorted(re.findall(r"launch_(\w+)<(\w+), (\w+)", m.group(1))) \
        == [(f"{kind}_wide", "float", t) for t in ("bf16", "float")]
    assert sorted(re.findall(r"launch_(\w+)<(\w+), (\w+)",
                             rest[m.end():])) \
        == [(kind, "float", t) for t in ("bf16", "float")]
    # the rule as the wrapper reads it
    for e in WIDTHS:
        suffix = "_wide" if e > MAX_E else ""
        for w_dtype in (torch.float32, torch.bfloat16):
            assert fused_ce_lane(torch.bfloat16, w_dtype, e) \
                == "tensor_core" + suffix
            assert fused_ce_lane(torch.float32, w_dtype, e) \
                == "cuda_core" + suffix


def test_dw_keeps_one_kernel_and_dh_runs_on_a_two_cta_cluster():
    """dW (#7) branches on the lane rule after refusing a partial chunk:
    bf16 h past ``kMaxE`` takes ``launch_dw_wide_tc`` (bf16 w only, the
    wrapper's cast; dw in the dtype ``dw_bf16`` names); every other call
    refuses a dw dtype other than w's, then bf16 h takes ``launch_dw_tc``
    in w's own dtype and fp32 h the CUDA-core kernels, the wide ones past
    ``kMaxE``; no CUDA-core instance of bf16 h is left. The narrow
    tensor-core dH and dW are launched with a cluster dimension of
    ``kBwdCluster`` = 2 CTAs; the wide ones with the cluster of
    ``wide_plan(E)`` (2, 4 or 8 CTAs, at most ``kWMaxCluster``, each at
    most 512 columns of E, ``kWideSlice``) and its E-groups on the grid's
    y axis, in one ``cudaLaunchKernelEx``."""
    text = (CSRC / "fused_ce.cu").read_text()
    body = _entry(text, "hetu_fused_ce_dw")
    m = re.search(r"if \(E % 64 \|\| E < 64\) return \(int\)"
                  r"cudaErrorInvalidValue;\s*"
                  r"if \(h_bf16 && E > kMaxE\) \{\s*"
                  r"if \(!w_bf16\) return \(int\)cudaErrorInvalidValue;\s*"
                  r"if \(dw_bf16\)\s*return launch_dw_wide_tc<bf16>\([^;]*;\s*"
                  r"return launch_dw_wide_tc<float>\([^;]*;\s*\}\s*"
                  r"if \(dw_bf16 != w_bf16\) return \(int\)"
                  r"cudaErrorInvalidValue;\s*"
                  r"if \(h_bf16\) \{\s*"
                  r"if \(w_bf16\)\s*return launch_dw_tc<bf16>\([^;]*;\s*"
                  r"return launch_dw_tc<float>\([^;]*;\s*\}", body)
    assert m
    rest = body[m.end():]
    assert "_tc" not in rest
    assert sorted(re.findall(r"launch_(\w+)<(\w+), (\w+), (\w+)>", rest)) \
        == [("bwd", "float", "bf16", "true"), ("bwd", "float", "float",
                                               "true"),
            ("bwd_wide", "float", "bf16", "true"),
            ("bwd_wide", "float", "float", "true")]
    assert not re.search(r"launch_(bwd|fwd)(_wide)?<bf16", text)
    assert re.search(r"constexpr int kBwdCluster = 2;", text)
    launch = text[text.index("int launch_cluster("):]
    launch = launch[:launch.index("\n}\n")]
    assert "cudaLaunchAttributeClusterDimension" in launch
    assert re.search(r"constexpr int C = kBwdCluster;", launch)
    assert re.search(r"clusterDim\.x = C;", launch)
    for name, kernel in (("launch_dh_tc", "fused_ce_dh_tc_kernel"),
                         ("launch_dw_tc", "fused_ce_dw_tc_kernel")):
        fn = text[text.index(f"int {name}("):]
        fn = fn[:fn.index("\n}\n")]
        assert re.search(rf"return launch_cluster\(\s*{kernel}<kBwdCluster",
                         fn), name
    assert re.search(r"constexpr int kWideSlice = 512;", text)
    assert re.search(r"constexpr int kWMaxCluster = 8;", text)
    plan = text[text.index("inline WidePlan wide_plan("):]
    plan = plan[:plan.index("\n}\n")]
    assert re.search(r"while \(C < kWMaxCluster && C \* kWSlice < kc\) "
                     r"C \*= 2;", plan)
    cfg = text[text.index("inline cudaLaunchConfig_t wide_config("):]
    cfg = cfg[:cfg.index("\n}\n")]
    assert "cudaLaunchAttributeClusterDimension" in cfg
    assert re.search(r"clusterDim\.x = pl\.C;", cfg)
    assert re.search(r"gridDim = dim3\(pl\.C \* \(\(rows \+ kWRows - 1\) / "
                     r"kWRows\), pl\.groups\);", cfg)
    wide = text[text.index("int launch_wide_tc("):]
    wide = wide[:wide.index("\n}\n")]
    assert re.search(r"wide_config\(wide_plan\(E\)", wide)
    assert wide.count("cudaLaunchKernelEx(") == 1
    for name, kernel in (("launch_dh_wide_tc", "fused_ce_dh_wide_tc_kernel"),
                         ("launch_dw_wide_tc", "fused_ce_dw_wide_tc_kernel")):
        fn = text[text.index(f"int {name}("):]
        fn = fn[:fn.index("\n}\n")]
        assert re.search(rf"return launch_wide_tc\(\s*{kernel}", fn), name


# -- (b) the dH lane's summation order ---------------------------------------

def _p_in_cluster_order(h, w, labels, lse, glse, gtgt, cluster):
    """The dlogits tile (N, V) as the backward tensor-core kernels form
    it: s = s_0 + s_1 + ... in rank order, s_r the fp32 logits over CTA
    r's E-chunks ``[r p, (r + 1) p)`` of 64 columns (``p = ceil(E / 64 /
    cluster)``; a slice may be empty); P from s rounded to bf16 (dW's
    P^T holds the same values: each s is a sum of the same two terms)."""
    k = h.shape[1] // 64
    per = -(-k // cluster)
    hf, wf = h.float(), w.to(h.dtype).float()
    s = torch.zeros(h.shape[0], w.shape[0])
    for r in range(cluster):
        lo, hi = 64 * min(k, r * per), 64 * min(k, (r + 1) * per)
        s = s + hf[:, lo:hi] @ wf[:, lo:hi].t()
    hit = labels.long()[:, None] == torch.arange(w.shape[0])[None, :]
    p = glse[:, None] * torch.exp(s - lse[:, None]) \
        + torch.where(hit, gtgt[:, None], 0.0)
    return p.to(torch.bfloat16).float()


def _dh_in_cluster_order(h, w, labels, lse, glse, gtgt, cluster):
    """dH as ``fused_ce_dh_tc_kernel`` orders its sums: P from
    :func:`_p_in_cluster_order`; dh = P w summed in fp32, rounded to h's
    dtype."""
    p = _p_in_cluster_order(h, w, labels, lse, glse, gtgt, cluster)
    return (p @ w.to(h.dtype).float()).to(h.dtype)


def _dw_in_cluster_order(h, w, labels, lse, glse, gtgt, cluster=2):
    """dW as ``fused_ce_dw_tc_kernel`` orders its sums: the cluster owns
    vocab rows and splits E as dH's does, so P^T holds the values of
    :func:`_p_in_cluster_order`; dw = P^T h summed in fp32, rounded to
    w's dtype."""
    p = _p_in_cluster_order(h, w, labels, lse, glse, gtgt, cluster)
    return (p.t() @ h.float()).to(w.dtype)


@functools.lru_cache(maxsize=None)
def _case(e, w_scale):
    """bf16 h ~ N(0, 1) (N, E) and w ~ N(0, w_scale^2) (V, E), labels
    with -1 and V - 1, general cotangents; JAX's lse, dh and dw
    (interpret-mode Pallas on the rows padded to whole token blocks, pad
    rows with label -1 and zero cotangents, which add nothing to dw)."""
    rng = np.random.default_rng(100 + e)
    h = rng.normal(size=(PAD_N, e)).astype(np.float32)
    h[N:] = 0.0
    w = (rng.normal(size=(V, e)) * w_scale).astype(np.float32)
    labels = np.full(PAD_N, -1, np.int32)
    labels[:N] = rng.integers(0, V, N)
    labels[:N:7] = -1
    labels[3] = V - 1
    glse = np.zeros(PAD_N, np.float32)
    gtgt = np.zeros(PAD_N, np.float32)
    glse[:N] = rng.normal(size=N)
    gtgt[:N] = rng.normal(size=N)
    jh, jw = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    (jlse, _), vjp = jax.vjp(
        lambda a, b: jax_fused_lse_tgt(a, b, jnp.asarray(labels), 128, 256,
                                       True), jh, jw)
    jdh, jdw = vjp((jnp.asarray(glse), jnp.asarray(gtgt)))
    as_torch = (lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(torch.bfloat16))
    return (as_torch(jh)[:N], as_torch(jw), torch.from_numpy(labels[:N]),
            torch.from_numpy(np.array(jlse)[:N]),
            torch.from_numpy(glse[:N]), torch.from_numpy(gtgt[:N]),
            np.array(jdh.astype(jnp.float32))[:N],
            np.array(jdw.astype(jnp.float32)))


def _grad_bound(want):
    """``chip_smoke.py`` ``fused_grad_bound`` for bf16 h and output."""
    _, ex = np.frexp(np.abs(want))
    ulp = np.where(want == 0, 0.0, np.ldexp(1.0, ex - 8))
    return 2 * ulp + 2e-4 * np.abs(want).max()


@pytest.mark.parametrize("cluster", [2, 4])
@pytest.mark.parametrize("e", [128, 192])
def test_dh_cluster_order_within_the_card_bound_of_pallas(e, cluster):
    h, w, labels, lse, glse, gtgt, want, _ = _case(e, 0.05)
    got = _dh_in_cluster_order(h, w, labels, lse, glse, gtgt, cluster)
    assert got.dtype == torch.bfloat16 and got.shape == (N, e)
    err = np.abs(got.float().numpy() - want)
    assert (err <= _grad_bound(want)).all(), \
        f"max err {err.max()}, {(err / _grad_bound(want)).max()} of the bound"
    # the port's plain version, which the card's kernel is checked
    # against, keeps the same bound
    plain = fused_ce_dh_reference(h, w, labels, lse, glse, gtgt)
    assert (np.abs(plain.float().numpy() - want) <= _grad_bound(want)).all()


@pytest.mark.parametrize("e", [128, 192])
def test_dh_cluster_order_with_a_peaky_softmax_within_bf16_tolerance(e):
    h, w, labels, lse, glse, gtgt, want, _ = _case(e, 0.3)
    lim = 1e-2 * np.abs(want).max()
    for cluster in (2, 4):
        got = _dh_in_cluster_order(h, w, labels, lse, glse, gtgt, cluster)
        assert np.abs(got.float().numpy() - want).max() <= lim, cluster
    plain = fused_ce_dh_reference(h, w, labels, lse, glse, gtgt)
    assert np.abs(plain.float().numpy() - want).max() <= lim


@pytest.mark.parametrize("e", [128, 192])
def test_dw_cluster_order_within_the_card_bound_of_pallas(e):
    h, w, labels, lse, glse, gtgt, _, want = _case(e, 0.05)
    got = _dw_in_cluster_order(h, w, labels, lse, glse, gtgt)
    assert got.dtype == torch.bfloat16 and got.shape == (V, e)
    err = np.abs(got.float().numpy() - want)
    assert (err <= _grad_bound(want)).all(), \
        f"max err {err.max()}, {(err / _grad_bound(want)).max()} of the bound"
    plain = fused_ce_dw_reference(h, w, labels, lse, glse, gtgt)
    assert (np.abs(plain.float().numpy() - want) <= _grad_bound(want)).all()


@pytest.mark.parametrize("e", [128, 192])
def test_dw_cluster_order_with_a_peaky_softmax_within_bf16_tolerance(e):
    h, w, labels, lse, glse, gtgt, _, want = _case(e, 0.3)
    lim = 1e-2 * np.abs(want).max()
    got = _dw_in_cluster_order(h, w, labels, lse, glse, gtgt)
    assert np.abs(got.float().numpy() - want).max() <= lim
    plain = fused_ce_dw_reference(h, w, labels, lse, glse, gtgt)
    assert np.abs(plain.float().numpy() - want).max() <= lim


# -- (c) refusals, the w cast and dW's dtype ----------------------------------

@pytest.mark.parametrize("e", [0, 32, 96, 4096 + 32])
def test_lane_rule_refuses_widths_neither_lane_takes(e):
    for h_dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="multiples of 64"):
            fused_ce_lane(h_dtype, torch.bfloat16, e)


def test_lane_rule_and_wrapper_refuse_other_dtypes():
    with pytest.raises(TypeError, match="h must be fp32 or bf16"):
        fused_ce_lane(torch.float16, torch.bfloat16, 768)
    with pytest.raises(TypeError, match="w must be fp32 or bf16"):
        fused_ce_lane(torch.bfloat16, torch.float16, 768)
    lab = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="h must be fp32 or bf16"):
        fused_ce._check("fused_ce_dh",
                        torch.empty(8, 128, dtype=torch.float16,
                                    device="meta"),
                        torch.empty(V, 128, device="meta"), lab)
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_ce._check("fused_ce_fwd",
                        torch.empty(8, 96, dtype=torch.bfloat16,
                                    device="meta"),
                        torch.empty(V, 96, dtype=torch.bfloat16,
                                    device="meta"), lab)


def test_wrapper_casts_an_fp32_w_once_for_the_tensor_core_lane():
    """bf16 h with an fp32 w: the forward and dH kernels get w cast to
    bf16 (the values ``w.to(bfloat16)`` holds, so ``kernel_w_cast`` on
    the card compares one lane with itself); every other pairing passes
    w through untouched."""
    rng = np.random.default_rng(9)
    w32 = torch.from_numpy(rng.normal(size=(V, 128)).astype(np.float32))
    w16 = w32.to(torch.bfloat16)
    h16 = torch.zeros(4, 128, dtype=torch.bfloat16)
    h32 = torch.zeros(4, 128)
    cast = fused_ce._launch_w(h16, w32)
    assert cast.dtype == torch.bfloat16 and torch.equal(cast, w16)
    for h, w in ((h16, w16), (h32, w32), (h32, w16)):
        assert fused_ce._launch_w(h, w) is w


def test_dw_comes_back_in_w_dtype_with_bf16_h():
    """bf16 h with an fp32 w: dW (which reads w in its own dtype) returns
    an fp32 dw, and that dw rounded to bf16 is bit for bit the dw of w
    cast to bf16 (what ``kernel_w_cast`` holds the card to)."""
    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.normal(size=(40, 128)).astype(np.float32)
                         ).to(torch.bfloat16)
    w32 = torch.from_numpy((rng.normal(size=(V, 128)) * 0.05
                            ).astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, V, 40).astype(np.int32))
    glse = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    gtgt = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    lse, _ = fused_ce.fused_ce_fwd(h, w32, labels)
    dw32 = fused_ce.fused_ce_dw(h, w32, labels, lse, glse, gtgt)
    dw16 = fused_ce.fused_ce_dw(h, w32.to(torch.bfloat16), labels, lse,
                                glse, gtgt)
    assert dw32.dtype == torch.float32 and dw32.shape == (V, 128)
    assert dw16.dtype == torch.bfloat16
    assert torch.equal(dw32.to(torch.bfloat16), dw16)
