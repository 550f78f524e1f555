"""The fused LM-head CE past E = 768, where the port's kernels #5-#7 take
their wide lanes (``ops.fused_ce_lane``: ``"tensor_core_wide"`` and
``"cuda_core_wide"``), against ``hetu_tpu``'s Pallas kernels in interpret
mode (``fused_lse_tgt``, ``block_n=128, block_v=256``, any E).

(a) The plain versions (the CPU path and the card's yardstick) at E =
    832, 1,024, 4,096 and 5,120, 96 tokens (JAX's rows padded to a token block:
    pad rows have label -1 and zero cotangents) and a ragged vocab of 1013
    with a label of V - 1, in the four fp32/bf16 pairings of
    ``tests/test_torch_fused_ce.py``, with general cotangents ``(glse,
    gtgt)``. Inputs are drawn as ``chip_smoke.py`` draws them (h ~ N(0,
    1), w ~ N(0, 0.05^2)): at E = 4,096 and w ~ N(0, 0.3^2) the logits
    reach |s| ~ 80, where fp32 sums of 4,096 terms in two orders part by
    more than the lse bound. Tolerances, those of that file: lse/tgt 1e-4
    absolute; dh/dw 1e-5 of max |reference| in fp32 with fp32 h, 2e-3
    with bf16 h, 1e-2 in bf16.
(b) The summation order of the wide tensor-core lane: a cluster of C
    CTAs shares one s; CTA r sums its partial s_r over its slice of E
    (chunks [r p, r p + p) of the E / 64, C and p from ``wide_plan``,
    the rule of ``csrc/fused_ce.cu``'s launch), each 64-column
    chunk from zero and added in order; the C partials are summed in rank
    order, P is formed once and rounded to bf16, and P times Y is summed
    over 64-row tiles in order, in fp32. Past 4,096 columns (5,120 here)
    E-groups each compute the same s. A plain helper does the same on the
    CPU, and its dh and dw are held to interpret-mode Pallas within the
    bound ``chip_smoke.py`` holds the card to (``fused_grad_bound``: 2
    bf16 ulps of |reference| plus 2e-4 of max |reference|), bf16 h and
    w, at every width. The wide tensor-core forward's order: a cluster of
    C CTAs shares one 128-token tile, CTA r walking the 128-column vocab
    tiles r, r + C, ...; each tile's logits are its 64-column chunks'
    products summed from zero and added in order; each CTA keeps an
    online (m, l, tgt) over its tiles, and the C states are combined in
    rank order. A plain twin of that order at C = 1, 2 and 4 is held to
    interpret-mode Pallas's lse and tgt within ``FUSED_TOL_LSE`` (1e-4,
    as on the card) at every width; the plan rule's mirror
    (``wide_fwd_plan``) at n = 5 to 49,152.
(c) The wrapper: the lane names, dW's w cast on the wide lane, widths.
(d) Llama with a vocab of 8,269 under ``HETU_LM_LOSS_IMPL=fused``: the
    port's loss and every grad (the fused path: the plain versions of
    #5-#7) against ``hetu_tpu``'s, which runs its chunked CE on the CPU
    (``_use_fused_ce`` needs a TPU): fp32, 1e-5, the bounds of
    ``test_gpt_fused_lm_loss_and_every_grad_match_jax``; then two train
    steps of each (loss 1e-5, grad norm rtol 1e-4).
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import optim as jax_optim
from hetu_tpu.engine import build_train_step as jax_build_train_step
from hetu_tpu.engine import init_state as jax_init_state
from hetu_tpu.engine import make_plan as jax_make_plan
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.ops.fused_ce_pallas import fused_lse_tgt as jax_fused_lse_tgt
from hetu_tpu.parallel.strategy import Strategy as JaxStrategy

from hetu_tpu_torch import optim
from hetu_tpu_torch.engine import build_train_step, init_state, make_plan
from hetu_tpu_torch.models import (
    LlamaConfig, LlamaLMHeadModel, grads_from_jax, params_from_jax,
)
from hetu_tpu_torch.ops import fused_ce, losses as losses_mod
from hetu_tpu_torch.ops.fused_ce import (
    MAX_E, fused_ce_dh, fused_ce_dh_reference, fused_ce_dw,
    fused_ce_dw_reference, fused_ce_fwd, fused_ce_lane, wide_fwd_plan,
    wide_plan,
)
from hetu_tpu_torch.parallel import Strategy

torch.set_num_threads(2)

N, V, PAD_N = 96, 1013, 128
WIDTHS = (832, 1024, 4096, 5120)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
PAIRS = [(hd, wd) for hd in DTYPES for wd in DTYPES]


@functools.lru_cache(maxsize=None)
def _case(e, h_dt, w_dt):
    """Inputs in the dtypes named, as the port gets them (the values JAX
    holds), and JAX's (lse, tgt, dh, dw) as float32 numpy, rows cut to
    N."""
    rng = np.random.default_rng(200 + e)
    h = np.zeros((PAD_N, e), np.float32)
    h[:N] = rng.normal(size=(N, e))
    w = (rng.normal(size=(V, e)) * 0.05).astype(np.float32)
    labels = np.full(PAD_N, -1, np.int32)
    labels[:N] = rng.integers(0, V, N)
    labels[:N:7] = -1
    labels[3] = V - 1
    glse = np.zeros(PAD_N, np.float32)
    gtgt = np.zeros(PAD_N, np.float32)
    glse[:N] = rng.normal(size=N)
    gtgt[:N] = rng.normal(size=N)
    jh = jnp.asarray(h, DTYPES[h_dt][0])
    jw = jnp.asarray(w, DTYPES[w_dt][0])
    (jlse, jtgt), vjp = jax.vjp(
        lambda a, b: jax_fused_lse_tgt(a, b, jnp.asarray(labels), 128, 256,
                                       True), jh, jw)
    jdh, jdw = vjp((jnp.asarray(glse), jnp.asarray(gtgt)))

    def as_torch(a, dt):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)

    ins = (as_torch(jh, DTYPES[h_dt][1])[:N], as_torch(jw, DTYPES[w_dt][1]),
           torch.from_numpy(labels[:N]), torch.from_numpy(glse[:N]),
           torch.from_numpy(gtgt[:N]))
    want = tuple(np.array(a.astype(jnp.float32)) for a in
                 (jlse[:N], jtgt[:N], jdh[:N], jdw))
    return ins, want


def _tol(out_dtype, h_dt):
    if out_dtype == torch.bfloat16:
        return 1e-2
    return 2e-3 if h_dt == "bf16" else 1e-5


# -- (a) the plain versions ----------------------------------------------------

@pytest.mark.parametrize("h_dt,w_dt", PAIRS)
@pytest.mark.parametrize("e", WIDTHS)
def test_wide_forward_matches_pallas_interpret(e, h_dt, w_dt):
    (h, w, labels, _, _), (jlse, jtgt, _, _) = _case(e, h_dt, w_dt)
    assert fused_ce_lane(h.dtype, w.dtype, e).endswith("_wide")
    lse, tgt = fused_ce_fwd(h, w, labels)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tgt.numpy(), jtgt, atol=1e-4, rtol=0)
    assert bool((tgt[labels == -1] == 0).all())


@pytest.mark.parametrize("h_dt,w_dt", PAIRS)
@pytest.mark.parametrize("e", WIDTHS)
def test_wide_backward_general_cotangents_match_pallas_interpret(e, h_dt,
                                                                 w_dt):
    (h, w, labels, glse, gtgt), (jlse, _, jdh, jdw) = _case(e, h_dt, w_dt)
    args = (h, w, labels, torch.from_numpy(jlse), glse, gtgt)
    dh, dw = fused_ce_dh(*args), fused_ce_dw(*args)
    assert dh.dtype == h.dtype and dw.dtype == w.dtype
    assert dh.shape == (N, e) and dw.shape == (V, e)
    for name, got, want in (("dh", dh, jdh), ("dw", dw, jdw)):
        err = np.abs(got.float().numpy() - want).max()
        bound = _tol(got.dtype, h_dt) * np.abs(want).max()
        assert err <= bound, (name, err, bound)


# -- (b) the wide tensor-core lane's summation order ---------------------------

def _p_in_wide_order(x, y, x_is_h, labels, lse, glse, gtgt):
    """P (rows of x by rows of y) as the wide tensor-core body forms it:
    CTA r's partial s_r over chunks [r p, r p + p), each 64-column chunk
    from zero, added in order; s = s_0 + s_1 + ... in rank order; P
    rounded to bf16. dh: x = h, y = w; dw: x = w, y = h (P
    transposed)."""
    xf, yf = x.float(), y.float()
    chunks = x.shape[1] // 64
    c, p, _ = wide_plan(x.shape[1])
    s = None
    for r in range(c):
        part = torch.zeros(x.shape[0], y.shape[0])
        for q in range(r * p, min(chunks, (r + 1) * p)):
            cols = slice(64 * q, 64 * q + 64)
            part = part + xf[:, cols] @ yf[:, cols].t()
        s = part if s is None else s + part
    if not x_is_h:
        s = s.t()                        # (tokens, vocab)
    hit = labels.long()[:, None] == torch.arange(s.shape[1])[None, :]
    p = glse[:, None] * torch.exp(s - lse[:, None]) \
        + torch.where(hit, gtgt[:, None], 0.0)
    p = p.to(torch.bfloat16).float()
    return p if x_is_h else p.t()


def _out_in_wide_order(x, y, x_is_h, labels, lse, glse, gtgt, out_dtype):
    """dh (x = h) or dw (x = w) in the wide lane's order: P once (every
    E-group computes the same bits), P y summed over 64-row tiles of y in
    order, fp32, rounded to ``out_dtype``."""
    out = torch.zeros(x.shape, dtype=torch.float32)
    p = _p_in_wide_order(x, y, x_is_h, labels, lse, glse, gtgt)
    for t0 in range(0, y.shape[0], 64):
        out += p[:, t0:t0 + 64] @ y[t0:t0 + 64].float()
    return out.to(out_dtype)


def _grad_bound(want):
    """``chip_smoke.py`` ``fused_grad_bound`` for bf16 h."""
    _, ex = np.frexp(np.abs(want))
    ulp = np.where(want == 0, 0.0, np.ldexp(1.0, ex - 8))
    return 2 * ulp + 2e-4 * np.abs(want).max()


@pytest.mark.parametrize("which", ["dh", "dw"])
@pytest.mark.parametrize("e", WIDTHS)
def test_wide_lane_order_within_the_card_bound_of_pallas(e, which):
    (h, w, labels, glse, gtgt), (jlse, _, jdh, jdw) = _case(e, "bf16",
                                                            "bf16")
    lse = torch.from_numpy(jlse)
    if which == "dh":
        got = _out_in_wide_order(h, w, True, labels, lse, glse, gtgt,
                                 torch.bfloat16)
        plain = fused_ce_dh_reference(h, w, labels, lse, glse, gtgt)
        want = jdh
    else:
        got = _out_in_wide_order(w, h, False, labels, lse, glse, gtgt,
                                 torch.bfloat16)
        plain = fused_ce_dw_reference(h, w, labels, lse, glse, gtgt)
        want = jdw
    bound = _grad_bound(want)
    err = np.abs(got.float().numpy() - want)
    assert (err <= bound).all(), \
        f"max err {err.max()}, {(err / bound).max()} of the bound"
    # the plain version the card is checked against keeps the same bound
    assert (np.abs(plain.float().numpy() - want) <= bound).all()


def _lse_tgt_in_wide_order(h, w, labels, c):
    """(lse, tgt) as the wide tensor-core forward forms them: c CTAs
    share the token tile, CTA r walking the 128-column vocab tiles r, r +
    c, ...; a tile's s is each 64-column chunk's products summed from
    zero and added in chunk order, columns past V -1e30; each CTA's
    online (m, l, tgt) over its tiles; the c states combined in rank
    order, m = max m_r, l = sum l_r exp(m_r - m), tgt = sum tgt_r."""
    hf, wf = h.float(), w.float()
    n, vocab, e = h.shape[0], w.shape[0], h.shape[1]
    states = []
    for r in range(c):
        m = torch.full((n,), float("-inf"))
        l, t = torch.zeros(n), torch.zeros(n)
        for v0 in range(128 * r, vocab, 128 * c):
            wt = torch.zeros(128, e)
            wt[:min(128, vocab - v0)] = wf[v0:v0 + 128]
            s = torch.zeros(n, 128)
            for q in range(e // 64):
                cols = slice(64 * q, 64 * q + 64)
                s = s + hf[:, cols] @ wt[:, cols].t()
            s[:, vocab - v0:] = -1e30
            hit = labels.long()[:, None] == (v0 + torch.arange(128))[None, :]
            t = t + torch.where(hit, s, 0.0).sum(1)
            mx = torch.maximum(m, s.max(1).values)
            l = l * torch.exp(m - mx) + torch.exp(s - mx[:, None]).sum(1)
            m = mx
        states.append((m, l, t))
    mm = torch.stack([m for m, _, _ in states]).max(0).values
    l, t = torch.zeros(n), torch.zeros(n)
    for m_r, l_r, t_r in states:
        l = l + l_r * torch.exp(m_r - mm)
        t = t + t_r
    return mm + torch.log(l), t


@pytest.mark.parametrize("c", [1, 2, 4])
@pytest.mark.parametrize("e", WIDTHS)
def test_wide_forward_order_within_the_card_bound_of_pallas(e, c):
    """96 tokens (a ragged token tile), V = 1013 (a ragged last vocab
    tile; at c = 2 and 4 the 8 tiles split evenly, at c = 1 one CTA walks
    them all), a label at V - 1 and every 7th -1."""
    (h, w, labels, _, _), (jlse, jtgt, _, _) = _case(e, "bf16", "bf16")
    assert int(labels[3]) == V - 1
    lse, tgt = _lse_tgt_in_wide_order(h, w, labels, c)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tgt.numpy(), jtgt, atol=1e-4, rtol=0)
    assert bool((tgt[labels == -1] == 0).all())


#: CTAs in clusters of 1, 2, 4 and 8 that an H100 SXM (132 SMs) holds at
#: once with the wide forward's 195 KB of shared memory a CTA, as
#: ``wide_fwd_info`` read them on an ``NVIDIA H100 80GB HBM3``
#: (``cudaOccupancyMaxActiveClusters`` x C)
H100_SLOTS = {1: 132, 2: 132, 4: 120, 8: 120}


@pytest.mark.parametrize("n,c", [(5, 8), (333, 8), (1000, 8), (8192, 2),
                                 (49152, 1)])
def test_wide_fwd_plan_fills_the_card(n, c):
    """At Llama's vocab of 32,000 (250 tiles): a few token tiles take
    the widest cluster; n = 8,192 (64 tiles) takes C = 2, 128 CTAs in one
    wave, at least 120 of the 132 SMs at work (C = 4 would take three
    waves of 63 tiles); n = 49,152 fills three waves with C = 1 (C = 2
    ties: the smaller wins)."""
    assert wide_fwd_plan(n, 32000, H100_SLOTS) == c
    ctas = c * -(-n // 128)
    assert min(ctas, H100_SLOTS[c]) >= min(120, ctas)
    if n == 8192:
        assert ctas >= 120


def test_wide_fwd_plan_skips_cluster_sizes_the_card_cannot_hold():
    assert wide_fwd_plan(8192, 32000, {1: 132, 2: 0, 4: 128, 8: 120}) == 4
    assert wide_fwd_plan(8192, 32000, {1: 132}) == 1
    assert wide_fwd_plan(8192, 32000, {}) == 0


# -- (c) the wrapper -----------------------------------------------------------

def test_lane_names_and_wide_widths_the_wrapper_takes():
    for e in (64, MAX_E):
        assert fused_ce_lane(torch.bfloat16, torch.float32, e) \
            == "tensor_core"
        assert fused_ce_lane(torch.float32, torch.float32, e) == "cuda_core"
    for e in (MAX_E + 64, 4096, 5120, 8192):
        assert fused_ce_lane(torch.bfloat16, torch.bfloat16, e) \
            == "tensor_core_wide"
        assert fused_ce_lane(torch.float32, torch.bfloat16, e) \
            == "cuda_core_wide"
    lab = torch.empty(8, dtype=torch.int32, device="meta")
    h = torch.empty(8, 4096, dtype=torch.bfloat16, device="meta")
    w = torch.empty(V, 4096, dtype=torch.bfloat16, device="meta")
    # a wide E passes every check but the device's (a meta tensor has no
    # kernel and no plain version)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ce._check("fused_ce_dw", h, w, lab)
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_ce._check("fused_ce_dw", h[:, :4064], w[:, :4064], lab)


@pytest.mark.parametrize("e,plan", [(832, (2, 7, 1)), (1024, (2, 8, 1)),
                                    (1088, (4, 5, 1)), (2048, (4, 8, 1)),
                                    (2112, (8, 5, 1)), (4096, (8, 8, 1)),
                                    (5120, (8, 10, 2)), (8192, (8, 16, 2))])
def test_wide_plan_cluster_slice_and_groups(e, plan):
    """The cluster, slice and E-groups of the wide tensor-core dH / dW:
    every CTA sums s over at most 8 chunks below 4,096 columns (no
    recompute), the slices cover E once, and past 4,096 columns each of
    ceil(E / 4,096) E-groups outputs at most 8 chunks a CTA."""
    c, p, groups = wide_plan(e)
    assert (c, p, groups) == plan
    chunks = e // 64
    assert c * p >= chunks > (c // 2) * 8 or c == 2
    assert groups == -(-chunks // 64) and p <= 8 * groups


@pytest.mark.parametrize("e", [MAX_E, 832])
def test_dw_gets_w_cast_once_on_the_wide_lane_only(e):
    """bf16 h with an fp32 w: the forward and dH get w cast to bf16 on
    both tensor-core lanes; dW reads w in its own dtype on the narrow
    lane and gets it cast on the wide one (its wgmma operands are bf16).
    fp32 h passes w through."""
    rng = np.random.default_rng(4)
    w32 = torch.from_numpy(rng.normal(size=(16, e)).astype(np.float32))
    h16 = torch.zeros(4, e, dtype=torch.bfloat16)
    for which in ("fwd", "dh", "dw"):
        got = fused_ce._launch_w(h16, w32, which)
        if which == "dw" and e <= MAX_E:
            assert got is w32
        else:
            assert got.dtype == torch.bfloat16 \
                and torch.equal(got, w32.to(torch.bfloat16))
        assert fused_ce._launch_w(torch.zeros(4, e), w32, which) is w32


# -- (d) Llama through the fused loss ------------------------------------------

VOCAB = 8269


def _llama(seed=3):
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), vocab_size=VOCAB,
                               num_layers=1)
    cfg = dataclasses.replace(LlamaConfig.tiny(), vocab_size=VOCAB,
                              num_layers=1)
    jmodel = JaxLlama(jcfg)
    params = jmodel.init(jax.random.key(seed), dtype=jnp.float32)
    model = LlamaLMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), cfg))
    return jmodel, params, model, cfg


def _batch(seed=4, b=2, s=24):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (b, s + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


@pytest.fixture
def fused_only(monkeypatch):
    """The port's fused loss, and no chunked loss on its side."""
    monkeypatch.setenv("HETU_LM_LOSS_IMPL", "fused")

    def no_chunks(*a, **kw):
        raise AssertionError("the fused path ran the chunked loss")

    monkeypatch.setattr(losses_mod, "chunked_lm_loss", no_chunks)


def test_llama_fused_loss_and_every_grad_match_jax(fused_only):
    jmodel, params, model, cfg = _llama()
    batch = _batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jnp.asarray(batch["input_ids"]),
                              jnp.asarray(batch["labels"]))))(params)
    want = grads_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jgrads), cfg)
    loss = model.loss(torch.from_numpy(batch["input_ids"]),
                      torch.from_numpy(batch["labels"]), remat="selective")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_llama_fused_train_steps_match_jax(fused_only):
    """Two AdamW steps of the port's ``build_train_step`` against
    ``hetu_tpu``'s on one batch: the loss at 1e-5 each step, the grad norm
    at rtol 1e-4 (``tests/test_torch_trainer.py``'s lockstep bound: the
    grads agree at 1e-5 absolute, which leaves the norm of the 8,269-row
    head's grad 3.8e-5 apart on this draw)."""
    jmodel, params, model, _ = _llama(seed=5)
    batch = _batch(seed=6)
    jopt = jax_optim.adamw(1e-3, weight_decay=0.01)
    jplan = jax_make_plan(jmodel, jopt, JaxStrategy(remat="selective"),
                          devices=jax.devices()[:1])
    jstate = jax_init_state(jmodel, jopt, jplan, jax.random.key(0),
                            dtype=jnp.float32)
    jstate = jstate._replace(params=jax.device_put(
        params, jplan.state_shardings.params))
    jstep = jax_build_train_step(jmodel, jopt, jplan)
    jbatch = jplan.shard_batch({k: jnp.asarray(v) for k, v in batch.items()})
    opt = optim.adamw(1e-3, weight_decay=0.01)
    plan = make_plan(model, opt, Strategy(remat="selective"), device="cpu")
    state = init_state(model, opt, plan)
    step = build_train_step(model, opt, plan)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
