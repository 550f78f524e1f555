"""The port's Llama path and the int8 KV lane against ``hetu_tpu``'s.

- quantization: codes and scales bit-identical to JAX (zero rows, ±.5
  ties, bf16 inputs);
- the int8 lane of the paged kernel: its plain version (what the CUDA
  kernel is held to on the card) against ``paged_attention_pallas`` in
  interpret mode. fp32: atol 1e-5 (fp32 sums in different orders). bf16
  q: both dequantize in fp32 and round the scaled q to bf16, so outputs
  differ by at most 1 bf16 ulp of the reference value (the final
  rounding of two fp32 sums taken in different orders), plus 1e-6
  absolute near 0; the fp32 lse at atol 1e-5;
- ``rms_norm``, ``swiglu``, RoPE: fp32 at atol 1e-6 (tables 1e-6);
- ``LlamaConfig.tiny`` (GQA 4/2) on one ``hetu_tpu`` tree carried over
  with ``params_from_jax``: forward logits and dense/paged decode with fp
  and int8 caches at atol 1e-5 (fp32); the int8 caches' codes may differ
  by ±1 where fp32 noise straddles a rounding boundary, in at most 0.1%
  of them (scales at rtol 1e-5); greedy ``generate`` with an int8 cache
  token-identical to JAX's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.models import LlamaLMHeadModel as JaxLlama
from hetu_tpu.models import generation as jax_gen
from hetu_tpu.ops import activations as jax_act
from hetu_tpu.ops import normalization as jax_norm
from hetu_tpu.ops import quantization as jax_quant
from hetu_tpu.ops import rotary as jax_rot
from hetu_tpu.ops.paged_pallas import paged_attention_pallas
from hetu_tpu.utils.checkpoint import _flatten

from hetu_tpu_torch.models import (
    LlamaConfig, LlamaLMHeadModel, decode, generate, init_kv_caches,
    params_from_jax,
)
from hetu_tpu_torch.ops import (
    NEG_INF, apply_rotary, dequantize_int8, paged_attention,
    paged_attention_reference, quantize_int8, rms_norm, rope_frequencies,
    swiglu,
)

torch.set_num_threads(2)

ATOL = 1e-5
NEG = np.float32(NEG_INF)
#: share of int8 codes allowed to differ by one step between the two
#: frameworks' caches (fp32 noise at a rounding boundary)
CODE_FLIP_SHARE = 1e-3
LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "gate_proj",
           "up_proj", "fc_out")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float32))
    e = np.floor(np.log2(np.maximum(x, np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


def _int8_caches_close(tc, jc):
    """(codes, scales, codes, scales): codes equal but for ±1 in at most
    CODE_FLIP_SHARE of them, scales at rtol 1e-5."""
    for i, (a, t) in enumerate(zip(jc, tc)):
        a, t = np.asarray(a), t.numpy()
        assert t.shape == a.shape and t.dtype == a.dtype
        if i % 2 == 0:
            diff = np.abs(t.astype(np.int32) - a.astype(np.int32))
            assert diff.max() <= 1
            assert (diff > 0).mean() <= CODE_FLIP_SHARE
        else:
            np.testing.assert_allclose(t, a, rtol=1e-5, atol=0)


# -- quantization -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_is_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 3, 32)).astype(np.float32) * 3
    x[1, 2] = 0.0                              # a zero row: scale 1, codes 0
    # amax 127 gives scale 1: x / scale lands exactly on .5 ties
    x[2, 0] = np.linspace(-16, 16, 32).astype(np.float32)
    x[2, 0, :6] = [127, 2.5, -3.5, 0.5, -0.5, 1.5]
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    for axis in (-1, 1):
        jq, js = jax_quant.quantize_int8(jx, axis=axis)
        tq, ts = quantize_int8(tx, axis=axis)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tq, ts = quantize_int8(tx)
    assert tq[2, 0, :6].tolist() == [127, 2, -4, 0, 0, 2]   # half to even
    assert ts[1, 2].item() == 1.0 and not tq[1, 2].any()
    for out in ("float32", "bfloat16"):
        want = jax_quant.dequantize_int8(jnp.asarray(tq.numpy()),
                                         jnp.asarray(ts.numpy()),
                                         getattr(jnp, out))
        got = dequantize_int8(tq, ts, getattr(torch, out))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


# -- the int8 lane of the paged kernel ----------------------------------------

def _int8_arena(rng, *, S=3, R=1, hq=4, hkv=2, d=16, n_blocks=9, bs=4, W=8):
    q = rng.normal(size=(S, R, hq, d)).astype(np.float32)
    k = rng.normal(size=(n_blocks, bs, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_blocks, bs, hkv, d)).astype(np.float32)
    kq, ks = (a.numpy() for a in quantize_int8(_t(k)))
    vq, vs = (a.numpy() for a in quantize_int8(_t(v)))
    # never-written rows: scale 0 (their codes dequantize to exact 0)
    ks[3, 1:3] = 0.0
    vs[3, 1:3] = 0.0
    ks[5, 0, 1] = 0.0
    vs[5, 0, 1] = 0.0
    tbl = np.zeros((S, W), np.int32)
    for s in range(S):
        # W - 1 live pages, the last lane padded with the null block
        tbl[s] = np.concatenate(
            [rng.permutation(np.arange(1, n_blocks))[:W - 1], [0]])
    return q, kq, ks, vq, vs, tbl


def _pallas_int8(q, kq, ks, vq, vs, tbl, off, dtype):
    return paged_attention_pallas(
        jnp.asarray(q).astype(dtype), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(tbl), jnp.asarray(off), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True, return_lse=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 3])
def test_paged_int8_reference_matches_pallas_interpret(R, dtype):
    rng = np.random.default_rng(2 + R)
    q, kq, ks, vq, vs, tbl = _int8_arena(rng, R=R)
    off = np.array([-1, 5, 17], np.int32)    # slot 0: empty history
    want_o, want_l = _pallas_int8(q, kq, ks, vq, vs, tbl, off,
                                  getattr(jnp, dtype))
    tq = _t(q).to(getattr(torch, dtype))
    args = (tq, _t(kq), _t(vq), _t(tbl), _t(off))
    got_o, got_l = paged_attention(*args, k_scale=_t(ks), v_scale=_t(vs),
                                   return_lse=True)
    ref_o, ref_l = paged_attention_reference(
        *args, k_scale=_t(ks), v_scale=_t(vs), return_lse=True)
    assert got_o.dtype == tq.dtype and got_l.dtype == torch.float32
    assert got_o.shape == (3, R, 4, 16) and got_l.shape == (3, 4, R)
    assert torch.equal(got_o, ref_o) and torch.equal(got_l, ref_l)
    want_o = np.asarray(want_o, np.float32)
    if dtype == "float32":
        _close(got_o, want_o)
    else:
        err = np.abs(got_o.float().numpy() - want_o)
        assert np.all(err <= _bf16_ulp(want_o) + 1e-6), err.max()
    _close(got_l, want_l)
    # row 0 of slot 0 sits at position -1: it attends nothing
    for o, lse in ((got_o.float().numpy(), got_l.numpy()),
                   (want_o, np.asarray(want_l))):
        assert np.all(o[0, 0] == 0.0)
        assert np.all(lse[0, :, 0] == NEG)


def test_paged_int8_null_block_pad_lanes_stay_masked():
    """Poisoning the null block's codes and scales (only pad lanes map
    it) changes nothing: its lanes lie past every live position."""
    rng = np.random.default_rng(5)
    q, kq, ks, vq, vs, tbl = _int8_arena(rng, R=2)
    off = np.array([3, 10, 25], np.int32)    # <= (W - 1) * bs - R
    base = paged_attention(_t(q), _t(kq), _t(vq), _t(tbl), _t(off),
                           k_scale=_t(ks), v_scale=_t(vs))
    kq2, vq2, ks2, vs2 = kq.copy(), vq.copy(), ks.copy(), vs.copy()
    kq2[0], vq2[0] = 127, -127
    ks2[0], vs2[0] = 1e3, 1e3
    got = paged_attention(_t(q), _t(kq2), _t(vq2), _t(tbl), _t(off),
                          k_scale=_t(ks2), v_scale=_t(vs2))
    assert torch.equal(got, base)
    want, _ = _pallas_int8(q, kq2, ks2, vq2, vs2, tbl, off, jnp.float32)
    _close(got, want)


def test_paged_int8_needs_both_scales():
    rng = np.random.default_rng(6)
    q, kq, ks, vq, vs, tbl = _int8_arena(rng)
    off = np.array([1, 2, 3], np.int32)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged_attention(_t(q), _t(kq), _t(vq), _t(tbl), _t(off),
                        k_scale=_t(ks))


# -- norms, activations, rotary ----------------------------------------------

def test_rms_norm_and_swiglu_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    sc = rng.normal(size=(32,)).astype(np.float32)
    _close(rms_norm(_t(x), _t(sc), eps=1e-5),
           jax_norm.rms_norm(jnp.asarray(x), jnp.asarray(sc), eps=1e-5),
           atol=1e-6)
    _close(rms_norm(_t(x), None),
           jax_norm.rms_norm(jnp.asarray(x), None), atol=1e-6)
    g, u = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    _close(swiglu(_t(g), _t(u)), jax_act.swiglu(jnp.asarray(g),
                                                jnp.asarray(u)), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_matches_jax(dtype):
    """Tables at Llama's theta, then the split-half rotation at explicit
    per-token positions (a packed row) and at the default arange."""
    jc, js = jax_rot.rope_frequencies(32, 64, theta=1e4)
    tc, ts = rope_frequencies(32, 64, theta=1e4)
    _close(tc, jc, atol=1e-6)
    _close(ts, js, atol=1e-6)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 3, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2, 0, 1, 40], [7, 8, 9, 10, 63, 5]], np.int32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    for p in (None, pos):
        want = jax_rot.apply_rotary(jx, jc, js,
                                    None if p is None else jnp.asarray(p))
        got = apply_rotary(tx, tc, ts, None if p is None else _t(p))
        assert got.dtype == tx.dtype
        atol = 1e-5 if dtype == "float32" else 1e-2
        _close(got.float(), np.asarray(want, np.float32), atol=atol)


# -- Llama tiny against hetu_tpu ---------------------------------------------

def _pair(tie: bool):
    jcfg = JaxLlamaConfig.tiny()
    cfg = LlamaConfig.tiny()
    if tie:
        import dataclasses
        jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
    jmodel = JaxLlama(jcfg)
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    model = LlamaLMHeadModel(cfg, device="cpu")
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), cfg), strict=True)
    return jmodel, params, model


@pytest.fixture(scope="module")
def pair():
    return _pair(tie=False)


@pytest.mark.parametrize("tie", [False, True])
def test_params_from_jax_round_trips_every_llama_key(tie):
    jmodel, params, model = _pair(tie)
    cfg = model.cfg
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    state = model.state_dict()
    seen = set()
    for key, arr in flat.items():
        if key.startswith("blocks."):
            rest = key[len("blocks."):]
            for i in range(cfg.num_layers):
                want = arr[i]
                if rest.split(".")[-2] in LINEARS:
                    want = want.T
                np.testing.assert_array_equal(
                    state[f"blocks.{i}.{rest}"].numpy(), want)
                seen.add(f"blocks.{i}.{rest}")
        else:
            want = arr.T if key == "lm_head.weight" else arr
            np.testing.assert_array_equal(state[key].numpy(), want)
            seen.add(key)
    assert seen == set(state)
    assert ("lm_head.weight" in state) is not tie
    assert torch.equal(model.head_weight(),
                       state["wte.weight" if tie else "lm_head.weight"])


@pytest.mark.parametrize("tie", [False, True])
def test_llama_forward_logits_match_jax(tie):
    jmodel, params, model = _pair(tie)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, model.cfg.vocab_size, (2, 11))
    want = jmodel(params, jnp.asarray(ids), attn_impl="reference")
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    _close(got, want)
    # packed positions (two documents in one row) with segment ids
    pos = np.concatenate([np.arange(5), np.arange(6)])[None].repeat(2, 0)
    seg = np.array([[0] * 5 + [1] * 6] * 2, np.int32)
    want = jmodel(params, jnp.asarray(ids), positions=jnp.asarray(pos),
                  segment_ids=jnp.asarray(seg), attn_impl="reference")
    with torch.no_grad():
        got = model(torch.from_numpy(ids), positions=torch.from_numpy(pos),
                    segment_ids=torch.from_numpy(seg))
    _close(got, want)


def _cache_dtypes(quant):
    return (jnp.int8, torch.int8) if quant else (jnp.float32, None)


@pytest.mark.parametrize("quant", [False, True])
def test_llama_decode_dense_matches_jax(pair, quant):
    jmodel, params, model = pair
    jdt, tdt = _cache_dtypes(quant)
    rng = np.random.default_rng(10)
    b, s, max_len = 2, 7, 16
    ids = rng.integers(0, model.cfg.vocab_size, (b, s + 2))
    jc = jax_gen.init_kv_caches(jmodel, b, max_len, jdt)
    tc = init_kv_caches(model, b, max_len, tdt)
    assert len(tc) == len(jc) == (4 if quant else 2)
    # a prefill chunk, then two single-token steps at a shared index
    for lo, hi in ((0, s), (s, s + 1), (s + 1, s + 2)):
        pos = np.broadcast_to(np.arange(lo, hi)[None], (b, hi - lo))
        want, jc = jax_gen.decode(jmodel, params, jnp.asarray(ids[:, lo:hi]),
                                  jnp.asarray(pos), jc)
        got = decode(model, torch.from_numpy(ids[:, lo:hi]),
                     torch.from_numpy(np.ascontiguousarray(pos)), tc)
        _close(got, want)
    if quant:
        _int8_caches_close(tc, jc)
    else:
        for a, t in zip(jc, tc):
            _close(t, a)


@pytest.mark.parametrize("quant", [False, True])
def test_llama_decode_paged_matches_jax(pair, quant):
    """Per-row paged decode (GQA): three slots at their own depths through
    scattered block tables (null-block pad lanes), one slot masked off;
    the int8 arena reads through the paged kernel's int8 lane (its plain
    version here) where JAX reads its gather twin."""
    jmodel, params, model = pair
    jdt, tdt = _cache_dtypes(quant)
    rng = np.random.default_rng(11)
    S, bs, W, n_blocks = 3, 4, 4, 13
    tbl = np.zeros((S, W), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    tbl[0, :3] = perm[0:3]
    tbl[1, :2] = perm[3:5]
    tbl[2, :4] = perm[5:9]
    depth = np.array([9, 5, 12])
    slot_mask = np.array([True, True, False])
    jc = jax_gen.init_kv_caches(jmodel, n_blocks, bs, jdt)
    tc = init_kv_caches(model, n_blocks, bs, tdt)
    for t in range(3):
        ids = rng.integers(0, model.cfg.vocab_size, (S, 1))
        pos = (depth + t)[:, None]
        want, jc = jax_gen.decode(
            jmodel, params, jnp.asarray(ids), jnp.asarray(pos), jc,
            slot_mask=jnp.asarray(slot_mask), block_tables=jnp.asarray(tbl))
        got = decode(model, torch.from_numpy(ids), torch.from_numpy(pos), tc,
                     slot_mask=torch.from_numpy(slot_mask),
                     block_tables=torch.from_numpy(tbl))
        _close(got.numpy()[slot_mask], np.asarray(want)[slot_mask])
    if quant:
        _int8_caches_close(tc, jc)
        # the masked-off slot and the null block were never written
        assert not tc[0][:, 0].any() and not tc[1][:, 0].any()
    else:
        for a, t in zip(jc, tc):
            _close(t, a)


@pytest.mark.parametrize("s,new", [(5, 6), (13, 4)])
def test_llama_generate_int8_matches_jax(pair, s, new):
    jmodel, params, model = pair
    rng = np.random.default_rng(20 + s)
    ids = rng.integers(0, model.cfg.vocab_size, (2, s))
    want = np.asarray(jax_gen.generate(jmodel, params, jnp.asarray(ids),
                                       max_new_tokens=new,
                                       cache_dtype=jnp.int8))
    got = generate(model, torch.from_numpy(ids), max_new_tokens=new,
                   device="cpu", cache_dtype=torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)
    fp = generate(model, torch.from_numpy(ids), max_new_tokens=new,
                  device="cpu")
    want_fp = np.asarray(jax_gen.generate(jmodel, params, jnp.asarray(ids),
                                          max_new_tokens=new))
    np.testing.assert_array_equal(fp.numpy(), want_fp)


def test_llama_refuses_experts_and_has_the_7b_widths():
    """Experts build on one device (SwiGLU ``MoEMLP``s); what is still
    refused is expert parallelism (slice 4)."""
    import dataclasses
    from hetu_tpu_torch.nn.moe import MoEMLP
    from hetu_tpu_torch.parallel import Strategy
    model = LlamaLMHeadModel(dataclasses.replace(LlamaConfig.tiny(),
                                                 num_experts=2),
                             device="cpu")
    assert all(isinstance(b.mlp, MoEMLP) and b.mlp.gated
               for b in model.blocks)
    with pytest.raises(NotImplementedError, match="slice 4"):
        Strategy(ep=2)
    for name in ("llama_7b", "llama_13b", "tiny"):
        ours = dataclasses.asdict(getattr(LlamaConfig, name)())
        theirs = dataclasses.asdict(getattr(JaxLlamaConfig, name)())
        assert ours == {f: theirs[f] for f in ours}
    cfg = LlamaConfig.llama_7b()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_layers, cfg.num_heads, cfg.max_positions,
            cfg.rms_norm_eps, cfg.tie_embeddings) \
        == (32000, 4096, 11008, 32, 32, 4096, 1e-5, False)


def test_llama_entry_points_refuse_a_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from hetu_tpu_torch.serving import ServingEngine
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaLMHeadModel(cfg)
    model = LlamaLMHeadModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, slots=2, max_len=32, cache_dtype=torch.int8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(model, [[1, 2, 3]], max_new_tokens=2,
                 cache_dtype=torch.int8)
