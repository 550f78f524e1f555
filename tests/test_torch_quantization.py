"""The port's quantization functions (``hetu_tpu_torch/ops/
quantization.py``) against ``hetu_tpu/ops/quantization.py``, on the CPU.

Inputs come from numpy with a seed. Tolerances:

- int8 and int4 codes, scales and dequantized values: bit-equal
  (the same fp32 arithmetic in the same order), including an ``axis``
  other than -1, all-zero rows (scale 1, codes 0) and, for int4, the
  refusal of an odd quantized axis;
- W8A8 (per call and pre-quantized): bit-equal in fp32 and after the
  cast to bf16 (an exact int32 product, rescaled in JAX's order), at
  row counts below and above the padding of ``int8_mm``;
- W8A16: its dequantized weight is bit-equal; the fp32 product of two
  frameworks sums in different orders, so it is held at rtol 1e-6 on
  random inputs and bit-equal on inputs whose every partial sum is
  exact in fp32 (small integers times a power-of-two scale).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.ops import quantization as jq

from hetu_tpu_torch.ops import quantization as tq

torch.set_num_threads(2)


def _x(shape, seed=0, zero_rows=True):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_rows:
        x[(0,) * (x.ndim - 1)] = 0.0      # one all-zero row along -1
        x[..., 0] = 0.0                   # and a zero column along the rest
    return x


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,axis", [((5, 8), -1), ((5, 8), 0),
                                        ((3, 4, 6), 1), ((2, 6, 4), -1),
                                        ((4, 2, 10), 0)])
def test_int8_round_trip_is_jax(shape, axis):
    x = _x(shape)
    q, s = tq.quantize_int8(torch.from_numpy(x), axis=axis)
    jq_, js = jq.quantize_int8(jnp.asarray(x), axis=axis)
    _eq(q, jq_)
    _eq(s, js)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize_int8(q, s, dt).float()
        _eq(got, jq.dequantize_int8(jq_, js, jdt).astype(jnp.float32))


@pytest.mark.parametrize("shape,axis", [((5, 8), -1), ((6, 5), 0),
                                        ((3, 4, 6), 1), ((2, 3, 10), -1),
                                        ((4, 3, 2), 0)])
def test_int4_pack_unpack_is_jax(shape, axis):
    """Packed bytes, scales and the unpacked values (sign extension of
    each nibble) equal JAX's; ``axis`` keeps its place in the packed
    array, at half its length."""
    x = _x(shape, seed=1) * 3.0
    p, s, n = tq.quantize_int4(torch.from_numpy(x), axis=axis)
    jp, js, jn = jq.quantize_int4(jnp.asarray(x), axis=axis)
    assert n == jn == shape[axis]
    assert p.dtype == torch.int8 and p.shape[axis] == shape[axis] // 2
    _eq(p, jp)
    _eq(s, js)
    _eq(tq.dequantize_int4(p, s, n, axis=axis),
        jq.dequantize_int4(jp, js, jn, axis=axis))
    # codes of either sign in both nibbles
    assert bool((p < 0).any()) and bool((p > 0).any())


@pytest.mark.parametrize("shape,axis", [((5, 7), -1), ((3, 4), 0)])
def test_int4_refuses_an_odd_axis(shape, axis):
    x = torch.from_numpy(_x(shape))
    with pytest.raises(ValueError, match="even quantized axis"):
        tq.quantize_int4(x, axis=axis)
    with pytest.raises(ValueError, match="even quantized axis"):
        jq.quantize_int4(jnp.asarray(x.numpy()), axis=axis)


@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (5, 13, 7), (23, 40, 24),
                                   (24, 33, 19), (70, 64, 40)])
def test_int8_mm_is_exact(m, k, n):
    """The int32 product equals an int64 matmul, with and without the
    row padding, for either layout of ``b``."""
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    bt = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    want = a.long() @ bt.long().t()
    for b in (bt.t(), bt.t().contiguous()):
        got = tq.int8_mm(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got.long(), want)


W8A8_SHAPES = [(1, 33, 19), (7, 33, 19), (3, 7, 40, 24), (30, 64, 48),
               (2, 1, 128, 16)]


@pytest.mark.parametrize("shape", W8A8_SHAPES)
def test_w8a8_matmuls_are_jax(shape):
    """Both W8A8 functions, fp32 and bf16 activations, against JAX's."""
    *lead, k, n = shape
    x = _x((*lead, k), seed=2)
    w = _x((k, n), seed=3) * 0.05
    wq, ws = jq.quantize_int8(jnp.asarray(w), axis=0)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        tx = torch.from_numpy(x).to(dt)
        jx = jnp.asarray(x, jdt)
        got = tq.int8_w8a8_matmul(tx, torch.from_numpy(w))
        want = jq.int8_w8a8_matmul(jx, jnp.asarray(w))
        assert got.dtype == dt and got.shape == tuple(want.shape)
        _eq(got.float(), want.astype(jnp.float32))
        got = tq.int8_w8a8_matmul_prequant(
            tx, torch.from_numpy(np.array(wq)),
            torch.from_numpy(np.array(ws)))
        _eq(got.float(), jq.int8_w8a8_matmul_prequant(jx, wq, ws)
            .astype(jnp.float32))
        # an fp32 output from bf16 activations (``dtype=``)
        got = tq.int8_w8a8_matmul(tx, torch.from_numpy(w),
                                  dtype=torch.float32)
        _eq(got, jq.int8_w8a8_matmul(jx, jnp.asarray(w),
                                     dtype=jnp.float32))


@pytest.mark.parametrize("shape", [(7, 33, 19), (3, 5, 64, 24)])
def test_w8a16_matches_jax(shape):
    *lead, k, n = shape
    x = _x((*lead, k), seed=4)
    w = _x((k, n), seed=5) * 0.05
    wq, ws = jq.quantize_int8(jnp.asarray(w), axis=0)
    tw = torch.from_numpy(np.array(wq))
    ts = torch.from_numpy(np.array(ws))
    got = tq.int8_matmul(torch.from_numpy(x), tw, ts)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), wq, ws))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # exact partial sums: small integers, power-of-two scales
    rng = np.random.default_rng(6)
    xi = rng.integers(-8, 9, (*lead, k)).astype(np.float32)
    qi = rng.integers(-127, 128, (k, n)).astype(np.int8)
    si = (2.0 ** rng.integers(-6, 0, (1, n))).astype(np.float32)
    got = tq.int8_matmul(torch.from_numpy(xi), torch.from_numpy(qi),
                         torch.from_numpy(si))
    _eq(got, jq.int8_matmul(jnp.asarray(xi), jnp.asarray(qi),
                            jnp.asarray(si)))
    got = tq.int8_matmul(torch.from_numpy(xi).bfloat16(),
                         torch.from_numpy(qi), torch.from_numpy(si))
    assert got.dtype == torch.bfloat16
    _eq(tq.dequantize_int8(torch.from_numpy(qi), torch.from_numpy(si),
                           torch.bfloat16).float(),
        jq.dequantize_int8(jnp.asarray(qi), jnp.asarray(si),
                           jnp.bfloat16).astype(jnp.float32))
