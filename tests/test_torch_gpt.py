"""The port's GPT-2 decode path against ``hetu_tpu``'s on the same weights.

One ``hetu_tpu`` parameter tree (``GPTConfig.tiny``, fp32) is carried
into the port with ``params_from_jax``; token ids and positions are made
with numpy from a seed and handed to both. Logits are compared at atol
1e-5 (fp32 on both sides, sums taken in different orders); greedy tokens
must be identical.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import generation as jax_gen
from hetu_tpu.utils.checkpoint import _flatten

from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, decode, generate, init_kv_caches,
    params_from_jax,
)

torch.set_num_threads(2)

ATOL = 1e-5
LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc_in", "fc_out")


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxGPTConfig.tiny()
    jmodel = JaxGPT(jcfg)
    params = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    cfg = GPTConfig.tiny()
    model = GPTLMHeadModel(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    return jmodel, params, model


def test_params_from_jax_round_trips_every_key(pair):
    jmodel, params, model = pair
    cfg = model.cfg
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    state = model.state_dict()
    seen = set()
    for key, arr in flat.items():
        if key.startswith("blocks."):
            rest = key[len("blocks."):]
            for i in range(cfg.num_layers):
                want = arr[i]
                if rest.split(".")[-2] in LINEARS \
                        and rest.endswith(".weight"):
                    want = want.T
                got = state[f"blocks.{i}.{rest}"].numpy()
                np.testing.assert_array_equal(got, want)
                seen.add(f"blocks.{i}.{rest}")
        else:
            np.testing.assert_array_equal(state[key].numpy(), arr)
            seen.add(key)
    assert seen == set(state)
    # the flattened checkpoint form converts to the same state dict
    again = params_from_jax(flat, cfg)
    assert set(again) == set(state)
    for key, t in again.items():
        assert torch.equal(t, state[key])


def test_decode_dense_matches_jax(pair):
    jmodel, params, model = pair
    rng = np.random.default_rng(0)
    b, s, max_len = 2, 7, 16
    ids = rng.integers(0, model.cfg.vocab_size, (b, s + 2))
    jc = jax_gen.init_kv_caches(jmodel, b, max_len)
    tc = init_kv_caches(model, b, max_len)
    # a prefill chunk, then two single-token steps at a shared index
    for lo, hi in ((0, s), (s, s + 1), (s + 1, s + 2)):
        pos = np.broadcast_to(np.arange(lo, hi)[None], (b, hi - lo))
        want, jc = jax_gen.decode(jmodel, params, jnp.asarray(ids[:, lo:hi]),
                                  jnp.asarray(pos), jc)
        got = decode(model, torch.from_numpy(ids[:, lo:hi]),
                     torch.from_numpy(np.ascontiguousarray(pos)), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL)
    for a, t in zip(jc, tc):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=ATOL)


def test_decode_paged_matches_jax(pair):
    """Per-row paged decode: three slots at their own depths through
    scattered block tables (null-block pad lanes), one slot masked off."""
    jmodel, params, model = pair
    rng = np.random.default_rng(1)
    S, bs, W, n_blocks = 3, 4, 4, 13
    tbl = np.zeros((S, W), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    tbl[0, :3] = perm[0:3]
    tbl[1, :2] = perm[3:5]
    tbl[2, :4] = perm[5:9]
    depth = np.array([9, 5, 12])
    slot_mask = np.array([True, True, False])
    jc = jax_gen.init_kv_caches(jmodel, n_blocks, bs)
    tc = init_kv_caches(model, n_blocks, bs)
    for t in range(3):
        ids = rng.integers(0, model.cfg.vocab_size, (S, 1))
        pos = (depth + t)[:, None]
        want, jc = jax_gen.decode(
            jmodel, params, jnp.asarray(ids), jnp.asarray(pos), jc,
            slot_mask=jnp.asarray(slot_mask), block_tables=jnp.asarray(tbl))
        got = decode(model, torch.from_numpy(ids), torch.from_numpy(pos), tc,
                     slot_mask=torch.from_numpy(slot_mask),
                     block_tables=torch.from_numpy(tbl))
        live = slot_mask
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], atol=ATOL)
    for a, t in zip(jc, tc):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=ATOL)


@pytest.mark.parametrize("s,new", [(5, 6), (11, 3)])
def test_generate_greedy_matches_jax(pair, s, new):
    jmodel, params, model = pair
    rng = np.random.default_rng(10 + s)
    ids = rng.integers(0, model.cfg.vocab_size, (2, s))
    want = np.asarray(jax_gen.generate(jmodel, params, jnp.asarray(ids),
                                       max_new_tokens=new))
    got = generate(model, torch.from_numpy(ids), max_new_tokens=new,
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampled_replays_from_its_generator(pair):
    """A sampled run is a function of its generator's seed."""
    _, _, model = pair
    ids = torch.tensor([[3, 1, 4, 1, 5]])
    kw = dict(max_new_tokens=6, temperature=0.8, top_k=20, top_p=0.9,
              device="cpu")
    a = generate(model, ids, generator=torch.Generator().manual_seed(7),
                 **kw)
    b = generate(model, ids, generator=torch.Generator().manual_seed(7),
                 **kw)
    assert torch.equal(a, b)
    assert a.shape == (1, 11)
