"""The port's multi-tenant host plane (``serving/tenancy.py``, the adapter
tags of the prefix cache and the spill entry, ``size_adapter_arena``)
against ``hetu_tpu``'s: every quick-tier case of ``tests/test_tenancy.py``
but the dist-ckpt round trip, run as one call sequence through both
packages on one fake clock. Each step records what it returned (pages,
uids, versions, evictions, throttle reasons, error types): the two traces
must be equal, and the port's must read as JAX's test asserts."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.engine.memory import size_adapter_arena as jax_arena
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPT
from hetu_tpu.models import LlamaConfig as JaxLlamaConfig
from hetu_tpu.peft import LoraConfig as JaxLoraConfig
from hetu_tpu.peft import inject_lora as jax_inject_lora
from hetu_tpu.peft import wrap_params_for_lora as jax_wrap
from hetu_tpu.serving import kv_pool as jax_kv_pool
from hetu_tpu.serving import prefix_cache as jax_prefix_cache
from hetu_tpu.serving import tenancy as jax_tenancy

from hetu_tpu_torch.engine.memory import size_adapter_arena
from hetu_tpu_torch.models import (
    GPTConfig, GPTLMHeadModel, LlamaConfig, params_from_jax,
)
from hetu_tpu_torch.peft import LoraConfig, inject_lora
from hetu_tpu_torch.serving import kv_pool, prefix_cache, tenancy

torch.set_num_threads(2)

BOTH = {"jax": (jax_tenancy, jax_prefix_cache, jax_kv_pool),
        "port": (tenancy, prefix_cache, kv_pool)}


def _w(r=2, layers=2, d=8, projs=("q_proj",)):
    return {p: {"A": np.ones((layers, d, r), np.float32),
                "B": np.ones((layers, r, d), np.float32)}
            for p in projs}


def _both(scenario):
    """Run ``scenario(modules)`` for JAX and the port; their traces must
    be equal. Returns the port's."""
    want = scenario(BOTH["jax"])
    got = scenario(BOTH["port"])
    assert got == want
    return got


def _raises(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:      # noqa: BLE001 - the type is the reading
        return type(e).__name__
    return None


def test_registry_lru_with_refcounts():
    def run(mods):
        ten = mods[0]
        clock = [0.0]
        reg = ten.AdapterRegistry(max_adapters=3, r=4,
                                  clock=lambda: clock[0])
        writes = []
        reg.on_page_write = lambda page, spec: writes.append(
            (page, None if spec is None else spec.uid))
        for t in ("a", "b", "c"):
            reg.register(t, "x", _w())
        sa = reg.acquire("a", "x")
        clock[0] = 1.0
        sb = reg.acquire("b", "x")
        trace = [sa.page, sb.page, reg.pages_in_use, reg.can_load(),
                 _raises(reg.ensure_resident, "c", "x")]
        reg.release(sa)
        clock[0] = 2.0
        trace.append(reg.can_load())
        sc = reg.acquire("c", "x")
        trace += [sc.page, sa.page, reg.resident("c", "x"),
                  reg.resident("a", "x"), list(writes)]
        reg.release(sb), reg.release(sc)
        stats = reg.stats()
        trace.append({k: stats[k] for k in ("adapters", "pages_in_use",
                                            "pages_free", "pages_total",
                                            "pinned")})
        return trace

    tr = _both(run)
    assert {tr[0], tr[1]} == {1, 2} and tr[2] == 2 and not tr[3]
    assert tr[4] == "AdapterArenaFull"
    assert tr[5] and tr[6] == 1 and tr[7] is None and tr[8] and not tr[9]
    assert tr[10] == [(1, 1), (2, 2), (1, None), (1, 3)]


def test_registry_version_push_fresh_uid_and_stale_drain():
    def run(mods):
        reg = mods[0].AdapterRegistry(max_adapters=4, r=4)
        v1 = reg.register("t", "x", _w())
        pinned = reg.acquire("t", "x")
        v2 = reg.register("t", "x", _w())
        trace = [pinned is v1, v1.page, v2.uid != v1.uid, v2.version,
                 v1.version, v1.stale, v2.stale]
        reg.release(v1)
        trace += [v1.page, reg.acquire("t", "x") is v2, v2.page]
        return trace

    tr = _both(run)
    assert tr[0] and tr[1] is not None and tr[2] and tr[3] == tr[4] + 1
    assert tr[5] and not tr[6] and tr[7] is None and tr[8]


def test_kv_tag_mlp_only_shares_base_prefix():
    def run(mods):
        ten = mods[0]
        reg = ten.AdapterRegistry(max_adapters=4, r=4)
        attn = reg.register("t", "attn", _w(projs=("q_proj", "fc_in")))
        mlp = reg.register("t", "mlp", _w(projs=("fc_in", "gate_proj")))
        return [reg.kv_tag(None), reg.kv_tag(attn), attn.uid,
                reg.kv_tag(mlp), attn.attention_targeting,
                mlp.attention_targeting]

    tr = _both(run)
    assert tr[0] == 0 and tr[1] == tr[2] and tr[3] == 0
    assert tr[4] and not tr[5]


def test_registry_rank_pad_scaling_fold_and_errors():
    def run(mods):
        ten = mods[0]
        reg = ten.AdapterRegistry(max_adapters=4, r=4)
        spec = reg.register("t", "x", _w(r=2), scaling=3.0)
        a, b = spec.weights["q_proj"]["A"], spec.weights["q_proj"]["B"]
        return [a.shape, b.shape, a.tolist(), b.tolist(),
                _raises(reg.register, "t", "big", _w(r=5)),
                _raises(reg.register, "t", "none", {}),
                _raises(reg.register, "t", "bad",
                        {"q_proj": {"A": np.ones((2, 8, 2)),
                                    "B": np.ones((3, 2, 8))}}),
                _raises(ten.AdapterRegistry, max_adapters=1),
                _raises(ten.AdapterRegistry, r=0),
                _raises(reg.get, "t", "nope"),
                spec.targets]

    tr = _both(run)
    a, b = np.asarray(tr[2]), np.asarray(tr[3])
    assert a.shape[-1] == 4 and b.shape[1] == 4
    np.testing.assert_allclose(b[:, :2], 3.0)
    np.testing.assert_allclose(a[..., 2:], 0.0)
    np.testing.assert_allclose(b[:, 2:], 0.0)
    assert tr[4:10] == ["ValueError"] * 5 + ["KeyError"]


def test_token_bucket_rate_limit():
    def run(mods):
        clock = [0.0]
        qos = mods[0].TenantQoS(clock=lambda: clock[0])
        qos.configure("t", rate=2.0, burst=2)
        trace = [qos.check("t")]
        qos.on_admit("t"), qos.on_admit("t")
        trace.append(qos.check("t"))
        clock[0] = 0.5
        trace.append(qos.check("t"))
        qos.on_admit("t")
        trace.append(qos.check("t"))
        clock[0] = 10.0
        qos.on_admit("t"), qos.on_admit("t")
        trace += [qos.check("t"), qos.check("other"), qos.check(None)]
        qos.configure("u", rate=0.5)
        trace += [qos.policy("u").bucket_depth(), qos.check("u")]
        qos.on_admit("u")
        trace.append(qos.check("u"))
        return trace

    assert _both(run) == [None, "rate", None, "rate", "rate", None, None,
                          1.0, None, "rate"]


def test_slot_cap_and_release():
    def run(mods):
        qos = mods[0].TenantQoS()
        qos.configure("t", max_slots=2)
        qos.on_admit("t"), qos.on_admit("t")
        trace = [qos.active_slots("t"), qos.check("t")]
        qos.on_finish("t")
        trace.append(qos.check("t"))
        qos.on_finish("t"), qos.on_finish("t")
        trace.append(qos.active_slots("t"))
        plane = mods[0].TenantPlane(max_adapters=3, r=2, qos=qos)
        trace += [plane.max_adapters, plane.r, plane.qos is qos]
        return trace

    assert _both(run) == [2, "slots", None, 0, 3, 2, True]


def test_prefix_cache_refuses_cross_adapter_hit():
    def run(mods):
        _, pc, kv = mods
        mgr = kv.BlockManager(10)
        cache = pc.PrefixCache(4, mgr)
        toks = [1, 2, 3, 4, 5, 6, 7, 8]
        b1, b2 = mgr.alloc(), mgr.alloc()
        cache.insert(toks, [b1, b2], adapter=7)
        mgr.release(b1), mgr.release(b2)
        trace = [cache.match(toks, adapter=7), cache.match(toks),
                 cache.match(toks, adapter=8),
                 cache.match(toks[:6] + [99], adapter=7),
                 cache.match(toks[:6] + [99])]
        b3, b4 = mgr.alloc(), mgr.alloc()
        cache.insert(toks, [b3, b4])
        mgr.release(b3), mgr.release(b4)
        trace += [cache.match(toks), cache.match(toks, adapter=7),
                  cache.flush_adapter(0), cache.flush_adapter(7),
                  cache.match(toks, adapter=7), cache.match(toks),
                  int(mgr.refs[b1]), int(mgr.refs[b2])]
        return trace

    tr = _both(run)
    assert tr[1] == ([], None) and tr[2] == ([], None)
    assert tr[3][1] is not None and tr[4] == ([], None)
    assert tr[7:10] == [0, 2, ([], None)] and tr[11:] == [0, 0]


def test_spill_entry_refuses_cross_adapter_resume():
    """The same compatibility answers from JAX's pool and the port's."""
    def run(mods):
        kv = mods[2]
        if mods is BOTH["jax"]:
            pool = kv.KVPool(JaxGPT(JaxGPTConfig.tiny()), slots=2,
                             max_len=32, block_size=8)
            data = tuple(np.zeros((c.shape[0], 1) + tuple(c.shape[2:]),
                                  np.asarray(c).dtype) for c in pool.caches)
            extra = dict(weight_version=0)
        else:
            pool = kv.KVPool(GPTLMHeadModel(GPTConfig.tiny(), device="cpu"),
                             2, 32, 8, None)
            data = tuple(torch.zeros((c.shape[0], 1) + tuple(c.shape[2:]),
                                     dtype=c.dtype) for c in pool.caches)
            extra = dict(weight_version=0)
        entry = kv.SpillEntry(req_id=0, data=data, n_blocks=1,
                              block_size=8, pos=4, last_tok=1, tokens=[1],
                              adapter=7, **extra)
        base = dataclasses.replace(entry, adapter=0)
        return [entry.compatible_with(pool, 0, adapter=7),
                entry.compatible_with(pool, 0),
                entry.compatible_with(pool, 0, adapter=8),
                base.compatible_with(pool, 0),
                base.compatible_with(pool, 0, adapter=7)]

    assert _both(run) == [True, False, False, True, False]


@pytest.mark.parametrize("name", ["gpt_tiny", "gpt2_small", "llama_tiny",
                                  "llama_7b", "moe_8e"])
@pytest.mark.parametrize("r,pages", [(4, 4), (16, 4), (8, 8)])
def test_adapter_arena_sizing_equals_jax(name, r, pages):
    jcfg = {"gpt_tiny": JaxGPTConfig.tiny(), "gpt2_small":
            JaxGPTConfig.small(), "llama_tiny": JaxLlamaConfig.tiny(),
            "llama_7b": JaxLlamaConfig.llama_7b(),
            "moe_8e": JaxGPTConfig.moe_8e()}[name]
    cls = LlamaConfig if "llama" in name else GPTConfig
    cfg = cls(**{f.name: getattr(jcfg, f.name)
                 for f in dataclasses.fields(cls)})
    got = size_adapter_arena(cfg, r=r, max_adapters=pages)
    assert got == jax_arena(jcfg, r=r, max_adapters=pages) > 0
    if name == "llama_7b" and (r, pages) == (16, 4):
        assert got == 639_631_360          # the 0.64 GB of the card's cell


def test_extract_adapter_equals_jax():
    """``extract_adapter`` of the port's injected model (carried over
    from a JAX LoRA tree with random B) is JAX's of that tree; the
    scaling is ``alpha / r``."""
    jcfg = JaxGPTConfig.tiny()
    jmodel = JaxGPT(jcfg)
    base = jmodel.init(jax.random.key(0), dtype=jnp.float32)
    lc = dict(r=4, alpha=8.0, num_tasks=2,
              target_patterns=(r"\.(q_proj|v_proj|fc_in)$",))
    jax_inject_lora(jmodel, JaxLoraConfig(**lc))
    lp = jax_wrap(jmodel, base, jax.random.key(1), dtype=jnp.float32)
    lp = jax.tree.map(lambda a: np.asarray(a, np.float32), lp)
    rng = np.random.default_rng(3)
    for proj in ("q_proj", "v_proj"):
        b = lp["blocks"]["attn"][proj]["lora_B"]
        lp["blocks"]["attn"][proj]["lora_B"] = rng.normal(
            0, 0.02, b.shape).astype(np.float32)
    cfg = GPTConfig.tiny()
    model = GPTLMHeadModel(cfg, device="cpu")
    inject_lora(model, LoraConfig(**lc))
    model.load_state_dict(params_from_jax(lp, cfg))
    for task in (0, 1):
        want = jax_tenancy.extract_adapter(lp, task_id=task)
        got = tenancy.extract_adapter(model.state_dict(), task_id=task)
        assert sorted(got) == sorted(want) == ["fc_in", "q_proj", "v_proj"]
        for proj in want:
            for k in ("A", "B"):
                np.testing.assert_array_equal(got[proj][k], want[proj][k])
    assert tenancy.lora_scaling(model) == 2.0
    with pytest.raises(ValueError, match="no lora_A"):
        tenancy.extract_adapter(GPTLMHeadModel(cfg, device="cpu")
                                .state_dict())
