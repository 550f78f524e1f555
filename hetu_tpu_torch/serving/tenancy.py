"""Multi-tenant adapter serving plane: host-side state (counterpart of
``hetu_tpu/serving/tenancy.py``).

Many tenants share one base model; each tenant's LoRA adapters live in
a device-resident *arena* of fixed-shape pages so the engine's captured
lanes never re-capture when adapters load, evict, or mix within a batch
(Punica / S-LoRA shaped batched-gather LoRA, "BGMV").  This module is
the host half of that plane:

* :class:`AdapterRegistry` — tenant → (adapter name, version) → arena
  page.  Pages are refcounted by admitted requests and evicted LRU
  among idle pages; every load gets a fresh monotonic *uid* so a stale
  version can never alias a reused page (the same trick
  ``PrefixCache`` / ``SpillEntry`` play with weight versions).
* :class:`TenantQoS` — per-tenant token-bucket rate limits and
  concurrent-slot caps, enforced at admission on the deficit
  scheduler so a noisy neighbour cannot starve other tenants' TTFT.
* :class:`TenantPlane` — the facade the engine mounts (registry + QoS
  + per-tenant ledgers).
* :func:`extract_adapter` — pull stacked per-layer A/B pages out of a
  ``peft.lora``-wrapped model's state dict.

Everything here is plain numpy + bookkeeping; the engine owns the
device arena and rewrites pages via ``registry.on_page_write``.

Telemetry is ``hetu_tpu``'s: page loads and evictions count into
``adapter_loads_total`` / ``adapter_evictions_total`` with their flight
events (``adapter_load``, ``adapter_evict``), and the engine's throttles
and admissions into ``tenant_throttled_total`` / ``tenant_requests_total``
(:meth:`TenantPlane.count`). The host ledgers count the same with
telemetry off: :meth:`AdapterRegistry.stats` (loads, evictions) and
:attr:`TenantPlane.ledgers` (throttles, arena waits, admissions per
tenant). Not ported: ``save_adapter_distributed`` and
``load_adapter_distributed`` (they ride the dist-ckpt transport).

Page 0 is the base model: an all-zero page whose delta is exactly
``0.0``, so adapter id 0 decodes bitwise identical to a build without
tenancy.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.telemetry.flight import flight_record

# Projections whose adapters perturb the written KV (q/k/v write the
# cache directly; out_proj changes this block's output and therefore
# every later block's K/V).  fc_*/gate/up adapters change hidden
# states too, but only *after* the first block — the registry treats
# MLP-only adapters as base-KV-compatible (the S-LoRA sharing rule,
# ``hetu_tpu``'s default): their requests map base-written prefix
# blocks, whose K/V past the first layer the adapter's FFN delta would
# have changed.  That approximation is the reference's, kept as is.
ATTN_TARGETS = frozenset({"q_proj", "k_proj", "v_proj", "out_proj"})
MLP_TARGETS = frozenset({"fc_in", "fc_out", "gate_proj", "up_proj"})
DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "out_proj",
                   "fc_in", "fc_out", "gate_proj", "up_proj")


class AdapterArenaFull(RuntimeError):
    """Every arena page is pinned by in-flight requests; the request
    must wait at admission (counted in the plane's ``adapter_waits``)
    instead of failing."""


@dataclasses.dataclass
class AdapterSpec:
    """One loaded (tenant, name, version) adapter.

    ``weights`` maps projection name → ``{"A": (L, in, r), "B":
    (L, r, out)}`` float32 host arrays, already padded to the arena
    rank and with the LoRA scaling folded into B, so the device lane
    is a pure pair of einsums with no per-adapter scalars.
    """
    tenant: str
    name: str
    version: int
    uid: int
    r: int
    targets: Tuple[str, ...]
    weights: Dict[str, Dict[str, np.ndarray]]
    page: Optional[int] = None
    refs: int = 0
    last_use: float = 0.0
    stale: bool = False

    @property
    def attention_targeting(self) -> bool:
        return bool(set(self.targets) & ATTN_TARGETS)

    @property
    def key(self) -> Tuple[str, str]:
        return (self.tenant, self.name)


class AdapterRegistry:
    """Tenant → adapter → arena page, with refcounted LRU eviction.

    The registry only does bookkeeping over host mirrors; whenever a
    page's contents change it calls ``on_page_write(page, spec_or_None)``
    so the owner (the engine) can rewrite the device arena slice in
    place — shapes and addresses never change, so the captured lanes
    never re-capture.
    """

    def __init__(self, *, max_adapters: int = 8, r: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if max_adapters < 2:
            raise ValueError("max_adapters must be >= 2 "
                             "(page 0 is reserved for the base model)")
        if r < 1:
            raise ValueError("adapter rank must be >= 1")
        self.max_adapters = int(max_adapters)
        self.r = int(r)
        self._clock = clock
        self._lock = threading.RLock()
        # Latest version per (tenant, name); stale versions leave this
        # map but stay in _resident until their refs drain.
        self._store: Dict[Tuple[str, str], AdapterSpec] = {}
        self._resident: Dict[int, AdapterSpec] = {}
        self._free = set(range(1, self.max_adapters))
        self._next_uid = 1
        self.on_page_write = None  # callable(page, spec | None)
        self.loads_total = 0       # host ledgers
        self.evictions_total = 0

    # -- registration ------------------------------------------------

    def register(self, tenant: str, name: str,
                 weights: Dict[str, Dict[str, np.ndarray]], *,
                 scaling: float = 1.0) -> AdapterSpec:
        """Install (or replace) a tenant's adapter.

        ``weights``: projection → ``{"A": (L, in, ra), "B":
        (L, ra, out)}``; ``ra`` may be smaller than the arena rank
        (zero-padded — mathematically exact) but never larger.
        Replacing an existing (tenant, name) marks the old version
        stale: a resident idle page is flushed immediately, a pinned
        page drains when its last in-flight request releases.  The new
        version is the old one + 1 (1 for a first load) and gets a
        fresh uid, so version-tagged caches can never serve the old
        weights.
        """
        folded = self._fold(weights, scaling)
        with self._lock:
            prev = self._store.get((tenant, name))
            spec = AdapterSpec(
                tenant=tenant, name=name,
                version=prev.version + 1 if prev is not None else 1,
                uid=self._next_uid, r=self.r,
                targets=tuple(sorted(folded)), weights=folded)
            self._next_uid += 1
            if prev is not None:
                self._retire_locked(prev)
            self._store[(tenant, name)] = spec
            return spec

    def deregister(self, tenant: str, name: str) -> None:
        with self._lock:
            prev = self._store.pop((tenant, name), None)
            if prev is not None:
                self._retire_locked(prev)

    def _retire_locked(self, spec: AdapterSpec) -> None:
        spec.stale = True
        if spec.page is not None and spec.refs == 0:
            self._evict_locked(spec)

    def _fold(self, weights, scaling):
        folded: Dict[str, Dict[str, np.ndarray]] = {}
        if not weights:
            raise ValueError("adapter has no LoRA-bearing projections")
        for proj, ab in sorted(weights.items()):
            a = np.asarray(ab["A"], dtype=np.float32)
            b = np.asarray(ab["B"], dtype=np.float32)
            if a.ndim != 3 or b.ndim != 3:
                raise ValueError(
                    f"{proj}: expected stacked (layers, in, r)/(layers,"
                    f" r, out) arrays, got {a.shape} / {b.shape}")
            ra = a.shape[-1]
            if ra != b.shape[1] or a.shape[0] != b.shape[0]:
                raise ValueError(f"{proj}: A {a.shape} and B {b.shape} "
                                 "disagree on rank or layer count")
            if ra > self.r:
                raise ValueError(
                    f"{proj}: adapter rank {ra} exceeds arena rank "
                    f"{self.r}")
            if ra < self.r:  # zero-pad to arena rank — exact
                a = np.concatenate(
                    [a, np.zeros(a.shape[:2] + (self.r - ra,),
                                 np.float32)], axis=-1)
                b = np.concatenate(
                    [b, np.zeros((b.shape[0], self.r - ra, b.shape[2]),
                                 np.float32)], axis=1)
            folded[proj] = {"A": a, "B": b * np.float32(scaling)}
        return folded

    # -- residency ---------------------------------------------------

    def get(self, tenant: str, name: str) -> AdapterSpec:
        with self._lock:
            spec = self._store.get((tenant, name))
            if spec is None:
                raise KeyError(f"unknown adapter {tenant}/{name}")
            return spec

    def has(self, tenant: str, name: str) -> bool:
        with self._lock:
            return (tenant, name) in self._store

    def resident(self, tenant: str, name: str) -> bool:
        """True when the latest version is already on an arena page —
        the router's adapter-affinity signal."""
        with self._lock:
            spec = self._store.get((tenant, name))
            return spec is not None and spec.page is not None

    def ensure_resident(self, tenant: str, name: str) -> AdapterSpec:
        """Give the latest (tenant, name) an arena page, evicting an
        idle LRU page if needed.  Raises :class:`AdapterArenaFull`
        when every page is pinned by in-flight requests."""
        with self._lock:
            spec = self.get(tenant, name)
            if spec.page is None:
                self._load_locked(spec)
            return spec

    def can_load(self) -> bool:
        """True when :meth:`ensure_resident` of a non-resident adapter
        would succeed right now: a free page exists, or an idle
        (refs == 0) resident can be evicted.  The engine's admission
        gate defers adapter requests while this is False instead of
        letting admission hit :class:`AdapterArenaFull`."""
        with self._lock:
            return bool(self._free) \
                or self._lru_idle_locked() is not None

    def acquire(self, tenant: str, name: str) -> AdapterSpec:
        """Admission-side pin: make resident and take a reference."""
        with self._lock:
            spec = self.ensure_resident(tenant, name)
            spec.refs += 1
            spec.last_use = self._clock()
            return spec

    def release(self, spec: AdapterSpec) -> None:
        with self._lock:
            spec.refs = max(0, spec.refs - 1)
            spec.last_use = self._clock()
            if spec.stale and spec.refs == 0 and spec.page is not None:
                self._evict_locked(spec)

    def _load_locked(self, spec: AdapterSpec) -> None:
        if self._free:
            page = min(self._free)
            self._free.discard(page)
        else:
            victim = self._lru_idle_locked()
            if victim is None:
                raise AdapterArenaFull(
                    f"all {self.max_adapters - 1} adapter pages are "
                    "pinned by in-flight requests")
            page = victim.page
            self._evict_locked(victim)
            self._free.discard(page)
        spec.page = page
        spec.last_use = self._clock()
        self._resident[page] = spec
        self.loads_total += 1
        telemetry.get_registry().counter(
            "adapter_loads_total", "adapter arena page loads").inc()
        flight_record("adapter_load", tenant=spec.tenant,
                      name=spec.name, version=spec.version,
                      uid=spec.uid, page=page)
        if self.on_page_write is not None:
            self.on_page_write(page, spec)

    def _lru_idle_locked(self) -> Optional[AdapterSpec]:
        idle = [s for s in self._resident.values() if s.refs == 0]
        if not idle:
            return None
        return min(idle, key=lambda s: s.last_use)

    def _evict_locked(self, spec: AdapterSpec) -> None:
        page = spec.page
        if page is None:
            return
        self._resident.pop(page, None)
        self._free.add(page)
        spec.page = None
        self.evictions_total += 1
        telemetry.get_registry().counter(
            "adapter_evictions_total", "adapter arena page evictions").inc()
        flight_record("adapter_evict", tenant=spec.tenant,
                      name=spec.name, version=spec.version,
                      uid=spec.uid, page=page)
        if self.on_page_write is not None:
            self.on_page_write(page, None)

    # -- cache-compat tags -------------------------------------------

    def kv_tag(self, spec: Optional[AdapterSpec]) -> int:
        """The adapter id that written-KV spans carry for prefix/spill
        compatibility.  0 = base-compatible: no adapter, or one
        that targets no attention projection (see ``ATTN_TARGETS``)."""
        if spec is None:
            return 0
        if not spec.attention_targeting:
            return 0
        return spec.uid

    # -- introspection ----------------------------------------------

    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return len(self._resident)

    def stats(self) -> dict:
        with self._lock:
            return {
                "adapters": len(self._store),
                "pages_in_use": len(self._resident),
                "pages_free": len(self._free),
                "pages_total": self.max_adapters - 1,
                "pinned": sum(1 for s in self._resident.values()
                              if s.refs > 0),
                "loads": self.loads_total,
                "evictions": self.evictions_total,
            }


# -- per-tenant QoS ---------------------------------------------------

@dataclasses.dataclass
class TenantPolicy:
    """Admission policy for one tenant.  ``rate`` is a token-bucket
    refill in requests/second (None = unlimited) with depth ``burst``
    (defaults to max(1, ceil(rate))); ``max_slots`` caps concurrently
    admitted decode slots."""
    rate: Optional[float] = None
    burst: Optional[int] = None
    max_slots: Optional[int] = None

    def bucket_depth(self) -> float:
        if self.burst is not None:
            return float(max(1, self.burst))
        if self.rate is not None:
            return float(max(1.0, float(np.ceil(self.rate))))
        return float("inf")


class TenantQoS:
    """Token-bucket rate limits + concurrent-slot caps per tenant,
    checked at admission on the deficit scheduler.  Tenants without a
    policy (and the anonymous base tenant) are unlimited."""

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 *, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._policies: Dict[str, TenantPolicy] = dict(policies or {})
        # tenant -> [tokens, last_refill_ts, active_slots]
        self._state: Dict[str, list] = {}

    def configure(self, tenant: str, *, rate: Optional[float] = None,
                  burst: Optional[int] = None,
                  max_slots: Optional[int] = None) -> None:
        with self._lock:
            self._policies[tenant] = TenantPolicy(
                rate=rate, burst=burst, max_slots=max_slots)
            self._state.pop(tenant, None)

    def policy(self, tenant: Optional[str]) -> Optional[TenantPolicy]:
        if tenant is None:
            return None
        with self._lock:
            return self._policies.get(tenant)

    def _bucket_locked(self, tenant: str, pol: TenantPolicy) -> list:
        st = self._state.get(tenant)
        now = self._clock()
        if st is None:
            st = self._state[tenant] = [pol.bucket_depth(), now, 0]
        elif pol.rate is not None:
            depth = pol.bucket_depth()
            st[0] = min(depth, st[0] + (now - st[1]) * pol.rate)
            st[1] = now
        return st

    def check(self, tenant: Optional[str]) -> Optional[str]:
        """None when the tenant may admit one more request now, else
        the throttle reason ("rate" | "slots").  Does not consume."""
        pol = self.policy(tenant)
        if pol is None:
            return None
        with self._lock:
            st = self._bucket_locked(tenant, pol)
            if pol.max_slots is not None and st[2] >= pol.max_slots:
                return "slots"
            if pol.rate is not None and st[0] < 1.0:
                return "rate"
            return None

    def on_admit(self, tenant: Optional[str]) -> None:
        pol = self.policy(tenant)
        if pol is None:
            return
        with self._lock:
            st = self._bucket_locked(tenant, pol)
            if pol.rate is not None:
                st[0] = max(0.0, st[0] - 1.0)
            st[2] += 1

    def on_finish(self, tenant: Optional[str]) -> None:
        pol = self.policy(tenant)
        if pol is None:
            return
        with self._lock:
            st = self._bucket_locked(tenant, pol)
            st[2] = max(0, st[2] - 1)

    def active_slots(self, tenant: str) -> int:
        with self._lock:
            st = self._state.get(tenant)
            return 0 if st is None else int(st[2])


class TenantPlane:
    """The facade a :class:`~hetu_tpu_torch.serving.engine.ServingEngine`
    mounts when tenancy is on: adapter registry + QoS + ledgers.

    ``ledgers`` are the engine's host counts, kept with telemetry off
    too: ``throttled`` ``{(tenant, reason): throttle episodes}``
    (``tenant_throttled_total``), ``adapter_waits`` ``{tenant: arena-
    full episodes}`` and ``admitted`` ``{tenant: admitted requests}``
    (``tenant_requests_total``); the base tenant is ``"base"``.
    :meth:`count` also counts the first and the last into the
    registry."""

    def __init__(self, registry: Optional[AdapterRegistry] = None,
                 qos: Optional[TenantQoS] = None, *,
                 max_adapters: int = 8, r: int = 8):
        self.registry = registry if registry is not None else \
            AdapterRegistry(max_adapters=max_adapters, r=r)
        self.qos = qos if qos is not None else TenantQoS()
        self.ledgers: dict = {"throttled": {}, "adapter_waits": {},
                              "admitted": {}}

    def count(self, ledger: str, key) -> None:
        book = self.ledgers[ledger]
        book[key] = book.get(key, 0) + 1
        if ledger == "throttled":
            telemetry.get_registry().counter(
                "tenant_throttled_total",
                "admissions deferred by tenant QoS (token-bucket "
                "rate or concurrent-slot cap), one per throttle "
                "episode").inc(tenant=key[0], reason=key[1])
        elif ledger == "admitted":
            telemetry.get_registry().counter(
                "tenant_requests_total",
                "admitted serving requests per tenant").inc(tenant=key)

    @property
    def max_adapters(self) -> int:
        return self.registry.max_adapters

    @property
    def r(self) -> int:
        return self.registry.r


# -- adapter extraction -----------------------------------------------

def lora_scaling(model) -> float:
    """alpha/r of the first LoRA layer in ``model`` (the scaling
    :func:`~hetu_tpu_torch.peft.lora.merge_lora` applies)."""
    from hetu_tpu_torch.peft.lora import _first_lora_scaling
    return _first_lora_scaling(model)


def extract_adapter(params, *, task_id: int = 0):
    """Pull one task's A/B factors out of a LoRA-injected model's
    ``state_dict``, stacked over the blocks.

    Returns projection → ``{"A": (L, in, r), "B": (L, r, out)}`` fp32
    host arrays, ready for :meth:`AdapterRegistry.register` (pass the
    model's ``lora_scaling`` so merge parity holds): ``hetu_tpu``'s
    layout, whose stacked ``(layers, tasks, …)`` factors the port keeps
    one block at a time (``blocks.{i}.{attn|mlp}.{proj}.lora_A``).
    """
    found: Dict[str, Dict[str, dict]] = {}
    for key, leaf in params.items():
        parts = key.split(".")
        if len(parts) != 5 or parts[0] != "blocks" \
                or parts[2] not in ("attn", "mlp") \
                or parts[4] not in ("lora_A", "lora_B"):
            continue
        f = leaf.detach().float().cpu().numpy()[task_id]
        found.setdefault(parts[3], {}).setdefault(
            parts[4][-1], {})[int(parts[1])] = f
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for proj, ab in found.items():
        out[proj] = {k: np.stack([layers[i] for i in sorted(layers)])
                     for k, layers in ab.items()}
    if not out:
        raise ValueError("params carry no lora_A/lora_B leaves — "
                         "inject_lora + wrap_params_for_lora first")
    return out
