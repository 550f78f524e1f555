"""Continuous-batching inference engine over the block-paged KV arena
(counterpart of ``hetu_tpu/serving/engine.py``).

One engine iteration (:meth:`ServingEngine.step`) is, in order:

1. admission: queued requests take free slots when their worst case fits
   in free blocks net of the radix prefix cache (a cached prefix is
   mapped into the slot's table; a partial tail block is copied — CoW);
   then at most one preemption — when the head the scheduler would admit
   next is still blocked and a strictly lower-priority request is
   decoding, that victim's blocks are copied to the host spill arena,
   its slot and blocks are freed and it is requeued at the head — and a
   second admission pass in the same iteration; then at most one resume,
   which writes a readmitted victim's spilled blocks into its fresh
   blocks and flips its slot live (no prefill);
2. the decode lane: one token for every active slot, each at its own
   position, through its block table (``ParallelAttention.decode``'s
   paged mode — the paged-attention kernel on the card);
3. the packed prefill lane: a ``prefill_chunk``-token budget filled FCFS
   from every admitting request, run as ONE ``(1, C)`` row — intra-pack
   flash attention with segment isolation, LSE-combined with each token's
   arena history (the flash and paged kernels on the card); requests
   whose prompt completes sample their first token.

``cache_dtype=torch.int8`` keeps the arena as int8 codes with fp32
scales per (position, kv head): rows quantize as they are written and
both lanes read the arena through the paged kernel's int8 lane.
Precision follows the thread-local policy (``core.autocast``) in force
where :meth:`step` runs, as ``hetu_tpu``'s engine follows its own: the
lanes are captured under the policy in force where the engine is built,
and a step under another policy re-captures them (counted, as a JAX
re-trace is).

The decode lane is the VERIFY lane of speculative decoding
(``spec_depth=K``, ``hetu_tpu/serving/engine.py:559-615``): each active
slot feeds its last token plus up to K drafted tokens as K+1 rows at
positions ``pos..pos+K`` (``dec_tok`` (S, K+1), ``dec_pos`` (S, 1));
``dec_rows`` (S, K+1) lets only a slot's first ``1 + depth`` rows write
their KV (the rest may lie past the blocks its table owns), and the lane
returns the (S, K+1, V) fp32 logits with their argmax. A slot's draft
depth is data: depth churn never re-captures. The drafts come from
:mod:`~hetu_tpu_torch.serving.speculative` — the n-gram index over the
request's own tokens (host only), or a draft model
(``draft_model=``, its own captured ``serving_draft_step``) — and
:func:`~hetu_tpu_torch.serving.speculative.speculative_verify` commits
the accepted drafts plus one token after the replay: the greedy leading
match, or rejection sampling for a sampled slot (so its output keeps the
target's distribution). Each slot's depth is clamped to ``max_tokens -
len(tokens) - 1``, and a commit stops at EOS or the budget. The engine's
``spec_stats`` counts ``drafted``, ``accepted``, ``sampled_accepted``,
``resampled`` and ``slot_steps`` (JAX's ``serving_draft_tokens_total``,
``serving_accepted_tokens_total``, ``serving_sampled_accepted_tokens_
total``, ``serving_resample_tokens_total`` and ``serving_decode_slot_
steps_total``); each request keeps its own ``drafted``/``accepted``.
``spec_depth=0`` (the default) is the same lane at one row a slot with
no ``dec_rows``: no slot drafts, and the verify rule at depth 0 is the
classic decode step (the argmax, or ``sample_slots``' one draw).

The lanes are ``hetu_tpu``'s fused step, which JAX compiles once
(``hetu_tpu/serving/engine.py:527 _build_step``). Here
each lane is a :class:`~hetu_tpu_torch.engine.step_graph.StepGraph`:
one body over static device operands (the decode inputs, the block
tables' device mirror ``_bt_dev``, the pack at the fixed chunk C and
``_fin_cap`` finishing rows), captured once as a CUDA graph when the
engine is built and replayed at every iteration that runs the lane, so
request churn never re-captures (``engine.trace_counts()``:
``serving_decode``, ``serving_prefill``). Per-slot tables, pack layouts
and offsets are data, never shapes. JAX's ``lax.cond``s are Python
``if``s on flags the host already knows: the copy-on-write copies run
eagerly before the lanes, and a lane with no work is not replayed. The
arena is written in place where JAX donated it. Sampling stays eager on
the static logits: a greedy step syncs once, in the verify rule's
``.cpu()`` of the argmax; each sampled slot at depth 0 adds one sync of
its own (its ``torch.multinomial`` draw is read back slot by slot,
``serving/speculative.py``), and the sampled slots that drafted add two
for their batch. ``lane_iters``
counts the iterations that ran each lane (each runs every layer's
attention once). TTFT and TPOT come from ``Request.timing``.

The arena is sized from ``slots`` (worst-case requests), from
``slots`` and ``kv_blocks`` (an oversubscribed arena), or from an HBM
budget alone (``hbm_budget_bytes``: ``KVPool.sized_for``, the byte
ledger of ``engine/memory.py``). Preemption (``preempt``, on by default
as in ``hetu_tpu``) spills into a :class:`~hetu_tpu_torch.serving.
kv_pool.HostSpillArena` bounded by ``spill_host_budget_bytes``; a bounded
arena's bytes land in a :class:`~hetu_tpu_torch.serving.kv_pool.
SpillStore` pinned once when the engine is built, not at each spill.
:meth:`evict_request` and
``submit(..., resume=entry)`` move a request between engines without
re-running its prefill. The spill's gather and the resume's scatter are
plain ``index_select`` / ``index_copy_`` (JAX runs them as ``jnp.take``
/ ``.at[].set`` outside any kernel), run eagerly once per preemption;
the resume writes the arena in place, so the captured lanes keep
reading the tensors they captured.

Multi-tenant serving (``tenancy=``, ``hetu_tpu/serving/engine.py:
360-374, 1717-1972``) mounts a :class:`~hetu_tpu_torch.serving.tenancy.
TenantPlane`: the adapter registry and per-tenant QoS on the host, and on
the device the adapter arena ``{proj: {"A": (L, P, in, r), "B": (L, P,
r, out)}}`` (fp32, P = ``max_adapters`` pages, page 0 the all-zero base
page), allocated once and written in place by the registry's
``on_page_write``, so the captured lanes keep reading the tensors they
captured. Each slot's arena page is a static ``(S,)`` int32 operand
(``adapter``): the decode lane broadcasts it over a slot's K+1 rows, the
prefill lane takes it per pack token through ``pf_slot``, and
``nn.parallel.lora_apply`` adds each token's delta to every paged
projection (a base token stays bitwise base). Adapter load, hot-swap,
eviction and mixed-tenant batches are data: no re-capture. A request
pins its adapter's page at admission and keeps the pin across
preemption, so its resume runs the same adapter load (the KV tags of the
prefix cache and the spill entry, ``kv_adapter``, keep two adapters'
activations apart); the tenant's QoS (token bucket, slot cap) defers a
request at admission without charging its class. A tenancy-off engine
builds no arena and its lanes add no op.

Online serving (``hetu_tpu/serving/engine.py:1564-1697, 2557-2597``):
:meth:`start` runs :meth:`step` on a background thread, under the
precision policy the lanes were captured under and on the engine's
device, so starting the loop never re-captures (JAX's loop thread reuses
the step it compiled once). Iterations are serialized by ``_step_lock``;
host state (the queue, the slots) by ``_lock``, which a step holds while
it stages and while it commits but not while the lanes run on the device,
so :meth:`submit` never waits for a replay. :meth:`swap_params`,
:meth:`evict_request`, :meth:`load_adapter` and :meth:`evict_adapter`
take the iteration lock first (the replays read the weights, the arena
and the adapter pages by address) and :meth:`cancel_queued` touches only
queued requests, so each lands between two iterations, never inside
one. :meth:`stream_subscribe` attaches a
bounded :class:`~hetu_tpu_torch.serving.streaming.TokenSubscription` to
a request; the end of every step that did work pumps each subscribed
request's new tokens into its queues (host work after the commit, no
device op), and an eviction or a cancel closes them with an ``end``
event. A step that raises kills the loop: the thread dies with the
error, and :meth:`result` and :meth:`stop` raise it. The line-protocol
server over this surface is :mod:`~hetu_tpu_torch.serving.server`.
:meth:`swap_params` copies new weights into the model's own tensors in
place, so the captured lanes read them with no re-capture; it bumps
``weight_version`` on the engine and the pool and flushes the stale
prefix-cache nodes.

W8A8 decode (``w8a8=``, ``hetu_tpu/serving/engine.py:453-525``): with
the int8 arena, the decode lane's FFNs of the chosen layers contract
int8 activations with int8 weights (``ParallelMLP``'s W8A8 lane, or
``MoEMLP``'s), against a tree quantized once when the engine is built
(``_w8a8_wq``, one ``prequantize`` tree a chosen layer). The lane
captures those tensors by address; the packed prefill lane stays fp, as
in ``hetu_tpu``. :meth:`swap_params` re-quantizes the new weights into
the same tensors, so the captured lane never serves stale int8 weights.
The byte ledger (``engine/memory.py``) does not price the tree, as
``hetu_tpu``'s does not.

Telemetry is ``hetu_tpu``'s (``docs/OBSERVABILITY.md``), all of it host
side, around the replays: nothing enters a captured lane, no call adds a
device sync (TTFT and TPOT are stamped where the step already read its
tokens back) and the lanes capture once with telemetry on or off. The
engine counts ``serving_requests_total``, ``serving_tokens_total``,
``serving_decode_slot_steps_total``, the kernel-path counters
``serving_attn_kernel_total{path="paged"}`` (each decode-lane replay) and
``prefill_attn_kernel_total{path="flash"}`` (each prefill-lane replay),
the prefix, block-eviction, preemption, spill, speculation and tenancy
counters; observes the TTFT, TPOT, step and draft-acceptance histograms;
sets the queue, occupancy, block, spill-tier and adapter-page gauges;
records the flight events (``serving_submit``, ``serving_admit``,
``serving_preempt``, ``serving_resume``, ``serving_evict``,
``weight_swap``, ``serving_finish``, ``serving_reject``,
``tenant_throttle``, ``adapter_wait``); and, with the tracer on, gives
each finished request its own Perfetto track (queued, prefill chunks,
decode). ``watchdog=True`` runs the hang watchdog on the background loop
and ``slo=True`` (or an ``SLOEngine``) the default serving rules on its
cadence. ``spec_stats``, the tenant plane's ledgers and the registry's
``stats()`` keep their host counts with telemetry off.

The fleet's side of the engine (``hetu_tpu/serving/engine.py:1168-1503``;
the router is :mod:`~hetu_tpu_torch.serving.router`):
``submit(handoff=True)`` / :meth:`prefill_only` is the prefill tier of a
prefill/decode split: the request parks after its first token (status
``"prefilled"``, its slot inactive but holding its blocks) until the
fleet evicts its KV to a decode-tier replica. :meth:`export_prefix` gathers
a cached whole-block prefix (the spill gather) and :meth:`import_prefix`
writes a peer's into fresh blocks (the resume's in-place scatter) and
inserts it into the radix trie, refused at another weight version.
:meth:`configure_replication` streams each decoding slot's newly
completed blocks to a buddy's :class:`~hetu_tpu_torch.serving.fleet.
KVReplicaStore` (``kv_replica_store`` is this engine's own, for its
peers) from a thread that holds the iteration lock only for the gather.
:meth:`swap_params` takes the fleet-wide ``version=`` a publisher sets.
Every operation that touches the arena holds
``engine.step_graph.DEVICE_GUARD`` shared, so a replica built in the same
process while this one serves captures its lanes between two of its
iterations.

Not ported yet, and not accepted as arguments: the CP long-prompt lane
(and with it the adapter refusal of that lane), ``load_adapter(path=)``
(the dist-ckpt transport), ``prefix_cache=False``,
``start(idle_sleep_s=)``, the host arena's peer tier (``spill_peer``) and
the scheduler's ``class_weights``, which no caller sets yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from hetu_tpu_torch import resolve_device, telemetry
from hetu_tpu_torch.core.dtypes import autocast
from hetu_tpu_torch.engine.memory import size_adapter_arena, \
    size_spill_arena
from hetu_tpu_torch.models import generation
from hetu_tpu_torch.nn.moe import refuse_batch_coupled
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.serving.kv_pool import (
    BlockManager, HostSpillArena, KVPool, SpillEntry, SpillStore,
    cache_dtype_name,
)
from hetu_tpu_torch.serving.prefix_cache import PrefixCache
from hetu_tpu_torch.serving.sampling import sample_slots
from hetu_tpu_torch.serving.scheduler import (
    Request, SamplingParams, Scheduler,
)
from hetu_tpu_torch.serving.speculative import (
    ModelDraftsman, NgramDraftsman, check_draft_depth, check_sampled_draft,
    speculative_verify,
)
from hetu_tpu_torch.engine.step_graph import DEVICE_GUARD, StepGraph
from hetu_tpu_torch.serving.streaming import TokenSubscription, push_delta
from hetu_tpu_torch.serving.tenancy import (
    DEFAULT_TARGETS, AdapterArenaFull, TenantPlane,
)
from hetu_tpu_torch.telemetry.flight import HangWatchdog, flight_record
from hetu_tpu_torch.telemetry.slo import SLOEngine, default_serving_rules
from hetu_tpu_torch.telemetry.spans import request_track_tid

log = logging.getLogger("hetu_tpu_torch.serving")

#: how often a waiter on a request (``result``) looks for a dead loop
_LOOP_POLL_S = 0.05
#: how long ``stop`` waits for the loop thread to finish its iteration
_STOP_JOIN_S = 30.0
#: the loop's wait while a swap or an eviction takes the iteration lock
_BOUNDARY_POLL_S = 1e-4
#: the loop's sleep after an iteration with nothing to do
_IDLE_SLEEP_S = 0.002


def resolve_w8a8(w8a8, num_layers: int, *, quantized: bool,
                 on_card: bool) -> Optional[tuple]:
    """The per-layer W8A8 flags of the engine's ``w8a8`` option, or None
    when it is off (``hetu_tpu/serving/engine.py:453-481``): ``"auto"``
    is on with the int8 arena on the card, ``"on"``/True every layer, an
    iterable of indices those layers; the last two raise ValueError
    without the int8 arena."""
    if w8a8 in (None, False, "off"):
        return None
    if w8a8 == "auto":
        return (True,) * num_layers if quantized and on_card else None
    if not quantized:
        raise ValueError(
            "w8a8 needs the int8 arena (cache_dtype=torch.int8): the "
            "quantized-compute lane is gated on pools already accepting "
            "8-bit error")
    if w8a8 in (True, "on"):
        return (True,) * num_layers
    mask = [False] * num_layers
    for layer in w8a8:
        mask[int(layer)] = True
    return tuple(mask)


class ServingEngine:
    """Slot-pooled continuous-batching engine over one model.

    ``device=None`` means ``cuda`` (raises without a card unless
    ``device="cpu"``); the model must live on that device. Offline use:
    :meth:`generate_many`; online: :meth:`submit`, then :meth:`step`
    until the request is done (or :meth:`run_until_drained`).
    ``cache_dtype`` is the arena's (default: the model's dtype).
    ``record_first_logits`` keeps the fp32 logits each request's first
    token was sampled from on ``Request.first_logits``; it exists only
    for oracle checks that hold the engine against a reference.

    The constructor captures both lanes (:attr:`lanes`) under the
    precision policy in force, so build the engine where it will serve
    (``with core.autocast(BF16_FULL): ServingEngine(...)`` for a bf16
    model). The graphs replay the addresses they captured: the model's
    parameters must keep their storage while the engine lives (no
    ``model.to(...)`` after it is built). An MoE model decodes through
    ``MoEMLP.decode`` in both lanes; one whose gate couples the rows of a
    batch (the balance gate) raises before anything is captured.

    Arena sizing: ``slots`` worst-case requests by default;
    ``kv_blocks`` beside ``slots`` sets the arena's blocks directly;
    ``slots=None`` with ``hbm_budget_bytes`` takes the most worst-case
    slots the budget holds next to the weights (``KVPool.sized_for``).
    ``preempt`` lets a blocked request evict a decoding one of a
    strictly lower class into the host spill arena
    (``spill_host_budget_bytes`` bounds it, and sizes the pinned host
    buffers allocated for it here).

    ``spec_depth`` (0: off) drafts up to that many tokens a slot and
    iteration for the verify lane: from the n-gram index over each
    request's own tokens (n-grams up to 3), or from ``draft_model`` (a
    model on the same
    device, with its own weights and KV arena; the target itself drafts
    at the acceptance ceiling).

    ``tenancy`` (None: off; True: a default :class:`~hetu_tpu_torch.
    serving.tenancy.TenantPlane`; or a plane) serves LoRA adapters from
    the device arena beside the base model: :meth:`load_adapter`, then
    ``SamplingParams(tenant=..., adapter=...)``; :meth:`evict_adapter`.
    With ``hbm_budget_bytes`` the arena's bytes
    (``engine.memory.size_adapter_arena``) come off the budget before the
    KV arena is sized.

    ``w8a8`` (``hetu_tpu``'s semantics): ``"off"``, None or False (the
    default) keeps every FFN fp; ``"on"`` or True sends every layer's
    decode-lane FFN through its W8A8 lane, an iterable of layer indices
    those layers; either raises ValueError without the int8 arena
    (``cache_dtype=torch.int8``). ``"auto"`` is on only with the int8
    arena on the card (JAX's ``auto`` is on only on the TPU). The
    resolved flags are ``_w8a8_mask`` (one bool a layer, or None).

    Observability (``hetu_tpu``'s arguments): ``watchdog`` runs a
    :class:`~hetu_tpu_torch.telemetry.HangWatchdog` (``watchdog_factor``
    × the median loop turn, at least ``watchdog_min_timeout_s``) on the
    :meth:`start` loop; ``slo`` (True: the default serving rules, or an
    ``SLOEngine``) is observed at every TTFT, TPOT and step and evaluated
    every ``slo_every_s`` by the loop; ``counter_sample_every`` samples
    the registry into the tracer's counter tracks every that many
    iterations."""

    def __init__(self, model, *, slots: Optional[int] = None,
                 max_len: int = 256, prefill_chunk: int = 16,
                 block_size: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 hbm_budget_bytes: Optional[float] = None,
                 kv_blocks: Optional[int] = None, preempt: bool = True,
                 spill_host_budget_bytes: Optional[float] = None,
                 spec_depth: int = 0, draft_model=None,
                 tenancy: Union[None, bool, TenantPlane] = None,
                 w8a8="off", seed: int = 0, device=None,
                 record_first_logits: bool = False,
                 counter_sample_every: int = 32,
                 watchdog: bool = False, watchdog_factor: float = 8.0,
                 watchdog_min_timeout_s: float = 30.0,
                 slo: Union[bool, SLOEngine, None] = None,
                 slo_every_s: float = 1.0):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, the engine was "
                             f"asked for {self.device}")
        refuse_batch_coupled(model)
        if block_size is None:
            block_size = 16 if max_len % 16 == 0 else max_len
        if self.device.type == "cuda":
            # compile the kernels now, all at once, not inside the first
            # step (where the build would land in the first request's TTFT)
            _build.build()
        self.model = model
        if tenancy is True:
            tenancy = TenantPlane()
        self.tenancy: Optional[TenantPlane] = tenancy or None
        if slots is None:
            if hbm_budget_bytes is None:
                raise ValueError("pass slots= or hbm_budget_bytes=")
            if kv_blocks is not None:
                raise ValueError(
                    "kv_blocks= conflicts with hbm_budget_bytes= "
                    "sizing (the budget already fixes the arena) — "
                    "pass slots= alongside kv_blocks=")
            if self.tenancy is not None:
                # the adapter arena lives in the same HBM budget the KV
                # arena is sized from: price it first
                arena = size_adapter_arena(
                    model.cfg, r=self.tenancy.r,
                    max_adapters=self.tenancy.max_adapters)
                if arena >= 0.5 * hbm_budget_bytes:
                    raise ValueError(
                        f"adapter arena ({self.tenancy.max_adapters} "
                        f"pages x rank {self.tenancy.r}) needs "
                        f"~{arena / 1e9:.2f}GB — more than half the "
                        f"{hbm_budget_bytes / 1e9:.2f}GB HBM budget; "
                        f"shrink max_adapters / the arena rank, or "
                        f"raise the budget")
                hbm_budget_bytes = hbm_budget_bytes - arena
            self.pool = KVPool.sized_for(
                model, hbm_budget_bytes=hbm_budget_bytes, max_len=max_len,
                cache_dtype=cache_dtype, block_size=block_size)
        else:
            self.pool = KVPool(model, slots, max_len, block_size,
                               cache_dtype, n_blocks=kv_blocks)
        #: weight generation of the arena's KV (:meth:`swap_params` bumps
        #: it): a spill resumes only into an engine at the same version
        self.weight_version = 0
        self.record_first_logits = bool(record_first_logits)
        self.prefill_chunk = int(prefill_chunk)
        self.blocks = BlockManager(self.pool.n_blocks)
        self.prefix_cache = PrefixCache(self.pool.block_size, self.blocks)
        self.scheduler = Scheduler(
            self.pool.slots, self.pool.max_len, blocks=self.blocks,
            prefix_cache=self.prefix_cache,
            block_size=self.pool.block_size)
        self.seed = int(seed)
        # QoS preemption: the host spill arena, priced in the blocks the
        # device pool allocates (engine/memory ledger)
        self.preempt = bool(preempt)
        max_blocks = None
        if spill_host_budget_bytes is not None:
            max_blocks = size_spill_arena(
                model.cfg, host_budget_bytes=spill_host_budget_bytes,
                block_size=self.pool.block_size,
                cache_dtype=cache_dtype_name(self.pool.cache_dtype))
        self.spill_arena = HostSpillArena(max_blocks)
        #: the parked bytes' host buffers, allocated once, so a spill
        #: copies into memory already pinned; at most the device arena's
        #: blocks (an entry it cannot place gets buffers of its own)
        self.spill_store = None
        if self.preempt and max_blocks is not None:
            self.spill_store = SpillStore(
                self.pool.caches, min(max_blocks, self.pool.n_blocks - 1),
                pin=self.device.type == "cuda")
        self._resume_pending: list[dict] = []    # admitted spill-resumes
        # decode-KV replication: a thread streams each decoding slot's
        # newly completed blocks to a buddy the router picks (the sink);
        # ``kv_replica_store`` is this engine's store for its peers
        from hetu_tpu_torch.serving.fleet import KVReplicaStore
        self.kv_replica_store = KVReplicaStore()
        self._repl_sink = None          # callable(doc) or None: off
        self._repl_origin = ""
        self._repl_cadence_s = 0.02
        self._repl_sent: dict[int, tuple] = {}   # req id -> (blocks, tid)
        self._repl_thread: Optional[threading.Thread] = None
        self._repl_stop: Optional[threading.Event] = None
        #: the replication stream's pinned staging buffers, one a leaf,
        #: allocated on its first cadence (:meth:`_repl_to_host`)
        self._repl_stage: Optional[list] = None

        # speculation: the draft depth is the verify lane's width less
        # one, each slot's depth is data
        self.spec_depth = check_draft_depth(spec_depth, max_len)
        self._draftsman = None
        if draft_model is not None:
            if self.spec_depth == 0:
                raise ValueError(
                    "draft_model without spec_depth — pass spec_depth=k "
                    "to enable the verify lane")
            self._draftsman = ModelDraftsman(
                draft_model, slots=self.pool.slots, max_len=max_len,
                spec_depth=self.spec_depth,
                block_size=self.pool.block_size,
                target_vocab=model.cfg.vocab_size)
        elif self.spec_depth:
            self._draftsman = NgramDraftsman(self.pool.slots)
        #: the speculation counters (``hetu_tpu``'s telemetry names them
        #: ``serving_draft_tokens_total`` and so on); ``1 + accepted /
        #: slot_steps`` is the mean of tokens committed a slot-step
        self.spec_stats = {"drafted": 0, "accepted": 0,
                           "sampled_accepted": 0, "resampled": 0,
                           "slot_steps": 0}
        self._spec: Optional[dict] = None        # this step's drafts

        S, W = self.pool.slots, self.pool.table_width
        self._pos = np.zeros(S, np.int64)        # next KV write index
        self._last_tok = np.zeros(S, np.int64)   # sampled, not yet fed
        self._active = np.zeros(S, bool)         # decoding slots
        self._temp = np.zeros(S, np.float32)
        self._topk = np.zeros(S, np.int64)
        self._topp = np.zeros(S, np.float32)
        self._bt = np.zeros((S, W), np.int32)    # per-slot block tables
        self._slot_req: list[Optional[Request]] = [None] * S
        # the adapter plane: each slot's arena page (0 = base), the arena,
        # and the requests in a throttle or arena-wait episode and those
        # that paid their tenant's QoS admission
        self._adapter_page = np.zeros(S, np.int32)
        self._lora_pages: dict = {}
        self._throttle_logged: set = set()
        self._wait_logged: set = set()
        self._qos_admitted: set = set()
        if self.tenancy is not None:
            self._lora_pages = self._init_adapter_arena()
            self.tenancy.registry.on_page_write = self._write_adapter_page
            self.scheduler.admission_gate = self._admission_gate
        # one generator per sampled request, seeded at admission
        self._gen: list[Optional[torch.Generator]] = [None] * S
        self._prefilling: list[dict] = []        # FCFS in-flight prefills
        self._next_id = 0
        #: host state: the queue, the slots, the tables, the spill arena
        self._lock = threading.RLock()
        #: whole iterations: one step, swap or eviction at a time
        self._step_lock = threading.Lock()
        # callers waiting for an iteration boundary (swap, eviction): the
        # loop lets them in before its next iteration (a Lock is not fair:
        # the loop would otherwise take it back at once, for as long as
        # it has work)
        self._boundary_waiters = 0
        self._waiters_lock = threading.Lock()
        #: the front end's poll map (request id -> Request)
        self._requests_by_id: dict[int, Request] = {}
        # push subscriptions: request id -> (request, [subscriptions]),
        # fed at the end of every step, drained by the server's threads
        self._stream_subs: dict[int, tuple] = {}
        self._stream_lock = threading.Lock()
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._loop_error: Optional[BaseException] = None
        #: engine iterations that ran each lane
        self.lane_iters = {"decode": 0, "prefill": 0}
        #: iterations that did work (the health document's ``iterations``)
        self._iter = 0
        self._evictions_synced = 0               # scheduler ledger -> ctr
        self._counter_sample_every = int(counter_sample_every)
        # the observability side band: a hang watchdog fed by the
        # background loop, an SLO engine evaluated on its cadence
        # (slo=True installs the default TTFT/TPOT/step rules)
        self.watchdog: Optional[HangWatchdog] = HangWatchdog(
            name="serving", factor=watchdog_factor,
            min_timeout_s=watchdog_min_timeout_s,
            registry=telemetry.get_registry()) if watchdog else None
        if slo is True:
            self.slo: Optional[SLOEngine] = default_serving_rules(
                SLOEngine(telemetry.get_registry()))
        else:
            self.slo = slo or None
        self._slo_every_s = float(slo_every_s)
        self._slo_last_eval = 0.0
        #: max requests that can FINISH prefill in one iteration (each
        #: needs >= 1 pack token): the prefill lane's head width
        self._fin_cap = max(1, min(S, self.prefill_chunk))
        self._w8a8_mask = resolve_w8a8(
            w8a8, model.blocks.num_layers, quantized=self.pool.quantized,
            on_card=self.device.type == "cuda")
        #: the decode lane's pre-quantized W8A8 weights: one tree a layer
        #: whose flag is set (None elsewhere), quantized once here and in
        #: place by every swap_params
        self._w8a8_wq = None
        if self._w8a8_mask is not None:
            self._w8a8_wq = [blk.mlp.prequantize() if on else None
                             for blk, on in zip(model.blocks,
                                                self._w8a8_mask)]
        self._init_operands()
        #: the step's lanes, each captured once (``StepGraph``)
        self.lanes = self._build_lanes()

    # -- the captured lanes -------------------------------------------------
    def _init_operands(self) -> None:
        """The lanes' static operands on the engine's device, written in
        place every step: the decode inputs, the block tables' device
        mirror (``_bt_dev``), the pack at the fixed chunk and the
        finishing rows. On the card each has a pinned host twin, so a
        step's uploads are asynchronous; an event makes the next fill
        wait until they have landed."""
        S, W = self.pool.slots, self.pool.table_width
        C, R, dev = self.prefill_chunk, self._fin_cap, self.device
        i32, i64, K = torch.int32, torch.int64, self.spec_depth
        shapes = {"dec_tok": ((S, K + 1), i64), "dec_pos": ((S, 1), i64),
                  "dec_mask": ((S,), torch.bool), "bt": ((S, W), i32),
                  "pf_tok": ((C,), i64), "pf_pos": ((C,), i64),
                  "pf_slot": ((C,), i32), "pf_seg": ((C,), i32),
                  "pf_hist": ((C,), i32), "pf_valid": ((C,), torch.bool),
                  "fin_row": ((R,), i64)}
        if K:
            shapes["dec_rows"] = ((S, K + 1), torch.bool)
        if self.tenancy is not None:
            shapes["adapter"] = ((S,), i32)
        self._ops = {k: torch.zeros(shape, dtype=dt, device=dev)
                     for k, (shape, dt) in shapes.items()}
        self._bt_dev = self._ops["bt"]
        self._pinned = {}
        self._h2d = None
        if dev.type == "cuda":
            self._pinned = {k: torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=True)
                            for k, t in self._ops.items()}
            self._h2d = torch.cuda.Event()

    def _upload(self, **arrays) -> None:
        """Write host arrays into the static operands of the same names."""
        if self._h2d is not None:
            self._h2d.synchronize()     # the last step's copies landed
        for name, arr in arrays.items():
            dst = self._ops[name]
            src = torch.from_numpy(np.ascontiguousarray(arr)).view(dst.shape)
            if self._h2d is None:
                dst.copy_(src)
                continue
            stage = self._pinned[name]
            stage.copy_(src)
            dst.copy_(stage, non_blocking=True)
        if self._h2d is not None:
            self._h2d.record()

    def _build_lanes(self) -> dict:
        """The decode lane (``generation.decode`` over K+1 rows of every
        slot: the verify lane; with ``w8a8``, the chosen layers' FFNs on
        their W8A8 lane) and the prefill lane (embed,
        ``blocks.decode(pack=...)``, then the head on the ``_fin_cap``
        finishing rows), each a :class:`StepGraph`
        captured now, with every slot masked and every pack row invalid.
        With tenancy both read the adapter arena through each slot's page
        (``adapter``); without it they carry no adapter op.
        The bodies close over the operands, the model and the arena, not
        over the engine, so dropping the engine frees the graphs."""
        model, caches, ops = self.model, self.pool.caches, self._ops
        K = self.spec_depth
        w8a8 = {} if self._w8a8_mask is None else dict(
            w8a8_mask=self._w8a8_mask, w8a8_wq=self._w8a8_wq)
        # a verify row past a slot's depth may lie past the model's
        # positions: its position is clamped (it writes nothing, and its
        # output is discarded); at K = 0 no row is masked
        lane = torch.arange(K + 1, device=self.device)[None, :]
        top = model.cfg.max_positions - 1
        pages = self._lora_pages
        ten = ("adapter",) if pages else ()
        dec_keys = ("dec_tok", "dec_pos", "dec_mask") \
            + (("dec_rows",) if K else ()) + ten

        def decode_body():
            lora = None
            if pages:
                # every verify row of a slot decodes under its page
                lora = {"ids": ops["adapter"][:, None].expand(-1, K + 1),
                        "pages": pages}
            logits = generation.decode(
                model, ops["dec_tok"], (ops["dec_pos"] + lane).clamp(max=top),
                caches, slot_mask=ops["dec_mask"], block_tables=ops["bt"],
                row_mask=ops.get("dec_rows"), lora=lora, **w8a8)
            return logits, logits.argmax(dim=-1)

        def decode_idle():
            for k in dec_keys:
                ops[k].zero_()

        def prefill_body():
            pos = ops["pf_pos"][None]
            h = model.embed(ops["pf_tok"][None], positions=pos)
            lora = None
            if pages:
                # each pack token decodes under its slot's page
                lora = {"ids": ops["adapter"].index_select(
                    0, ops["pf_slot"])[None], "pages": pages}
            h = model.blocks.decode(
                h, caches, positions=pos, block_tables=ops["bt"],
                pack={"row_slot": ops["pf_slot"],
                      "segment_ids": ops["pf_seg"][None],
                      "hist": ops["pf_hist"], "valid": ops["pf_valid"]},
                lora=lora)
            rows = h[0].index_select(0, ops["fin_row"])
            return (model.logits(model.hidden_norm(rows)),)

        pf_keys = ("pf_tok", "pf_pos", "pf_slot", "pf_seg", "pf_hist",
                   "pf_valid", "fin_row")

        def prefill_idle():
            for k in pf_keys:
                ops[k].zero_()
            ops["pf_seg"].fill_(-1)

        return {
            "decode": StepGraph(
                "serving_decode", decode_body,
                idle=decode_idle, operands=[ops[k] for k in dec_keys],
                device=self.device),
            "prefill": StepGraph(
                "serving_prefill", prefill_body, idle=prefill_idle,
                operands=[ops[k] for k in pf_keys + ten],
                device=self.device)}

    # -- requests -----------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None, *,
               resume: Optional[SpillEntry] = None,
               handoff: bool = False,
               traceparent: Optional[str] = None) -> Request:
        """Queue one request; returns the live :class:`Request` (status
        ``"rejected"`` with ``error`` set when it can never fit a slot).

        ``resume`` attaches a KV spill taken from another engine
        (:meth:`evict_request` there): when the entry speaks this pool's
        layout and weight version, the request admits through the resume
        path — its emitted tokens preloaded, no prefill. An incompatible
        entry degrades to a fresh replay, which under greedy decoding
        regenerates the same tokens.

        ``sampling.adapter`` needs ``tenancy=`` (else ValueError); an
        adapter the registry does not hold rejects the request. A spill
        resumes only under the adapter load it was written under.

        ``handoff`` is the prefill-tier mode: the request runs admission
        and prefill here, then parks after its first token (status
        ``"prefilled"``, its slot inactive but holding its blocks) for the
        caller (:meth:`prefill_only`, the fleet router) to evict and
        resume on a decode-tier engine.

        ``traceparent`` (``"<trace_id>-<span_id>"``, from the wire) makes
        the request adopt that trace id (without one, a resume adopts its
        spill's); a malformed token is ignored."""
        sampling = sampling or SamplingParams()
        if handoff and resume is not None:
            raise ValueError(
                "handoff with resume makes no sense: a resumed request's "
                "KV already exists — submit it to the decode tier "
                "directly")
        if sampling.adapter is not None and self.tenancy is None:
            raise ValueError(
                "SamplingParams.adapter without tenancy= — construct "
                "the engine with ServingEngine(..., tenancy=True) and "
                "load_adapter first")
        if sampling.temperature > 0 and self.spec_depth:
            check_sampled_draft(self._draftsman)
        tp = traceparent or (resume.traceparent
                             if resume is not None else None)
        with self._lock:
            req = Request(id=self._next_id,
                          prompt=np.asarray(prompt, np.int32).ravel(),
                          sampling=sampling, submit_s=time.monotonic(),
                          handoff=bool(handoff))
            self._next_id += 1
            if tp:
                tid, _span = telemetry.parse_traceparent(tp)
                if tid:
                    req.trace_id = tid
                    req.traceparent = tp
            admitted = False
            if sampling.adapter is not None:
                registry = self.tenancy.registry
                if not registry.has(sampling.tenant, sampling.adapter):
                    req.status = "rejected"
                    req.error = (f"unknown adapter {sampling.tenant}/"
                                 f"{sampling.adapter} — load_adapter "
                                 f"first")
                    req.done.set()
                else:
                    req.kv_adapter = registry.kv_tag(
                        registry.get(sampling.tenant, sampling.adapter))
            if req.status != "rejected":
                if resume is not None and resume.compatible_with(
                        self.pool, self.weight_version,
                        adapter=req.kv_adapter):
                    req.spill = resume
                    req.tokens = list(resume.tokens)
                    req.weight_version = resume.weight_version
                admitted = self.scheduler.submit(req)
        telemetry.get_registry().counter(
            "serving_requests_total", "serving requests by outcome").inc(
            outcome="submitted" if admitted else "rejected")
        flight_record("serving_submit", req=req.id, trace=req.trace_id,
                      prompt_len=len(req.prompt),
                      outcome="queued" if admitted else "rejected")
        self._record_gauges()
        return req

    def result(self, req: Request,
               timeout: Optional[float] = None) -> Optional[dict]:
        """Wait for ``req`` to finish; None on timeout. Raises when the
        background loop died before the request finished."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not req.done.is_set():
            err = self._loop_error
            if err is not None:
                raise RuntimeError(
                    f"the serving loop died: {err!r}") from err
            left = None if deadline is None \
                else deadline - time.monotonic()
            if left is not None and left <= 0:
                return None
            req.done.wait(_LOOP_POLL_S if left is None
                          else min(_LOOP_POLL_S, left))
        return req.result()

    def has_work(self) -> bool:
        with self._lock:
            return bool(self.scheduler.queue) or bool(self._active.any()) \
                or bool(self._prefilling) or bool(self._resume_pending)

    @property
    def load(self) -> int:
        """Queued, prefilling, resuming and decoding requests: the number
        a least-loaded dispatcher reads."""
        with self._lock:
            return self.scheduler.depth + len(self._prefilling) \
                + len(self._resume_pending) + int(self._active.sum())

    # -- push subscriptions ---------------------------------------------------
    def stream_subscribe(self, req: Request, *, offset: int = 0,
                         max_queue: int = 256) -> TokenSubscription:
        """Subscribe to ``req``'s tokens from token ``offset``: the backlog
        past the offset is queued now (a finished request yields its one
        terminal event), then the end of every step feeds the newly
        committed tokens. The subscription is a bounded queue: a consumer
        that stops draining is dropped, never waited on."""
        sub = TokenSubscription(req.id, offset=offset, max_queue=max_queue)
        with self._stream_lock:
            push_delta(req, sub)
            if not sub.closed:
                ent = self._stream_subs.get(req.id)
                if ent is None:
                    self._stream_subs[req.id] = (req, [sub])
                else:
                    ent[1].append(sub)
        return sub

    def _pump_stream_subs(self) -> None:
        """End-of-step push: fold each subscribed request's new tokens
        (and its finish) into its subscriptions' queues. Enqueue-only host
        work: a slow subscriber overflows its own queue and is dropped
        (counted) instead of stalling the loop."""
        if not self._stream_subs:
            return
        with self._stream_lock:
            for rid in list(self._stream_subs):
                req, subs = self._stream_subs[rid]
                for sub in subs:
                    push_delta(req, sub)
                live = [x for x in subs if not (x.closed or x.dropped)]
                if live:
                    self._stream_subs[rid] = (req, live)
                else:
                    del self._stream_subs[rid]

    def _stream_interrupt(self, req: Request) -> None:
        """Close ``req``'s subscriptions after it left the engine out of
        band (evicted or cancelled, between two steps): the last delta and
        an ``end`` marker tell subscribers to fall back to polling."""
        if not self._stream_subs:
            return
        with self._stream_lock:
            ent = self._stream_subs.pop(req.id, None)
        if ent is None:
            return
        for sub in ent[1]:
            push_delta(req, sub)
            sub.close()

    # -- one iteration ------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration; False when there was nothing to do.
        Safe while the :meth:`start` loop runs (iterations are
        serialized), though one stepping thread is the intended mode."""
        with self._step_lock, DEVICE_GUARD.shared(), torch.no_grad():
            return self._step_locked()

    def _admit_locked(self) -> list[tuple[int, int]]:
        """Admit every admissible queued request: map its prefix-cache
        plan into the slot's block table and queue its prefill. Returns
        this iteration's CoW (src, dst) block pairs."""
        cows: list[tuple[int, int]] = []
        reg = telemetry.get_registry()
        now = time.monotonic()
        while True:
            adm = self.scheduler.next_admission()
            if adm is None:
                break
            req, slot = adm
            if self.tenancy is not None \
                    and not self._bind_adapter_locked(req, slot):
                continue
            req.weight_version = self.weight_version
            sp = req.sampling
            self._temp[slot] = sp.temperature
            self._topk[slot] = sp.top_k
            self._topp[slot] = sp.top_p
            self._gen[slot] = None
            if sp.temperature > 0:
                seed = sp.seed if sp.seed is not None else self.seed + req.id
                self._gen[slot] = torch.Generator(
                    device=self.device).manual_seed(int(seed))
            self._slot_req[slot] = req
            plan = req.admit
            self._bt[slot, :] = 0
            self._bt[slot, :len(plan["table"])] = plan["table"]
            if plan["cow"] is not None:
                cows.append(plan["cow"])
            if plan.get("resume"):
                # a preempted request coming back: its KV is written back
                # from the spill entry, no prefill
                self._resume_pending.append({"req": req, "slot": slot})
            else:
                self._prefilling.append({"req": req, "slot": slot,
                                         "off": plan["first_uncached"]})
            if self._draftsman is not None:
                # the slot's draft state belongs to its new occupant (a
                # resume re-seeds it with its whole history at map-back)
                self._draftsman.reset(slot, req.prompt.tolist())
            hit = req.cached_tokens
            if hit:
                reg.counter("serving_prefix_hit_tokens_total",
                            "prompt tokens served from the prefix "
                            "cache (prefill skipped)").inc(hit)
            reg.counter("serving_prefix_miss_tokens_total",
                        "prompt tokens that had to be prefilled").inc(
                len(req.prompt) - hit)
            flight_record("serving_admit", req=req.id,
                          trace=req.trace_id, slot=slot,
                          cached_tokens=hit, cp_lane=False,
                          queued_s=round(now - req.submit_s, 4))
        ev = self.scheduler.evictions_total
        if ev > self._evictions_synced:
            reg.counter("serving_block_evictions_total",
                        "prefix-cache blocks LRU-evicted to refill the "
                        "free list").inc(ev - self._evictions_synced)
            self._evictions_synced = ev
        return cows

    def _build_pack(self) -> dict:
        """Fill the C-token prefill budget FCFS over in-flight prefills
        (the oldest request first, the rest share what remains). Per-token
        operands: slot (the token's row of the engine's block tables; pads
        name slot 0 and read nothing), position, segment id (= the slot:
        one contiguous run per request, so pack order is position order
        within it; -1 on pads) and ``hist`` (the run's start offset: arena
        rows below it — earlier chunks, prefix hits — are the history
        part, which the paged kernel reads once per run). The requests
        whose prompt ends in this pack fill the first ``len(fin)`` of the
        ``_fin_cap`` finishing rows (``fin_row``: the pack row of the
        last prompt token; ``fin_slot``), as in ``hetu_tpu``; the rest
        point at row 0 and are discarded (the host samples only the
        first ``len(fin)``, so JAX's ``fin_valid`` is that count)."""
        C, R = self.prefill_chunk, self._fin_cap
        pf = {"tokens": np.zeros(C, np.int64), "pos": np.zeros(C, np.int64),
              "slot": np.zeros(C, np.int32), "valid": np.zeros(C, bool),
              "seg": np.full(C, -1, np.int32), "hist": np.zeros(C, np.int32),
              "fin_row": np.zeros(R, np.int64),
              "fin_slot": np.zeros(R, np.int64), "fin": [], "fills": [],
              "used": 0}
        used = 0
        for ent in self._prefilling:
            if used >= C:
                break
            req, off = ent["req"], ent["off"]
            n = int(min(C - used, len(req.prompt) - off))
            sl = slice(used, used + n)
            pf["tokens"][sl] = req.prompt[off:off + n]
            pf["pos"][sl] = np.arange(off, off + n)
            pf["slot"][sl] = ent["slot"]
            pf["valid"][sl] = True
            pf["seg"][sl] = ent["slot"]
            pf["hist"][sl] = off
            if off + n >= len(req.prompt):
                i = len(pf["fin"])
                pf["fin_row"][i] = used + n - 1
                pf["fin_slot"][i] = ent["slot"]
                pf["fin"].append(ent)
            pf["fills"].append((ent, n))
            used += n
        pf["used"] = used
        return pf

    def _stage_locked(self):
        """The step up to its lanes: admission, at most one preemption
        (then admission again), at most one resume, the copy-on-write
        copies and the uploads of the lanes' operands, in ``hetu_tpu``'s
        order (``engine.py:2044-2072``). Returns ``(active slots,
        pack)``, or None when there is nothing to do. Staging again
        without running the lanes stages the same work (a decode lane
        re-writes the same rows, a pack re-packs the same tokens), once
        no preemption or resume is due."""
        cows = self._admit_locked()
        aux = False
        victim = self._plan_preemption_locked()
        if victim is not None:
            # the gather is queued after the last replay that wrote the
            # victim's rows; its blocks go back to the free list after
            # it, so a later write reaches them only after it read them
            self._exec_spill(victim)
            cows += self._admit_locked()
            aux = True
        if self._resume_pending:
            self._exec_resume(self._resume_pending.pop(0))
            aux = True
        active = np.nonzero(self._active)[0]
        if not self._prefilling and active.size == 0 and not cows \
                and not aux:
            return None
        pf = self._build_pack()
        caches = self.pool.caches

        # copy-on-write tails of partial prefix hits land before any write
        # (every arena array: k and v, and the int8 arena's scales)
        for src, dst in cows:
            for c in caches:
                c[:, dst].copy_(c[:, src])
        feed = {"bt": self._bt}
        if self.tenancy is not None:
            feed["adapter"] = self._adapter_page
        self._spec = None
        if active.size:
            self._spec = spec = self._propose_locked(active)
            dec_tok = np.concatenate([self._last_tok[:, None], spec["tok"]],
                                     axis=1)
            feed.update(dec_tok=dec_tok, dec_pos=self._pos,
                        dec_mask=self._active)
            if self.spec_depth:
                feed["dec_rows"] = (np.arange(self.spec_depth + 1)[None, :]
                                    <= spec["len"][:, None]) \
                    & self._active[:, None]
        if pf["used"]:
            feed.update(pf_tok=pf["tokens"], pf_pos=pf["pos"],
                        pf_slot=pf["slot"], pf_seg=pf["seg"],
                        pf_hist=pf["hist"], pf_valid=pf["valid"],
                        fin_row=pf["fin_row"])
        self._upload(**feed)
        if self._spec is not None and self._spec["dev_tok"] is not None:
            # a device draftsman's drafts go to the lane without a sync
            self._ops["dec_tok"][:, 1:].copy_(self._spec["dev_tok"])
        return active, pf

    def _propose_locked(self, active: np.ndarray) -> dict:
        """This step's drafts (``hetu_tpu/serving/engine.py:2087-2152``):
        each active slot's depth clamped to ``max_tokens - len(tokens) -
        1`` (a commit can never pass the budget or the slot's blocks),
        then the n-gram proposals, or one draft step of the draft model.
        Returns the host drafts ``tok`` (S, K) and depths ``len`` (S,),
        and for a draft model its device drafts ``dev_tok`` and proposal
        rows ``q``."""
        S, K = self.pool.slots, self.spec_depth
        spec = {"tok": np.zeros((S, K), np.int64),
                "len": np.zeros(S, np.int64), "dev_tok": None, "q": None}
        budget = np.zeros(S, np.int64)
        for r in active:
            req = self._slot_req[r]
            budget[r] = max(0, min(K, req.sampling.max_tokens
                                   - len(req.tokens) - 1))
        ds = self._draftsman
        if ds is None or not budget.any():
            return spec
        if ds.host_only:
            for r in active:
                prop = ds.propose(int(r), int(budget[r]))
                n = min(len(prop), int(budget[r]))
                spec["tok"][r, :n] = prop[:n]
                spec["len"][r] = n
            return spec
        seqs: list = [None] * S
        for r in active:
            req = self._slot_req[r]
            seqs[r] = req.prompt.tolist() + list(req.tokens)
        dev_tok, d_len, q = ds.propose_all(
            seqs, self._pos, self._active, budget, temps=self._temp,
            topks=self._topk, topps=self._topp,
            seeds=[0 if g is None else g.initial_seed() for g in self._gen])
        spec.update(len=np.minimum(d_len, budget), dev_tok=dev_tok, q=q)
        return spec

    def _step_locked(self) -> bool:
        """One iteration under the iteration lock: staging and the commit
        hold the state lock, the lanes' replays and the verify rule's
        read-back do not (whatever writes what they read, weights, arena,
        adapter pages or block tables, takes the iteration lock)."""
        t0 = time.monotonic()
        with self._lock:
            staged = self._stage_locked()
        if staged is None:
            return False
        active, pf = staged
        spec = self._spec
        if spec is not None:
            logits, greedy = self.lanes["decode"].replay()
            temp = np.where(self._active, self._temp, 0.0)
            drafts = spec["tok"] if spec["dev_tok"] is None \
                else spec["dev_tok"].cpu().numpy()
            spec["committed"], spec["ncommit"] = speculative_verify(
                logits, drafts, spec["len"], spec["q"], temp, self._topk,
                self._topp, self._gen, greedy=greedy)
            spec["sampled"] = temp > 0
            self.lane_iters["decode"] += 1

        first_toks = lg = None
        if pf["used"]:
            lg, = self.lanes["prefill"].replay()
            if pf["fin"]:
                # first tokens only for the requests whose prompt ends in
                # this pack: the head ran on the finishing rows alone
                n = len(pf["fin"])
                fs = pf["fin_slot"][:n]
                first_toks = sample_slots(lg[:n], self._temp[fs],
                                          self._topk[fs], self._topp[fs],
                                          [self._gen[s] for s in fs])
            self.lane_iters["prefill"] += 1

        with self._lock:
            self._commit_locked(active, spec, pf, lg, first_toks, t0)
            self._record_gauges()
        self._pump_stream_subs()
        step_s = time.monotonic() - t0
        reg = telemetry.get_registry()
        reg.histogram("serving_step_seconds",
                      "one fused engine iteration").observe(step_s)
        if self.slo is not None:
            self.slo.observe("serving_step_seconds", step_s)
        if self._counter_sample_every and \
                self._iter % self._counter_sample_every == 0:
            telemetry.get_tracer().record_counters(reg.snapshot())
        return True

    def _commit_locked(self, active: np.ndarray, spec: Optional[dict],
                       pf: dict, lg, first_toks, t0: float) -> None:
        """The step's host commit: the decode lane's verified tokens,
        then the pack's progress and the first token of every request
        whose prompt it finished."""
        now = time.monotonic()
        reg = telemetry.get_registry()
        self._iter += 1
        if spec is not None:
            reg.counter(
                "serving_decode_slot_steps_total",
                "slot×iteration decode opportunities (each active "
                "slot in each fused step counts once); 1 + "
                "accepted/this is the mean tokens committed per "
                "slot-step — the speculation win, 1.0 without "
                "drafts").inc(int(active.size))
            reg.counter(
                "serving_attn_kernel_total",
                "fused decode/verify steps by attention path "
                "(paged = Pallas block-table kernel, reference = "
                "XLA gather)").inc(path="paged")
        if pf["used"]:
            reg.counter(
                "prefill_attn_kernel_total",
                "prefill-lane executions by attention path (flash "
                "= packed/CP flash lane, reference = per-token "
                "gather math)").inc(path="flash")
        if spec is not None:
            self._commit_decode_locked(active, spec, now)
            self.spec_stats["slot_steps"] += int(active.size)
        for ent, n in pf["fills"]:
            ent["off"] += n
            ent["req"].mark("prefill_chunk", dur_s=now - t0, ts_s=t0)
        if pf["used"]:
            reg.counter("serving_tokens_total",
                        "serving tokens by kind").inc(
                pf["used"], kind="prompt")
        for i, ent in enumerate(pf["fin"]):
            req, slot = ent["req"], ent["slot"]
            self._pos[slot] = len(req.prompt)
            self._active[slot] = True
            req.status = "decode"
            req.first_token_s = now
            req.mark("first_token", ts_s=now)
            ttft = now - req.submit_s
            reg.histogram("serving_ttft_seconds",
                          "time submit -> first token").observe(ttft)
            if self.slo is not None:
                self.slo.observe("serving_ttft_seconds", ttft)
            # the finished prompt's whole blocks enter the radix cache
            self.prefix_cache.insert(req.prompt.tolist(), self._bt[slot],
                                     adapter=req.kv_adapter)
            if self.record_first_logits:
                # a copy: the next replay overwrites the lane's output
                req.first_logits = lg[i].clone()
            self._on_token(slot, int(first_toks[i]), now)
            self._prefilling.remove(ent)

    def _commit_decode_locked(self, active: np.ndarray, spec: dict,
                              now: float) -> None:
        """Commit each slot's verified tokens (``hetu_tpu/serving/
        engine.py:2264-2316``): ``ncommit`` through :meth:`_on_token`,
        which can finish the request mid-commit (EOS or budget; the rest
        is dropped); the ledgers count only what the request kept."""
        stats = self.spec_stats
        reg = telemetry.get_registry()
        for r in active:
            r = int(r)
            req = self._slot_req[r]
            n = int(spec["ncommit"][r])
            taken = 0
            for j in range(n):
                self._on_token(r, int(spec["committed"][r, j]), now)
                taken += 1
                if self._slot_req[r] is not req:
                    break                        # finished mid-commit
            dr = int(spec["len"][r])
            if not dr:
                continue
            # of the taken tokens all but the extra one (column n - 1,
            # kept only when taken == n) were accepted drafts
            kept = min(taken, n - 1)
            req.drafted += dr
            req.accepted += kept
            stats["drafted"] += dr
            stats["accepted"] += kept
            reg.counter("serving_draft_tokens_total",
                        "draft tokens proposed to the verify "
                        "lane").inc(dr)
            sampled = bool(spec["sampled"][r])
            if kept:
                reg.counter(
                    "serving_accepted_tokens_total",
                    "draft tokens the verify lane accepted "
                    "(committed without their own decode "
                    "iteration)").inc(kept)
                if sampled:
                    reg.counter(
                        "serving_sampled_accepted_tokens_total",
                        "draft tokens accepted by the "
                        "rejection-sampling verify lane "
                        "(temperature > 0 slots)").inc(kept)
            if sampled:
                stats["sampled_accepted"] += kept
                if n - 1 < dr:
                    # draft n - 1 was rejected: the token came from the
                    # residual max(0, p - q)
                    stats["resampled"] += 1
                    reg.counter(
                        "serving_resample_tokens_total",
                        "tokens drawn from the rejection-"
                        "sampling residual after a draft was "
                        "rejected (sampled speculation)").inc(1)

    def _on_token(self, slot: int, tok: int, now: float) -> None:
        """Record one sampled token for ``slot``: append, advance the
        cursor (it moves once the token is FED), finish on EOS/budget."""
        req = self._slot_req[slot]
        req.tokens.append(tok)
        self._last_tok[slot] = tok
        if req.status == "decode" and len(req.tokens) > 1:
            self._pos[slot] += 1
        if self._draftsman is not None and self._draftsman.host_only:
            self._draftsman.extend(slot, (tok,))
        telemetry.get_registry().counter(
            "serving_tokens_total", "serving tokens by kind").inc(
            kind="generated")
        sp = req.sampling
        if (sp.eos_id is not None and tok == sp.eos_id) \
                or len(req.tokens) >= sp.max_tokens:
            self._finish(slot, now)
        elif req.handoff and req.status == "decode":
            # prefill-tier park: the first token landed, so the prefill is
            # done. The slot goes inactive but keeps its request and its
            # blocks until the fleet evicts the KV to a decode tier
            self._active[slot] = False
            req.status = "prefilled"
            req.mark("prefilled", ts_s=now)
            flight_record("serving_prefill_handoff", req=req.id,
                          trace=req.trace_id, slot=slot,
                          prompt_len=len(req.prompt))

    # -- resumable preemption (QoS) -----------------------------------------
    def _spill_size(self, slot: int) -> int:
        """Blocks holding ``slot``'s ``pos`` written rows (at least one)."""
        return max(1, -(-int(self._pos[slot]) // self.pool.block_size))

    def _plan_preemption_locked(self) -> Optional[int]:
        """The decoding slot this iteration evicts for a blocked
        more-urgent request, or None. Admission has already run, so a
        head still queued here genuinely could not admit. Fires only when
        (a) that head exists, (b) a STRICTLY lower-priority request is
        decoding, and (c) the host arena can hold its blocks."""
        if not self.preempt or not self.scheduler.queue:
            return None
        cand = self.scheduler.peek_candidate()
        if cand is None:
            return None
        running = [(s, r) for s, r in enumerate(self._slot_req)
                   if r is not None and self._active[s]]
        slot = self.scheduler.preemption_victim(cand, running)
        if slot is None or not self.spill_arena.can_fit(
                self._spill_size(slot)):
            return None
        return slot

    def _spill_blocks(self, ids: np.ndarray, nb: int, *,
                      keep: bool = False) -> tuple:
        """Device→host copy of the first ``nb`` blocks of table ``ids``,
        every arena leaf: a gather along the block axis into a fresh
        device tensor, copied into (pinned, on the card) host memory —
        the spill store's when the entry stays in this engine (``keep``)
        and the store has room, else fresh buffers. The copies are
        complete when this returns."""
        return self._to_host(self._gather_blocks(ids, nb), keep=keep)

    def _gather_blocks(self, ids: np.ndarray, nb: int) -> list:
        """The first ``nb`` blocks of table ``ids``, every arena leaf,
        gathered into fresh device tensors: queued on the engine's stream
        after the replays that wrote them, so a later write to those
        blocks cannot reach the copy."""
        idx = torch.as_tensor(ids[:nb], dtype=torch.int64).to(self.device)
        return [c.index_select(1, idx) for c in self.pool.caches]

    def _to_host(self, gathered: list, *, keep: bool = False) -> tuple:
        """Device→host copy of gathered blocks into (pinned, on the card)
        host memory, complete when this returns."""
        dev = self.device
        nb = gathered[0].shape[1]
        out = self.spill_store.take(nb) \
            if keep and self.spill_store is not None else None
        if out is None:
            out = [torch.empty(g.shape, dtype=g.dtype,
                               pin_memory=dev.type == "cuda")
                   for g in gathered]
        for host, g in zip(out, gathered):
            host.copy_(g, non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return tuple(out)

    def _scatter_blocks(self, ids, data) -> None:
        """Host→device copy of ``data`` (per arena leaf, ``(layers, nb,
        block_size, ...)``) into arena blocks ``ids``, in place
        (``index_copy_``): the lanes replay the arena's addresses."""
        dev = self.device
        idx = torch.as_tensor(np.asarray(ids), dtype=torch.int64).to(dev)
        for c, src in zip(self.pool.caches, data):
            c.index_copy_(1, idx, src.to(dev))

    def _take_out(self, req: Request, slot: int, *,
                  keep: bool = False) -> SpillEntry:
        """Copy decoding ``req``'s written blocks to the host and free its
        slot and blocks; returns the spill entry, which this engine parks
        (``keep``) or hands to another engine. The slot's table row and
        mask are cleared here, so the next upload (before any replay)
        carries them; the gather is queued before the blocks go back to
        the free list, so a later write reaches them only after it read
        them."""
        nb = self._spill_size(slot)
        gen = self._gen[slot]
        entry = SpillEntry(
            req_id=req.id,
            data=self._spill_blocks(self._bt[slot], nb, keep=keep),
            n_blocks=nb, block_size=self.pool.block_size,
            pos=int(self._pos[slot]), last_tok=int(self._last_tok[slot]),
            tokens=list(req.tokens), weight_version=req.weight_version,
            gen_state=gen.get_state() if gen is not None else None,
            adapter=req.kv_adapter)
        req.spilled_blocks += nb
        self._detach_locked(req, slot)
        return entry

    def _detach_locked(self, req: Request, slot: int) -> None:
        """Free ``slot`` and every block ``req`` holds; the request's
        fate (requeue, resume elsewhere, drop) is the caller's."""
        self.scheduler.release(slot, table=self._bt[slot])
        self._bt[slot, :] = 0
        self._active[slot] = False
        self._pos[slot] = 0
        self._slot_req[slot] = None
        self._gen[slot] = None
        self._adapter_page[slot] = 0

    def _drop_spill(self, req: Request, *, resumed: bool = False
                    ) -> Optional[SpillEntry]:
        """Take ``req``'s spill out of this engine's arena, if the arena
        holds it (a cross-engine resume's entry never entered it), and
        return it; ``resumed`` as in :meth:`HostSpillArena.pop`. Its
        blocks in the spill store go back to the store: after a resume
        has read them, or after a copy for an entry leaving the engine."""
        entry = req.spill
        if entry is None or self.spill_arena.get(req.id) is not entry:
            return entry
        self.spill_arena.pop(req.id, resumed=resumed)
        store = self.spill_store
        if store is not None and store.owns(entry.data):
            data = entry.data
            if not resumed:
                entry.data = tuple(d.clone() for d in data)
            store.release(data)
        return entry

    def _exec_spill(self, slot: int) -> None:
        """Evict one decoding request into the host arena and requeue it
        at the head of the queue — the resumable half of preemption."""
        req = self._slot_req[slot]
        t0 = time.monotonic()
        entry = self._take_out(req, slot, keep=True)
        self.spill_arena.put(entry)
        req.spill = entry
        req.preemptions += 1
        req.mark("preempted", dur_s=time.monotonic() - t0, ts_s=t0)
        self.scheduler.requeue_preempted(req)
        self.scheduler.preemptions_total += 1
        reg = telemetry.get_registry()
        reg.counter(
            "serving_kv_spilled_blocks_total",
            "KV blocks copied device→host when a request was "
            "preempted (resumable eviction)").inc(entry.n_blocks)
        reg.counter(
            "serving_preemptions_total",
            "running requests evicted for more-urgent arrivals, "
            "by the VICTIM's priority class").inc(
            priority=str(req.sampling.priority))
        flight_record("serving_preempt", req=req.id, trace=req.trace_id,
                      slot=slot, blocks=entry.n_blocks,
                      priority=req.sampling.priority)

    def _exec_resume(self, job: dict) -> None:
        """Write one spilled request's KV into its freshly allocated
        blocks, in place (the lanes replay the arena's addresses), and
        flip its slot live: no prefill."""
        req, slot = job["req"], job["slot"]
        entry = req.spill
        nb = entry.n_blocks
        t0 = time.monotonic()
        self._scatter_blocks(self._bt[slot, :nb], entry.data)
        self._drop_spill(req, resumed=True)
        req.spill = None
        req.resumed_blocks += nb
        self._pos[slot] = entry.pos
        self._last_tok[slot] = entry.last_tok
        if entry.gen_state is not None:
            # the sampled stream resumes where the spill cut it
            self._gen[slot].set_state(entry.gen_state)
        self._active[slot] = True
        req.status = "decode"
        if self._draftsman is not None:
            self._draftsman.reset(slot, req.prompt.tolist() + req.tokens)
        now = time.monotonic()
        if req.first_token_s is None:
            # a cross-engine resume starts a fresh Request: its first
            # token happened on the engine it was spilled from
            req.first_token_s = now
        req.mark("resumed", dur_s=now - t0, ts_s=t0)
        telemetry.get_registry().counter(
            "serving_kv_resumed_blocks_total",
            "spilled KV blocks mapped back into fresh arena blocks "
            "on resume (prefill skipped entirely)").inc(nb)
        flight_record("serving_resume", req=req.id, trace=req.trace_id,
                      slot=slot, blocks=nb, pos=entry.pos)

    def evict_request(self, req: Request, *,
                      lock_timeout_s: Optional[float] = None
                      ) -> Optional[SpillEntry]:
        """Take ``req`` out of this engine now. Returns its spill entry
        when it had KV worth moving (a decoding slot, or a spilled
        request still queued or waiting to resume), else None (queued
        fresh or prefilling: nothing to move). The caller resumes it
        elsewhere with ``submit(prompt, sampling, resume=entry)``; the
        request's ``done`` event is not set. ``lock_timeout_s`` bounds
        the wait for the engine's lock (None if it ran out). The request
        drops its adapter pin and its tenant's QoS slot here."""
        if not self._acquire_both(lock_timeout_s):
            return None
        try:
            with torch.no_grad():
                entry = self._evict_request_locked(req)
        finally:
            self._release_both()
        if req.status == "evicted":
            self._stream_interrupt(req)
        if entry is not None and entry.traceparent is None:
            # the spill carries the request's trace context, so its resume
            # on another engine joins the same trace
            entry.traceparent = req.traceparent \
                or telemetry.make_traceparent(req.trace_id)
        if entry is not None and req.handoff:
            # a parked (handoff) request never reaches _finish here: its
            # queued and prefill spans are emitted now
            self._emit_request_trace(req)
        return entry

    def _acquire_both(self, timeout_s: Optional[float]) -> bool:
        """The iteration lock, at the loop's next iteration boundary, the
        device guard shared, then the state lock, within ``timeout_s`` in
        all (None: wait); False, holding none, when it ran out. Released
        by :meth:`_release_both`."""
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        with self._waiters_lock:
            self._boundary_waiters += 1
        try:
            got = self._step_lock.acquire(
                timeout=-1 if timeout_s is None else timeout_s)
        finally:
            with self._waiters_lock:
                self._boundary_waiters -= 1
        if not got:
            return False

        def left():
            return None if deadline is None \
                else max(0.0, deadline - time.monotonic())
        if DEVICE_GUARD.acquire_shared(left()):
            if self._lock.acquire(timeout=-1 if deadline is None
                                  else left()):
                return True
            DEVICE_GUARD.release_shared()
        self._step_lock.release()
        return False

    def _release_both(self) -> None:
        self._lock.release()
        DEVICE_GUARD.release_shared()
        self._step_lock.release()

    def _evict_request_locked(self, req: Request) -> Optional[SpillEntry]:
        if req.done.is_set():
            return None
        admitted = next(((pending, ent) for pending in
                         (self._resume_pending, self._prefilling)
                         for ent in pending if ent["req"] is req), None)
        slot = req.slot
        if req in self.scheduler.queue:
            self.scheduler.queue.remove(req)
            entry = self._drop_spill(req)
        elif admitted is not None:
            # a prefilling request carries no spill: nothing to move
            pending, ent = admitted
            pending.remove(ent)
            entry = self._drop_spill(req)
            self._detach_locked(req, ent["slot"])
        elif slot is not None and self._slot_req[slot] is req \
                and (self._active[slot] or req.status == "prefilled"):
            # a "prefilled" request is parked (handoff): its slot is
            # inactive but still holds its blocks, which is what the
            # prefill tier evicts to the decode tier
            entry = self._take_out(req, slot)
            telemetry.get_registry().counter(
                "serving_kv_spilled_blocks_total",
                "KV blocks copied device→host when a request was "
                "preempted (resumable eviction)").inc(entry.n_blocks)
            flight_record("serving_evict", req=req.id, trace=req.trace_id,
                          slot=slot, blocks=entry.n_blocks)
        else:
            return None
        req.status = "evicted"
        self._release_tenancy(req)
        return entry

    # -- the fleet-global KV plane -------------------------------------------
    def export_prefix(self, tokens: Sequence[int], *,
                      lock_timeout_s: Optional[float] = 2.0
                      ) -> Optional[SpillEntry]:
        """Gather this engine's cached whole-block prefix of ``tokens``
        into a :class:`SpillEntry` for a peer (the KVEXPORT verb;
        ``hetu_tpu/serving/engine.py:1168``). Read-only: the prefix cache
        keeps its refs, and the gather (:meth:`_spill_blocks`) runs under
        the iteration lock, which freezes all block churn. None on a
        whole-block miss or when ``lock_timeout_s`` ran out (a pull is
        best effort: the puller prefills)."""
        if not self._acquire_both(lock_timeout_s):
            return None
        try:
            toks = [int(t) for t in tokens]
            shared, _partial = self.prefix_cache.match(toks)
            nb = min(len(shared), self.pool.table_width)
            if nb == 0:
                return None
            version = self.weight_version
            with torch.no_grad():
                data = self._spill_blocks(np.asarray(shared[:nb], np.int32),
                                          nb)
        finally:
            self._release_both()
        bs = self.pool.block_size
        entry = SpillEntry(
            req_id=-1, data=data, n_blocks=nb, block_size=bs,
            pos=nb * bs, last_tok=0, tokens=toks[:nb * bs],
            weight_version=version)
        flight_record("fleet_kv_export", blocks=nb, tokens=nb * bs)
        return entry

    def import_prefix(self, entry: Optional[SpillEntry], *,
                      lock_timeout_s: Optional[float] = 2.0) -> bool:
        """Map a peer's exported prefix into this engine's prefix cache
        (the KVIMPORT verb; ``hetu_tpu/serving/engine.py:1206``): fresh
        arena blocks, the resume's in-place scatter
        (:meth:`_scatter_blocks`), then the token runs into the radix
        trie; from there on it is an ordinary prefix hit. Refused (False:
        the caller prefills) for an entry at another weight version or
        arena layout (:meth:`SpillEntry.compatible_with`: a push between
        export and import must never serve the old weights' KV), when no
        blocks can be freed, or when ``lock_timeout_s`` ran out."""
        if entry is None:
            return False
        if not entry.compatible_with(self.pool, self.weight_version):
            flight_record("fleet_kv_import_refused",
                          blocks=entry.n_blocks,
                          entry_version=entry.weight_version,
                          our_version=self.weight_version)
            return False
        toks = [int(t) for t in entry.tokens]
        nb, bs = entry.n_blocks, self.pool.block_size
        if nb < 1 or len(toks) < nb * bs or nb > self.pool.table_width:
            return False
        if not self._acquire_both(lock_timeout_s):
            return False
        try:
            shared, _partial = self.prefix_cache.match(toks)
            if len(shared) >= nb:
                return True                  # already warm here
            new_ids = []
            for _ in range(nb):
                b = self.blocks.alloc()
                if b is None and self.prefix_cache.evict(nb - len(new_ids)):
                    b = self.blocks.alloc()
                if b is None:                # full of pinned work
                    for x in new_ids:
                        self.blocks.release(x)
                    return False
                new_ids.append(b)
            with torch.no_grad():
                self._scatter_blocks(new_ids, entry.data)
            self.prefix_cache.insert(toks[:nb * bs], new_ids)
            # insert() took the trie's own ref on each node it adopted:
            # dropping ours leaves the trie the sole holder (LRU-evictable);
            # a block whose run was already cached goes back to the free
            # list
            for b in new_ids:
                self.blocks.release(b)
        finally:
            self._release_both()
        flight_record("fleet_kv_import", blocks=nb)
        return True

    # -- decode-KV replication, origin side ----------------------------------
    def configure_replication(self, sink, *, origin: str = "",
                              cadence_s: float = 0.02) -> None:
        """Point this engine's decode-KV replication stream at ``sink``, a
        callable taking one shipment doc (in process: the buddy's
        ``KVReplicaStore.put``; across processes: a KVREPL closure the
        KVBUDDY verb installs); None stops it
        (``hetu_tpu/serving/engine.py:1285``). A doc's arrays are host
        tensors (``hetu_tpu``'s are wire dicts already): a wire sink
        encodes them with ``serving.fleet.repl_doc_to_wire``."""
        with self._lock:
            self._repl_sink = sink
            self._repl_origin = origin
            self._repl_cadence_s = float(cadence_s)
            if sink is None:
                self._repl_sent.clear()
        if sink is None:
            if self._repl_stop is not None:
                self._repl_stop.set()
            self._repl_thread = None
            return
        if self._repl_thread is None or not self._repl_thread.is_alive():
            self._repl_stop = threading.Event()
            self._repl_thread = threading.Thread(
                target=self._repl_loop, args=(self._repl_stop,),
                daemon=True, name="serving-kv-repl")
            self._repl_thread.start()

    def _repl_loop(self, stop: threading.Event) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not stop.is_set():
            try:
                self._replicate_once()
            except Exception as e:                    # noqa: BLE001
                log.debug(f"kv replication cadence: {e}")
            stop.wait(self._repl_cadence_s)

    def _replicate_once(self) -> None:
        """One replication cadence (``hetu_tpu/serving/engine.py:1320``):
        for every decoding slot with a new COMPLETE block since its last
        shipment, ship the range from the last shipped tail block on
        (with a pos/tokens/generator snapshot taken in the same breath),
        then tombstone the requests that left. The iteration lock is
        held for the snapshot and the device gather only (queued on the
        engine's stream after the replays that wrote the blocks); the
        copy to the host and the sink run outside it. It is tried for one
        cadence, so a busy step skips a beat. A cadence with no completed
        block touches the device not at all."""
        if self._repl_sink is None:
            return
        bs = self.pool.block_size
        if not self._acquire_both(self._repl_cadence_s):
            return
        jobs, drops = [], []
        try:
            sink = self._repl_sink
            if sink is None:
                return
            live = set()
            for slot, req in enumerate(self._slot_req):
                if req is None or not self._active[slot] or req.handoff:
                    continue
                live.add(req.id)
                pos = int(self._pos[slot])
                complete = pos // bs
                rec = self._repl_sent.get(req.id)
                sent = rec[0] if rec is not None else -1
                if sent >= 0 and complete <= sent:
                    continue              # no new whole block
                start = max(0, sent)      # re-ship the old tail block
                cur = max(1, -(-pos // bs))
                gen = self._gen[slot]
                jobs.append({
                    "req": req, "start": start, "cur": cur, "pos": pos,
                    "complete": complete,
                    "last_tok": int(self._last_tok[slot]),
                    "tokens": list(req.tokens),
                    "gen_state": gen.get_state() if gen is not None
                    else None,
                    "ids": self._bt[slot, start:cur].copy()})
            for rid, rec in list(self._repl_sent.items()):
                if rid not in live:
                    drops.append(rec[1])
                    self._repl_sent.pop(rid, None)
            # the gather is queued on the engine's stream under the
            # iteration lock, after the replays that wrote the blocks;
            # the host copy (and its wait) runs outside it
            with torch.no_grad():
                for job in jobs:
                    job["data"] = self._gather_blocks(
                        job["ids"], job["cur"] - job["start"])
        finally:
            self._release_both()
        if not jobs and not drops:
            return
        with DEVICE_GUARD.shared(), torch.no_grad():
            for job in jobs:
                job["data"] = self._repl_to_host(job["data"])
        reg = telemetry.get_registry()
        for job in jobs:
            req = job["req"]
            # host tensors, not wire dicts: an in-process buddy takes them
            # as they are, a wire sink encodes them (``repl_doc_to_wire``)
            doc = {"trace_id": req.trace_id, "origin": self._repl_origin,
                   "req_id": req.id, "weight_version": req.weight_version,
                   "block_size": bs, "pos": job["pos"],
                   "last_tok": job["last_tok"], "tokens": job["tokens"],
                   "start": job["start"], "gen_state": job["gen_state"],
                   "traceparent": req.traceparent
                   or telemetry.make_traceparent(req.trace_id),
                   "data": list(job["data"])}
            try:
                sink(doc)
            except Exception:                         # noqa: BLE001
                continue          # buddy unreachable: the range retries
            with self._lock:
                self._repl_sent[req.id] = (job["complete"], req.trace_id)
            reg.counter(
                "fleet_kv_replicated_blocks_total",
                "decode-KV blocks streamed to the rendezvous buddy "
                "replica (block-granular cadence — the recovery set "
                "SIGKILL resumes from)").inc(job["cur"] - job["start"])
            flight_record("fleet_kv_replicate", req=req.id,
                          trace=req.trace_id, start=job["start"],
                          blocks=job["cur"] - job["start"], pos=job["pos"])
        for tid in drops:
            try:
                sink({"drop": tid})
            except Exception:                         # noqa: BLE001
                pass              # the store's cap ages it out instead

    def _repl_to_host(self, gathered: list) -> list:
        """One shipment's gathered blocks as pageable host tensors, which
        the buddy keeps: copied device→host into the engine's pinned
        staging buffers, then host→host. A pinned allocation a shipment
        goes through CUDA's host allocator while the loop launches
        and stalls its steps (``port_probe.py repl`` reads both forms),
        and the buddy would hold the pinned pages until the request
        ends. Complete when this returns."""
        if self.device.type != "cuda":
            return list(gathered)         # index_select made fresh copies
        if self._repl_stage is None:      # once a replica: a whole table
            width = self._bt.shape[1]
            self._repl_stage = [
                torch.empty(c[:, :width].numel(), dtype=c.dtype,
                            pin_memory=True) for c in self.pool.caches]
        views = [st[:g.numel()].view(g.shape)
                 for st, g in zip(self._repl_stage, gathered)]
        for v, g in zip(views, gathered):
            v.copy_(g, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        done.synchronize()
        return [torch.empty(v.shape, dtype=v.dtype).copy_(v)
                for v in views]

    def prefill_only(self, prompt: Sequence[int],
                     sampling: Optional[SamplingParams] = None, *,
                     timeout_s: Optional[float] = None,
                     traceparent: Optional[str] = None
                     ) -> tuple[Request, Optional[SpillEntry]]:
        """The prefill tier's entry point (``hetu_tpu/serving/engine.py:
        1415``): admit ``prompt``, run its prefill through the normal
        iterations, and return ``(req, entry)``: ``entry`` is the evicted
        :class:`SpillEntry` holding the prompt's KV and the first token,
        ready for ``submit(resume=entry)`` on a decode-tier engine. It is
        None when the request finished with its first token (EOS or
        ``max_tokens=1``: ``req.result()`` is the answer) or was
        rejected. Steps the engine itself when its loop is not running;
        otherwise waits."""
        req = self.submit(prompt, sampling, handoff=True,
                          traceparent=traceparent)
        if req.status == "rejected":
            return req, None
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        while req.status != "prefilled" and not req.done.is_set():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"prefill_only: request #{req.id} not prefilled "
                    f"within {timeout_s}s (status {req.status!r})")
            if self._thread is None:
                self.step()
            else:
                err = self._loop_error
                if err is not None:
                    raise RuntimeError(
                        f"the serving loop died: {err!r}") from err
                time.sleep(_BOUNDARY_POLL_S * 10)
        if req.done.is_set():
            return req, None
        return req, self.evict_request(req)

    def _finish(self, slot: int, now: float) -> None:
        req = self._slot_req[slot]
        req.status = "done"
        req.finish_s = now
        req.mark("finish", ts_s=now)
        self._active[slot] = False
        # an idle slot still rides the decode lane (output discarded):
        # at position 0 its attention reads one page, not its last
        # request's whole history
        self._pos[slot] = 0
        self._slot_req[slot] = None
        self._gen[slot] = None
        self._adapter_page[slot] = 0
        self._release_tenancy(req)
        # drop this slot's hold on every block it mapped; blocks the
        # prefix cache adopted stay resident (trie refs), the rest free
        self.scheduler.release(slot, table=self._bt[slot])
        self._bt[slot, :] = 0
        reg = telemetry.get_registry()
        reg.counter("serving_requests_total",
                    "serving requests by outcome").inc(outcome="completed")
        n = len(req.tokens)
        if n > 1 and req.first_token_s is not None:
            tpot = (now - req.first_token_s) / (n - 1)
            reg.histogram("serving_tpot_seconds",
                          "per-output-token time after the first").observe(
                tpot)
            if self.slo is not None:
                self.slo.observe("serving_tpot_seconds", tpot)
        if req.drafted:
            reg.histogram(
                "serving_draft_acceptance_ratio",
                "per-request accepted/drafted ratio at finish (the "
                "speculation win tracks this), split by verify path "
                "(greedy match vs rejection sampling)").observe(
                req.accepted / req.drafted,
                path="sampled" if req.sampling.temperature > 0
                else "greedy")
        flight_record("serving_finish", req=req.id, trace=req.trace_id,
                      slot=slot, tokens=n)
        self._emit_request_trace(req)
        req.done.set()

    def _emit_request_trace(self, req: Request) -> None:
        """Render the request's lifecycle as its own Perfetto track
        (``hetu_tpu/serving/engine.py:2443``): one span per phase (queued,
        prefill chunks, decode) on a synthetic tid named after its
        ``trace_id`` and derived from it (``telemetry.spans.
        request_track_tid``: a fleet's router and replicas in one process
        put one request's fragments on one track). Host-side, only when
        the tracer is on."""
        tracer = telemetry.get_tracer()
        if not tracer.enabled:
            return
        # request events use time.monotonic, the tracer's epoch
        # perf_counter: bridge by the current offset
        off = (time.perf_counter() - tracer.epoch) - time.monotonic()
        tid = request_track_tid(req.trace_id)
        tracer.name_track(tid, f"req {req.trace_id}")

        def span(name, start, dur, **attrs):
            tracer.complete(name, max(dur, 0.0), cat="request",
                            ts_s=max(start + off, 0.0), tid=tid,
                            trace_id=req.trace_id, req=req.id, **attrs)

        admit = next((t for p, t, _ in req.events if p == "admit"), None)
        if admit is not None:
            span("queued", req.submit_s, admit - req.submit_s)
        for phase, ts, dur in req.events:
            if phase == "prefill_chunk":
                span("prefill_chunk", ts, dur)
        if req.first_token_s is not None and req.finish_s is not None:
            span("decode", req.first_token_s,
                 req.finish_s - req.first_token_s,
                 tokens=len(req.tokens))

    def _record_gauges(self) -> None:
        reg = telemetry.get_registry()
        if not reg.enabled:
            return
        reg.gauge("serving_queue_depth",
                  "requests waiting for a slot").set(self.scheduler.depth)
        reg.gauge("serving_slot_occupancy",
                  "fraction of KV-pool slots in use").set(
            self.scheduler.occupancy)
        reg.gauge("serving_kv_blocks_in_use",
                  "live KV blocks (slot tables + prefix cache)").set(
            self.blocks.blocks_in_use)
        reg.gauge("serving_kv_spill_arena_blocks",
                  "KV blocks parked in the host spill arena "
                  "(preempted requests awaiting resume)").set(
            self.spill_arena.blocks_held)
        # the port has no peer tier: the host arena and the buddy
        # replica store hold every parked block
        g = reg.gauge(
            "spill_tier_blocks",
            "KV blocks parked per spill tier (host arena, peer tier, "
            "buddy replica store)")
        g.set(self.spill_arena.blocks_held, tier="host")
        g.set(self.kv_replica_store.blocks_held, tier="replica")
        if self.tenancy is not None:
            reg.gauge(
                "adapter_pages_in_use",
                "adapter arena pages holding a resident adapter").set(
                self.tenancy.registry.pages_in_use)

    # -- the multi-tenant adapter plane (serving/tenancy.py) ---------------
    def _init_adapter_arena(self) -> dict:
        """Zero-filled device pages for every adapter-targetable
        projection of the blocks (``DEFAULT_TARGETS`` among the attention's
        and a dense FFN's Linear layers): ``{proj: {"A": (L, P, in, r),
        "B": (L, P, r, out)}}`` fp32, P = ``max_adapters`` (A viewed so
        from in-major storage). Page 0 stays zero. An MoE FFN has no such
        layer (expert weights are never paged); attention adapters still
        apply there."""
        from hetu_tpu_torch.nn.parallel import ColumnParallelLinear
        P, r = self.tenancy.max_adapters, self.tenancy.r
        blk, L = self.model.blocks.block, self.model.blocks.num_layers
        pages: dict = {}
        for name in DEFAULT_TARGETS:
            lin = getattr(blk.attn, name, None) \
                or getattr(blk.mlp, name, None)
            if not isinstance(lin, ColumnParallelLinear):
                continue
            kw = dict(dtype=torch.float32, device=self.device)
            # A is stored in-major, (L, in, P, r) underneath: a layer's
            # pages read as one (in, P r) matrix, so ``lora_apply``'s
            # x A for every page is one product with no copy
            pages[name] = {
                "A": torch.zeros(L, lin.in_features, P, r,
                                 **kw).permute(0, 2, 1, 3),
                "B": torch.zeros(L, P, r, lin.out_features, **kw)}
        if not pages:
            raise ValueError(
                "tenancy= on a model with no LoRA-targetable projections "
                "(expected attn.{q,k,v,out}_proj and/or dense-FFN layers)")
        return pages

    def _write_adapter_page(self, page: int, spec) -> None:
        """Registry hook: (re)write one arena page in place; ``spec``
        None zeroes it (an eviction: a freed page must read exact zeros,
        not the evicted tenant's weights). The copies queue on the
        current stream, after every replay already launched; shapes and
        addresses never change, so the lanes never re-capture."""
        with torch.no_grad():
            for name, ab in self._lora_pages.items():
                src = spec.weights.get(name) if spec is not None else None
                for k in ("A", "B"):
                    dst = ab[k][:, page]
                    if src is None:
                        dst.zero_()
                    else:
                        dst.copy_(torch.tensor(src[k]))

    def load_adapter(self, tenant: Optional[str], name: str, weights, *,
                     scaling: float = 1.0) -> dict:
        """Register (or hot-swap) a tenant's LoRA adapter and make it
        arena-resident when a page can be had.

        ``weights`` is projection → ``{"A": (L, in, ra), "B": (L, ra,
        out)}`` host arrays (``tenancy.extract_adapter``'s layout; pass
        ``tenancy.lora_scaling`` of the LoRA model as ``scaling`` for
        merge parity). A (tenant, name) already loaded gets the next
        version. Replacing a live version is safe under traffic:
        the old version's page drains when its last in-flight request
        releases, its prefix-cache spans flush now, and the new version's
        fresh uid means no stale KV can ever match."""
        if self.tenancy is None:
            raise RuntimeError(
                "load_adapter on an engine without tenancy= — "
                "construct with ServingEngine(..., tenancy=True)")
        unknown = set(weights) - set(self._lora_pages)
        if unknown:
            raise ValueError(
                f"adapter targets projections this model does not "
                f"page: {sorted(unknown)} (arena pages: "
                f"{sorted(self._lora_pages)})")
        for proj, ab in weights.items():
            pg = self._lora_pages[proj]
            L, _, d_in, _ = pg["A"].shape
            d_out = pg["B"].shape[-1]
            a, b = np.asarray(ab["A"]), np.asarray(ab["B"])
            if a.shape[0] != L or a.shape[1] != d_in \
                    or b.shape[-1] != d_out:
                raise ValueError(
                    f"{proj}: adapter pages {a.shape}/{b.shape} do not "
                    f"fit this model's ({L}, {d_in}, ·)/(·, {d_out}) "
                    f"projection")
        registry = self.tenancy.registry
        self._acquire_both(None)    # the page is written in place
        try:
            with torch.no_grad():
                prev_uid = registry.get(tenant, name).uid \
                    if registry.has(tenant, name) else None
                spec = registry.register(tenant, name, weights,
                                         scaling=scaling)
                flushed = 0
                if prev_uid is not None:
                    # the replaced version's spans are already unmatchable
                    # (fresh uid) but still pin blocks: return them now
                    flushed = self.prefix_cache.flush_adapter(prev_uid)
                try:
                    registry.ensure_resident(tenant, name)
                except AdapterArenaFull:
                    pass    # loads at this adapter's first admission
        finally:
            self._release_both()
        if flushed:
            telemetry.get_registry().counter(
                "serving_prefix_flushed_total",
                "prefix-cache blocks flushed because their KV "
                "was computed under superseded weights").inc(flushed)
        return {"tenant": tenant, "name": name, "version": spec.version,
                "uid": spec.uid, "page": spec.page,
                "flushed_blocks": flushed}

    def evict_adapter(self, tenant: Optional[str], name: str) -> dict:
        """Deregister a tenant's adapter: its arena page frees now when
        idle (else when its last in-flight request releases), and its
        prefix-cache spans return their blocks now."""
        if self.tenancy is None:
            raise RuntimeError(
                "evict_adapter on an engine without tenancy=")
        registry = self.tenancy.registry
        self._acquire_both(None)
        try:
            uid = registry.get(tenant, name).uid \
                if registry.has(tenant, name) else None
            registry.deregister(tenant, name)
            flushed = 0
            if uid is not None:
                flushed = self.prefix_cache.flush_adapter(uid)
        finally:
            self._release_both()
        return {"flushed_blocks": flushed}

    def _admission_gate(self, req: Request) -> bool:
        """The scheduler's eligibility filter (installed with tenancy;
        called under the engine lock). False DEFERS the request without
        burning its class's deficit credits: a tenant token-bucket or
        slot-cap throttle, or an adapter arena full of pinned pages. It
        also refreshes ``req.kv_adapter``, so the page plan priced next
        matches the adapter version that will serve the request (a
        hot-swap between submit and admission re-tags it here)."""
        sp = req.sampling
        if req.adapter_ref is not None:
            return True      # a preempted resume: already pinned and paid
        plane = self.tenancy
        reason = None if req.id in self._qos_admitted \
            else plane.qos.check(sp.tenant)
        if reason is not None:
            if req.id not in self._throttle_logged:
                self._throttle_logged.add(req.id)
                plane.count("throttled", (sp.tenant or "base", reason))
                flight_record("tenant_throttle", req=req.id,
                              tenant=sp.tenant, reason=reason)
            return False
        if sp.adapter is not None:
            registry = plane.registry
            if registry.has(sp.tenant, sp.adapter):
                if not registry.resident(sp.tenant, sp.adapter) \
                        and not registry.can_load():
                    # every page pinned by in-flight requests: wait
                    if req.id not in self._wait_logged:
                        self._wait_logged.add(req.id)
                        plane.count("adapter_waits", sp.tenant or "base")
                        flight_record("adapter_wait", req=req.id,
                                      tenant=sp.tenant,
                                      adapter=sp.adapter)
                    return False
                req.kv_adapter = registry.kv_tag(
                    registry.get(sp.tenant, sp.adapter))
        return True

    def _bind_adapter_locked(self, req: Request, slot: int) -> bool:
        """Pin the request's tenancy state at admission: acquire an
        adapter-page ref (held across preemption, so a resume is
        guaranteed the same uid and page), stamp the slot's arena page
        and the request's KV-compat tag, and pay the tenant's QoS admit
        once per request. False: the adapter vanished between submit and
        admission (deregistered); the request is rejected and its slot
        and blocks unwind."""
        sp = req.sampling
        plane = self.tenancy
        if sp.adapter is not None and req.adapter_ref is None:
            try:
                spec = plane.registry.acquire(sp.tenant, sp.adapter)
            except (KeyError, AdapterArenaFull) as err:
                req.status, req.error = "rejected", str(err)
                self.scheduler.release(slot, table=req.admit["table"])
                telemetry.get_registry().counter(
                    "serving_requests_total",
                    "serving requests by outcome").inc(outcome="rejected")
                flight_record("serving_reject", req=req.id,
                              trace=req.trace_id, reason=str(err))
                req.done.set()
                return False
            req.adapter_ref = spec
            req.kv_adapter = plane.registry.kv_tag(spec)
        self._adapter_page[slot] = req.adapter_ref.page \
            if req.adapter_ref is not None else 0
        if req.id not in self._qos_admitted:
            self._qos_admitted.add(req.id)
            plane.qos.on_admit(sp.tenant)
            plane.count("admitted", sp.tenant or "base")
        self._throttle_logged.discard(req.id)
        self._wait_logged.discard(req.id)
        return True

    def _release_tenancy(self, req: Request) -> None:
        """Drop a request's tenancy holds as it leaves the engine (finish
        or eviction): the adapter-page ref and the tenant's QoS slot.
        Preemption does NOT come here: a preempted request keeps its ref,
        so its resume is guaranteed the same adapter uid."""
        if self.tenancy is None:
            return
        if req.adapter_ref is not None:
            self.tenancy.registry.release(req.adapter_ref)
            req.adapter_ref = None
        if req.id in self._qos_admitted:
            self._qos_admitted.discard(req.id)
            self.tenancy.qos.on_finish(req.sampling.tenant)
        self._throttle_logged.discard(req.id)
        self._wait_logged.discard(req.id)

    # -- lifecycle: drain, weight swap --------------------------------------
    def cancel_queued(self, ids=None) -> list[Request]:
        """Take QUEUED (not yet admitted) requests out of the scheduler
        and return them, status ``"cancelled"``: all of them, or those
        whose id is in ``ids``. Each releases its tenancy holds, and a
        preempted one takes its spill out of this engine's arena (kept
        on ``req.spill``, so another engine can resume it); their
        subscriptions close. Admitted requests are never touched: their
        KV is resident, so finishing them here is cheaper than anywhere
        else."""
        with self._lock:
            if ids is None:
                out = list(self.scheduler.queue)
                self.scheduler.queue.clear()
            else:
                out = [r for r in self.scheduler.queue if r.id in ids]
                for r in out:
                    self.scheduler.queue.remove(r)
            for r in out:
                self._drop_spill(r)
                self._release_tenancy(r)
                r.status = "cancelled"
        for r in out:
            self._stream_interrupt(r)
        return out

    def swap_params(self, params: Mapping[str, torch.Tensor], *,
                    version: Optional[int] = None) -> dict:
        """Install new weights on a DRAINED engine: the replica-local leg
        of a weight push (``hetu_tpu/serving/engine.py:1671``).

        ``params`` maps every parameter name of the model
        (``named_parameters``) to a tensor of its shape and dtype, on any
        device (``models.params_from_jax`` and ``utils.load_checkpoint``
        name them so). The whole mapping is checked before the first byte
        is written; then, between two iterations, the engine must hold no
        work (in-flight KV was computed under the old weights) and the
        values are copied in place into the model's own tensors, so the
        captured lanes keep reading the tensors they captured (no
        re-capture). A mismatched mapping raises ValueError and a busy
        engine RuntimeError, each with the weights bit-unchanged. The
        W8A8 tree (``w8a8=``) is re-quantized from the new weights into
        its own tensors (``hetu_tpu/serving/engine.py:1693-1696``): the
        decode lane reads them by address, so a new tree would leave it
        serving the old weights. Sets ``weight_version`` on the engine
        and the pool to ``version`` (a fleet publisher's generation), or
        the previous one plus one, and flushes the prefix cache's stale
        nodes. A draft
        model's weights are not swapped (as in ``hetu_tpu``). Returns
        ``{"version", "flushed_blocks"}``."""
        named = dict(self.model.named_parameters())
        missing = sorted(set(named) - set(params))
        extra = sorted(set(params) - set(named))
        if missing or extra:
            raise ValueError(
                f"swap_params: the mapping does not match the model's "
                f"parameters (missing {missing[:4]}, unknown "
                f"{extra[:4]})")
        for name, p in named.items():
            t = params[name]
            if not isinstance(t, torch.Tensor) \
                    or tuple(t.shape) != tuple(p.shape) \
                    or t.dtype != p.dtype:
                got = (tuple(t.shape), t.dtype) \
                    if isinstance(t, torch.Tensor) else type(t).__name__
                raise ValueError(
                    f"swap_params: {name} is {got}, the model's is "
                    f"{(tuple(p.shape), p.dtype)}")
        self._acquire_both(None)
        try:
            if self.scheduler.queue or self._prefilling \
                    or self._resume_pending or self._active.any():
                raise RuntimeError(
                    "swap_params on a busy engine — drain first "
                    "(cancel_queued + wait for has_work() to clear)"
                    ": in-flight KV was prefilled under the old "
                    "weights")
            with torch.no_grad():
                for name, p in named.items():
                    p.copy_(params[name])
                for blk, tree in zip(self.model.blocks,
                                     self._w8a8_wq or ()):
                    if tree is not None:
                        blk.mlp.prequantize(into=tree)
            self.weight_version = int(version) if version is not None \
                else self.weight_version + 1
            self.pool.weight_version = self.weight_version
            flushed = self.prefix_cache.set_version(self.weight_version)
            if flushed:
                telemetry.get_registry().counter(
                    "serving_prefix_flushed_total",
                    "prefix-cache blocks flushed because their KV was "
                    "computed under superseded weights").inc(flushed)
            self._record_gauges()
        finally:
            self._release_both()
        flight_record("weight_swap", version=self.weight_version,
                      flushed_blocks=flushed)
        return {"version": self.weight_version, "flushed_blocks": flushed}

    # -- run loops ----------------------------------------------------------
    def run_until_drained(self, max_steps: int = 1_000_000) -> int:
        """Drive :meth:`step` until queue and slots are empty; returns the
        number of iterations run."""
        n = 0
        while self.has_work():
            if n >= max_steps:
                raise RuntimeError(f"serving engine not drained after "
                                   f"{max_steps} iterations")
            self.step()
            n += 1
        return n

    def generate_many(
            self, prompts: Sequence[Sequence[int]],
            sampling: Union[SamplingParams, Sequence[SamplingParams],
                            None] = None) -> list[list[int]]:
        """Submit every prompt, run to drain, return per-request tokens in
        submission order. Arrival order and slot assignment do not change
        any request's tokens."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling or SamplingParams()] * len(prompts)
        reqs = [self.submit(p, sp) for p, sp in zip(prompts, sampling)]
        bad = [r for r in reqs if r.status == "rejected"]
        if bad:
            with self._lock:
                for r in reqs:
                    if r.status == "queued":
                        self.scheduler.queue.remove(r)
                        r.status = "cancelled"
                        r.error = "batch aborted: sibling rejected"
                        r.done.set()
            raise ValueError(
                f"{len(bad)} request(s) rejected at admission: "
                + "; ".join(f"#{r.id}: {r.error}" for r in bad[:3]))
        if self._thread is not None:
            for r in reqs:          # the loop thread owns the iterations
                self.result(r)
        else:
            self.run_until_drained()
        return [list(r.tokens) for r in reqs]

    # -- the background loop (online front ends) ---------------------------
    def start(self) -> None:
        """Run :meth:`step` on a daemon thread until :meth:`stop`,
        sleeping ``_IDLE_SLEEP_S`` after an iteration with nothing to do.
        The thread steps under the precision policy the lanes were
        captured under and with the engine's CUDA device current, so it
        replays the lanes as built. A step that raises ends the thread
        with the error (printed by the thread's hook); :meth:`result`
        and :meth:`stop` raise it. The watchdog (``watchdog=True``) is
        fed one beat a loop turn, idle turns included (it watches for a
        wedged iteration, not an empty queue), and the SLO engine
        evaluates every ``slo_every_s``, as in ``hetu_tpu``
        (``engine.py:2557-2597``)."""
        if self._thread is not None:
            return
        self._stop = threading.Event()
        self._loop_error = None
        stop, policy = self._stop, self.lanes["decode"].policy
        if self.watchdog is not None:
            self.watchdog.start()

        def loop():
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            try:
                with autocast(policy):
                    while not stop.is_set():
                        while self._boundary_waiters \
                                and not stop.is_set():
                            stop.wait(_BOUNDARY_POLL_S)  # let them in
                        busy = self.step()
                        if self.watchdog is not None:
                            self.watchdog.beat()
                        if self.slo is not None:
                            self._evaluate_slo()
                        if not busy:
                            stop.wait(_IDLE_SLEEP_S)
            except BaseException as err:
                self._loop_error = err
                raise

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serving-loop")
        self._thread.start()

    def _evaluate_slo(self) -> None:
        """Run the SLO detectors when ``slo_every_s`` has passed since
        the last evaluation; each alert is logged."""
        now = time.monotonic()
        if now - self._slo_last_eval < self._slo_every_s:
            return
        self._slo_last_eval = now
        for a in self.slo.evaluate():
            log.warning(f"SLO alert: {a.message}")

    def stop(self) -> None:
        """Stop the loop after its current iteration and join it. Raises
        when the loop died of an error, or did not stop within
        ``_STOP_JOIN_S``."""
        if self._repl_stop is not None:   # the replication stream
            self._repl_stop.set()
            if self._repl_thread is not None:
                self._repl_thread.join(timeout=_STOP_JOIN_S)
            self._repl_thread = None
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=_STOP_JOIN_S)
        if self._thread.is_alive():
            raise RuntimeError(f"the serving loop did not stop within "
                               f"{_STOP_JOIN_S} s")
        self._thread = None
        if self.watchdog is not None:
            self.watchdog.stop()
        err = self._loop_error
        if err is not None:
            raise RuntimeError(f"the serving loop died: {err!r}") from err
