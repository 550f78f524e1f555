"""Serving: the continuous-batching engine over the paged KV arena, the
draft plane of its speculative decoding, the multi-tenant adapter plane,
the online front end (token streaming and the line-protocol server) and
the in-process fleet (the router over replicas, the weight publisher,
the fleet prefix directory and the buddy store of replicated KV)."""

from hetu_tpu_torch.serving.engine import ServingEngine
from hetu_tpu_torch.serving.fleet import (
    KVReplicaStore, spill_from_wire, spill_to_wire,
)
from hetu_tpu_torch.serving.kv_pool import (
    NULL_BLOCK, BlockManager, HostSpillArena, KVPool, SpillEntry,
    SpillStore,
)
from hetu_tpu_torch.serving.prefix_cache import PrefixCache
from hetu_tpu_torch.serving.router import (
    FleetPrefixDirectory, ReplicaHandle, Router, RouterRequest,
    WeightPublisher, materialize_params,
)
from hetu_tpu_torch.serving.sampling import adjust_logits, sample_slots
from hetu_tpu_torch.serving.scheduler import (
    Request, SamplingParams, Scheduler,
)
from hetu_tpu_torch.serving.server import ServingServer
from hetu_tpu_torch.serving.speculative import (
    ModelDraftsman, NgramDraftsman, SpeculativeConfigError,
)
from hetu_tpu_torch.serving.streaming import TokenSubscription
from hetu_tpu_torch.serving.tenancy import (
    AdapterArenaFull, AdapterRegistry, AdapterSpec, TenantPlane,
    TenantPolicy, TenantQoS, extract_adapter, lora_scaling,
)

__all__ = ["AdapterArenaFull", "AdapterRegistry", "AdapterSpec",
           "BlockManager", "FleetPrefixDirectory", "HostSpillArena",
           "KVPool", "KVReplicaStore", "ModelDraftsman", "NULL_BLOCK",
           "NgramDraftsman", "PrefixCache", "ReplicaHandle", "Request",
           "Router", "RouterRequest", "SamplingParams", "Scheduler",
           "ServingEngine", "ServingServer", "SpeculativeConfigError",
           "SpillEntry", "SpillStore", "TenantPlane", "TenantPolicy",
           "TenantQoS", "TokenSubscription", "WeightPublisher",
           "adjust_logits", "extract_adapter", "lora_scaling",
           "materialize_params", "sample_slots", "spill_from_wire",
           "spill_to_wire"]
