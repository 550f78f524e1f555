"""Serving: the continuous-batching engine over the paged KV arena, the
draft plane of its speculative decoding, the multi-tenant adapter plane,
and the online front end (token streaming and the line-protocol
server)."""

from hetu_tpu_torch.serving.engine import ServingEngine
from hetu_tpu_torch.serving.kv_pool import (
    NULL_BLOCK, BlockManager, HostSpillArena, KVPool, SpillEntry,
    SpillStore,
)
from hetu_tpu_torch.serving.prefix_cache import PrefixCache
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
           "BlockManager", "HostSpillArena", "KVPool", "ModelDraftsman",
           "NULL_BLOCK", "NgramDraftsman", "PrefixCache", "Request",
           "SamplingParams", "Scheduler", "ServingEngine", "ServingServer",
           "SpeculativeConfigError", "SpillEntry", "SpillStore",
           "TenantPlane", "TenantPolicy", "TenantQoS", "TokenSubscription",
           "adjust_logits",
           "extract_adapter", "lora_scaling", "sample_slots"]
