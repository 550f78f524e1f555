"""Serving: the continuous-batching engine over the paged KV arena, and
the draft plane of its speculative decoding."""

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
from hetu_tpu_torch.serving.speculative import (
    ModelDraftsman, NgramDraftsman, SpeculativeConfigError,
)

__all__ = ["BlockManager", "HostSpillArena", "KVPool", "ModelDraftsman",
           "NULL_BLOCK", "NgramDraftsman", "PrefixCache", "Request",
           "SamplingParams", "Scheduler", "ServingEngine",
           "SpeculativeConfigError", "SpillEntry", "SpillStore",
           "adjust_logits", "sample_slots"]
