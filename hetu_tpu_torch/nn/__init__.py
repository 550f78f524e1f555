from hetu_tpu_torch.nn.layers import Embedding, LayerNorm, RMSNorm
from hetu_tpu_torch.nn.parallel import (
    ColumnParallelLinear, ParallelAttention, ParallelMLP, RowParallelLinear,
    StackedBlocks, VocabParallelEmbedding,
)

__all__ = ["ColumnParallelLinear", "Embedding", "LayerNorm", "RMSNorm",
           "ParallelAttention", "ParallelMLP", "RowParallelLinear",
           "StackedBlocks", "VocabParallelEmbedding"]
