from hetu_tpu_torch.parallel.strategy import Strategy

__all__ = ["Strategy"]
