"""Strategy (counterpart of ``hetu_tpu/parallel/strategy.py``), cut to
the single-device step.

It keeps the fields that step reads. The parallel degrees are accepted
so a ``hetu_tpu`` strategy reads the same, but anything above one device
raises: multi-GPU strategies are the port's fourth slice.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

REMATS = ("none", "full", "selective")


@dataclasses.dataclass(frozen=True)
class Strategy:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    cp: int = 1
    ep: int = 1
    num_microbatches: int = 1     # gradient-accumulation microbatches
    remat: str = "none"           # "none" | "full" | "selective"
    offload: bool = False         # host offload of remat'd activations
    remat_mask: Optional[tuple] = None   # per-layer recompute flags
    unroll: bool = False          # accepted; the port has no layer scan
    fsdp: bool = False            # accepted: one device shards nothing

    def __post_init__(self):
        degrees = {a: getattr(self, a) for a in ("dp", "tp", "pp", "cp",
                                                 "ep")}
        if any(n != 1 for n in degrees.values()):
            raise NotImplementedError(
                f"slice 4: the port runs one device only, got {degrees}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got "
                             f"{self.remat!r}")
        if self.num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got "
                             f"{self.num_microbatches}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))
