"""Mixed-precision policy (counterpart of ``hetu_tpu/core/dtypes.py``).

Params live in ``param_dtype``; modules cast to ``compute_dtype`` at the
same points as ``hetu_tpu`` does, not where ``torch.autocast`` would:

- Linear casts x, W and b to the compute dtype before the matmul;
- LayerNorm computes in fp32 and returns the compute dtype;
- Embedding returns the compute dtype;
- the LM head multiplies in the compute dtype into fp32 logits.

The policy is thread-local state that modules read when they run. The
autograd engine runs a CUDA backward on a thread of its own, so code that
recomputes a forward in the backward (``StackedBlocks`` remat) captures
the policy at forward time and enters it again around the recompute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Union

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """How params are stored, compute is done and outputs returned."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


#: full precision (the default)
FP32 = Policy()
#: bf16 compute over fp32 params — the training configuration
BF16_COMPUTE = Policy(param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16,
                      output_dtype=torch.float32)
#: bf16 params too
BF16_FULL = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                   output_dtype=torch.bfloat16)

_NAMED = {"fp32": FP32, "bf16": BF16_COMPUTE, "bf16_full": BF16_FULL}
_state = threading.local()


def current_policy() -> Policy:
    return getattr(_state, "policy", FP32)


@contextlib.contextmanager
def autocast(policy: Union[Policy, str] = BF16_COMPUTE):
    """Inside the context, modules on this thread compute under
    ``policy`` (``"fp32"``, ``"bf16"``, ``"bf16_full"`` or a
    :class:`Policy`)."""
    if isinstance(policy, str):
        policy = _NAMED[policy]
    prev = getattr(_state, "policy", FP32)
    _state.policy = policy
    try:
        yield policy
    finally:
        _state.policy = prev
