"""hetu_tpu_torch — the PyTorch/CUDA port of ``hetu_tpu`` for NVIDIA Hopper.

The JAX package ``hetu_tpu`` stays the reference; this package mirrors its
layout (``core/``, ``ops/``, ``nn/``, ``models/``, ``optim/``,
``parallel/``, ``peft/``, ``engine/``, ``serving/``) so each module's
counterpart is easy to find. It imports torch and numpy only — never jax,
never ``hetu_tpu``.

Device rule: every entry point takes ``device=None``, which means
``"cuda"``. Without a card the caller has to ask for ``device="cpu"``
explicitly; nothing falls back to the CPU by itself. The kernel wrappers
follow the tensor's device: a CUDA tensor launches the hand-written
kernel (or raises), a CPU tensor runs the plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from hetu_tpu_torch.version import __version__  # noqa: F401


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``. Raises if the resolved device is CUDA and no
    card is present, instead of silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hetu_tpu_torch: CUDA is not available — pass device='cpu' "
            "to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
