"""LoRA: low-rank adapters over Linear layers, multi-task capable
(counterpart of ``hetu_tpu/peft/lora.py``).

:func:`inject_lora` replaces the matching Linear layers of a model with
:class:`LoraLinear` wrappers in place; the wrapped layer's own params move
under ``….base.`` in the state dict, beside the adapter factors ``lora_A``
(tasks, in, r) and ``lora_B`` (tasks, r, out). :func:`wrap_params_for_lora`
carries a state dict taken before the injection into those names, so a
pretrained checkpoint keeps loading; :func:`lora_trainable_mask` marks the
adapters for ``optim.masked``; :func:`merge_lora` folds one task's
adapters back into the base weights and returns a state dict of the model
as it was before the injection.

``hetu_tpu`` stacks the blocks on a leading layer axis, so its block
factors are ``(layers, tasks, in, r)``; the port's ``blocks.{i}`` are
wrapped one by one (``models.convert.params_from_jax`` un-stacks them).
The factors are not transposed: ``A`` maps ``in`` to ``r`` in both
packages, where the port's Linear weight is ``(out, in)``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from hetu_tpu_torch.core.dtypes import current_policy
from hetu_tpu_torch.nn.parallel import ColumnParallelLinear

_FACTORS = ("lora_A", "lora_B")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    alpha: float = 16.0
    num_tasks: int = 1
    # regexes matched against dotted module paths (e.g. "blocks.0.attn.q_proj")
    target_patterns: Sequence[str] = (r"\.(q_proj|k_proj|v_proj|"
                                      r"out_proj|fc_in|fc_out|gate_proj|"
                                      r"up_proj)$",)

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


class LoraLinear(nn.Module):
    """Wraps a Linear (``.base``): ``y = base(x) + scaling · ((x A) B)``.

    ``lora_A`` (tasks, in, r) is drawn from N(0, 0.02) with ``generator``
    (on the base weight's device), ``lora_B`` (tasks, r, out) starts at
    zero, so a fresh adapter leaves the layer's output as it was. Both
    take the base weight's dtype. The delta is computed at the policy's
    compute dtype, as ``hetu_tpu`` computes it (``:78-84``)."""

    def __init__(self, base: nn.Module, cfg: LoraConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.base = base
        self.cfg = cfg
        w = base.weight
        kw = dict(device=w.device, dtype=w.dtype)
        a = torch.empty(cfg.num_tasks, base.in_features, cfg.r, **kw)
        with torch.no_grad():
            a.normal_(0.0, 0.02, generator=generator)
        self.lora_A = nn.Parameter(a)
        self.lora_B = nn.Parameter(torch.zeros(
            cfg.num_tasks, cfg.r, base.out_features, **kw))

    def forward(self, x: torch.Tensor, *, task_id: int = 0) -> torch.Tensor:
        y = self.base(x)
        dt = current_policy().compute_dtype
        delta = torch.matmul(torch.matmul(x.to(dt), self.lora_A[task_id]
                                          .to(dt)),
                             self.lora_B[task_id].to(dt))
        return y + self.cfg.scaling * delta


def _match(path: str, patterns: Sequence[str]) -> bool:
    return any(re.search(p, path) for p in patterns)


def inject_lora(model: nn.Module, cfg: LoraConfig, *,
                seed: int = 0) -> list[str]:
    """Replace every Linear child whose dotted path matches
    ``cfg.target_patterns`` with a :class:`LoraLinear` (in place; the
    ``lora_A`` factors drawn in module order from one generator seeded
    with ``seed``). Returns the wrapped paths."""
    gen = None
    wrapped = []
    for path, mod in list(model.named_modules()):
        if isinstance(mod, LoraLinear):
            continue
        for name, child in list(mod.named_children()):
            if not isinstance(child, ColumnParallelLinear):
                continue
            child_path = f"{path}.{name}" if path else name
            if _match(child_path, cfg.target_patterns):
                if gen is None:
                    gen = torch.Generator(device=child.weight.device)
                    gen.manual_seed(int(seed))
                setattr(mod, name, LoraLinear(child, cfg, generator=gen))
                wrapped.append(child_path)
    return wrapped


def wrap_params_for_lora(model: nn.Module, state: Mapping[str, torch.Tensor],
                         *, seed: int = 0) -> dict:
    """A state dict of ``model`` (called after :func:`inject_lora`) from
    ``state``, a state dict taken before the injection: each wrapped
    layer's params come from their old names (``….q_proj.weight`` →
    ``….q_proj.base.weight``), the rest keep their names, and the
    adapters start fresh (``lora_A`` ~ N(0, 0.02) drawn in order from a
    generator seeded with ``seed``, ``lora_B`` zero). A name ``state``
    lacks keeps the model's current value."""
    current = model.state_dict()
    gen = None
    out = {}
    for name, leaf in current.items():
        if name.endswith("lora_A"):
            if gen is None:
                gen = torch.Generator(device=leaf.device)
                gen.manual_seed(int(seed))
            out[name] = torch.empty_like(leaf).normal_(0.0, 0.02,
                                                       generator=gen)
        elif name.endswith("lora_B"):
            out[name] = torch.zeros_like(leaf)
        else:
            out[name] = state.get(name.replace(".base.", "."), leaf)
    return out


def lora_trainable_mask(model: nn.Module) -> dict:
    """``{param name: bool}``: True for the adapter factors, False for
    every frozen base param (``optim.masked``'s mask)."""
    return {name: name.endswith(_FACTORS)
            for name, _ in model.named_parameters()}


@torch.no_grad()
def merge_lora(model: nn.Module, *, task_id: int = 0) -> dict:
    """Fold task ``task_id``'s adapters into the base weights
    (``W += scaling · (A B)ᵀ`` in the port's ``(out, in)`` layout) and
    return a state dict of the model as it was before the injection.
    As ``hetu_tpu`` does, one scaling serves every layer (the first
    :class:`LoraLinear`'s) and the delta is cast to the weight's dtype
    before it is added."""
    sd = model.state_dict()
    scale = _first_lora_scaling(model)
    out = {}
    for name, leaf in sd.items():
        if name.endswith(_FACTORS):
            continue
        if ".base." not in f".{name}":
            out[name] = leaf
            continue
        cut = name.index("base.")
        prefix = name[:cut]
        new_name = (prefix + name[cut + 5:]).replace("..", ".")
        if name.endswith("weight"):
            a = sd[prefix + "lora_A"][task_id]             # (in, r)
            b = sd[prefix + "lora_B"][task_id]             # (r, out)
            leaf = leaf + (scale * (a @ b)).t().to(leaf.dtype)
        out[new_name] = leaf
    return out


def _first_lora_scaling(model: nn.Module) -> float:
    for _, mod in model.named_modules():
        if isinstance(mod, LoraLinear):
            return mod.cfg.scaling
    return 1.0
