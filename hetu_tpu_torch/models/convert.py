"""Carry ``hetu_tpu`` parameters (and grads) into the port, and name the
port's parameters as ``hetu_tpu`` lays them out (:func:`jax_param_layout`,
the inverse, which checkpoints use).

``hetu_tpu`` keeps (a) every block parameter stacked on a leading layer
axis (``StackedBlocks``, ``hetu_tpu/nn/parallel.py:851``) and (b) Linear
weights as ``(in, out)`` (``hetu_tpu/nn/parallel.py:81``). The port keeps
one module per layer (``blocks.{i}.…``) and ``F.linear``'s ``(out, in)``.
Keys are the dotted paths of ``hetu_tpu/utils/checkpoint.py:40
_key_str``, so a flattened ``hetu_tpu`` checkpoint converts as well.
A LoRA-wrapped tree (``hetu_tpu/peft/lora.py``) converts as well: a
wrapped Linear's weight under ``….base.`` is transposed like any Linear
weight, and its factors ``lora_A`` (layers, tasks, in, r) and ``lora_B``
(layers, tasks, r, out) are un-stacked along the layers and not
transposed (the port's ``LoraLinear`` reads them as JAX does).
Each leaf keeps its dtype; a bfloat16 leaf (numpy's ``ml_dtypes``
bfloat16, which torch cannot read) crosses through float32, which holds
every bfloat16 value exactly.
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping

import numpy as np
import torch

# the block parameters that are Linear weights (GPT's and Llama's; every
# other block parameter is a norm scale or bias, or an MoE leaf —
# ``mlp.gate.weight`` (d, E) as ``x @ W`` reads it, ``mlp.gate.centroids``
# and the expert stacks ``mlp.wi``/``wg``/``wo``, read as ``hetu_tpu``
# lays them out), and the top-level ones (Llama's untied LM head);
# embeddings and norms are never transposed
_LINEAR_WEIGHTS = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                   "out_proj.weight", "fc_in.weight", "fc_out.weight",
                   "gate_proj.weight", "up_proj.weight")
_TOP_LINEAR_WEIGHTS = ("lm_head.weight",)


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _tensor(a) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(a, dtype=np.float32, order="C")).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def params_from_jax(tree, cfg) -> dict:
    """``hetu_tpu`` GPT or Llama params, dense or MoE, plain or
    LoRA-wrapped (a nested dict of
    arrays, or its flattened ``{dotted.key: array}`` form) → the port's
    ``state_dict`` (CPU tensors; ``load_state_dict`` moves them to the
    model's device)."""
    flat = _flatten(tree)
    state = {}
    for key, arr in flat.items():
        if not key.startswith("blocks."):
            state[key] = _tensor(arr.T if key in _TOP_LINEAR_WEIGHTS
                                 else arr)
            continue
        rest = key[len("blocks."):]
        if arr.shape[0] != cfg.num_layers:
            raise ValueError(f"{key}: leading layer axis {arr.shape[0]} != "
                             f"num_layers {cfg.num_layers}")
        linear = rest.replace(".base.", ".").endswith(_LINEAR_WEIGHTS)
        for i in range(cfg.num_layers):
            a = arr[i]
            if linear:
                a = a.T
            state[f"blocks.{i}.{rest}"] = _tensor(a)
    return state


#: a ``hetu_tpu`` grad tree has the params' structure and layouts, so the
#: same change carries it into the port's names, to compare key by key
#: with ``{name: p.grad}`` of the port's model
grads_from_jax = params_from_jax


def jax_param_layout(names: Iterable[str]) -> dict:
    """The inverse of :func:`params_from_jax`'s change: ``{hetu_tpu
    flattened key: [(port param name, transposed), ...]}`` for the port's
    param ``names``, in the order ``hetu_tpu`` flattens its tree (sorted
    by path). A ``blocks.`` key lists the layers' params in layer order
    (``hetu_tpu`` stacks them on a leading axis); any other key lists
    one. ``transposed`` marks a Linear weight, ``(out, in)`` in the port
    and ``(in, out)`` in ``hetu_tpu``."""
    out: dict = {}
    layers: dict = {}
    for name in names:
        m = re.fullmatch(r"blocks\.(\d+)\.(.+)", name)
        if m is None:
            out[name] = [(name, name in _TOP_LINEAR_WEIGHTS)]
            continue
        layers.setdefault(m.group(2), {})[int(m.group(1))] = name
    for rest, by_layer in layers.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"blocks.*.{rest}: layers {sorted(by_layer)} "
                             f"are not 0..L-1")
        linear = rest.replace(".base.", ".").endswith(_LINEAR_WEIGHTS)
        out[f"blocks.{rest}"] = [(by_layer[i], linear)
                                 for i in range(len(by_layer))]
    return dict(sorted(out.items(), key=lambda kv: kv[0].split(".")))
