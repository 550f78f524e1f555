"""Checkpoints of a train state, in ``hetu_tpu``'s format (counterpart of
``hetu_tpu/utils/checkpoint.py``: ``CheckpointWriter`` :77,
``save_checkpoint`` :102, split archives :188, ``load_checkpoint`` :223).

A checkpoint is a directory: ``checkpoint.safetensors`` (or, with
``max_shard_bytes``, ``checkpoint-0000i-of-0000n.safetensors`` and
``checkpoint.safetensors.index.json``) and ``meta.json`` (``step``,
``format_version`` 1, ``quantized``). Either package loads what the
other writes, so the port writes ``hetu_tpu``'s names and layouts:

- params are ``model.<key>``, ``key`` the path of ``hetu_tpu``'s param
  tree: block params stacked on a leading layer axis
  (``blocks.attn.q_proj.weight`` (L, in, out)), Linear weights ``(in,
  out)`` (``models.convert.jax_param_layout``);
- optimizer state is ``opt.<path>``, the path of ``hetu_tpu``'s
  optimizer-state tree (the spec's ``jax_state_layout``): for
  ``adamw`` ``opt.0.count`` (int32, shape ()), ``opt.0.mu.<key>``,
  ``opt.0.nu.<key>`` (fp32, the param's layout) and ``opt.2`` (the
  rate schedule's count); under ``chain(clip, adamw)`` the same below
  ``opt.1.``. ``hetu_tpu`` keeps moments for every param, a frozen one's
  (``masked``) zero; the port keeps none for it, writes zeros and reads
  none back.

The safetensors format is written and read here (the port imports no
``safetensors``): an 8-byte little-endian header length, a JSON header
``{name: {dtype, shape, data_offsets}}`` padded with spaces to a
multiple of 8 bytes, then the raw little-endian bytes, tensors ordered
as ``safetensors`` orders them (by dtype, widest first, then by name),
so the bytes are those ``safetensors`` writes.

A save takes its snapshot before it returns: every tensor is copied to
the host (``to("cpu", copy=True)``: the step updates params and
moments in place, and a CPU tensor's ``.cpu()`` would be the tensor
itself). With ``async_save`` the layout change and the file write then
run on a thread. A load puts each tensor where the model's param lives.
The snapshot runs in a ``checkpoint_gather`` span and the write in a
``checkpoint_write`` span (on the writer's thread); with telemetry on the
write's latency lands in ``checkpoint_write_seconds``, as in
``hetu_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import struct
import threading
import time
from typing import TYPE_CHECKING, Mapping, NamedTuple, Optional, Sequence

import torch
from torch import nn

from hetu_tpu_torch import telemetry
from hetu_tpu_torch.models.convert import jax_param_layout
from hetu_tpu_torch.ops.quantization import dequantize_int8, quantize_int8

if TYPE_CHECKING:  # engine imports this module (Trainer.save / resume)
    from hetu_tpu_torch.engine.state import TrainState

_MODEL_PREFIX = "model."
_OPT_PREFIX = "opt."
_META_FILE = "meta.json"
_WEIGHTS_FILE = "checkpoint.safetensors"
_INDEX_FILE = "checkpoint.safetensors.index.json"

_DTYPE_NAMES = {torch.bool: "BOOL", torch.uint8: "U8", torch.int8: "I8",
                torch.int16: "I16", torch.float16: "F16",
                torch.bfloat16: "BF16", torch.int32: "I32",
                torch.float32: "F32", torch.float64: "F64",
                torch.int64: "I64"}
_NAME_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}
#: ``safetensors``' dtype order; a file holds the later ones first
_DTYPE_ORDER = ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32",
                "U32", "F32", "F64", "I64", "U64")


# -- the safetensors format ---------------------------------------------------

class _Entry(NamedTuple):
    """One tensor of a file: ``parts`` (CPU tensors of one dtype) whose
    bytes, in order, make a tensor of ``shape`` (a stacked leaf: one part
    a layer)."""

    parts: tuple
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.parts[0].element_size()


def _entry(value) -> _Entry:
    if isinstance(value, _Entry):
        return value
    return _Entry((value,), tuple(value.shape))


def _raw(t: torch.Tensor):
    """The little-endian bytes of a CPU tensor, as a numpy view."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def save_tensors(filename: str, tensors: Mapping,
                 metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``{name: CPU tensor}`` (or an ``_Entry`` of parts) as one
    safetensors file (written to a temporary name, then renamed)."""
    entries = {k: _entry(v) for k, v in tensors.items()}
    for name, e in entries.items():
        if e.dtype not in _DTYPE_NAMES:
            raise TypeError(f"{name}: no safetensors dtype for {e.dtype}")
    order = sorted(entries, key=lambda k: (
        -_DTYPE_ORDER.index(_DTYPE_NAMES[entries[k].dtype]), k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    off = 0
    for name in order:
        e = entries[name]
        header[name] = {"dtype": _DTYPE_NAMES[e.dtype],
                        "shape": list(e.shape),
                        "data_offsets": [off, off + e.nbytes]}
        off += e.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{filename}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in order:
            for part in entries[name].parts:
                f.write(_raw(part))
    os.replace(tmp, filename)


def load_tensors(path: str) -> dict:
    """``{name: CPU tensor}`` of a safetensors file, or of a checkpoint
    directory (one file, or the split archives its index names)."""
    if os.path.isdir(path):
        index = os.path.join(path, _INDEX_FILE)
        if not os.path.exists(index):
            return load_tensors(os.path.join(path, _WEIGHTS_FILE))
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        out: dict = {}
        for fname in sorted(set(weight_map.values())):
            out.update(load_tensors(os.path.join(path, fname)))
        return out
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        header.pop("__metadata__", None)
        for name, spec in sorted(header.items(),
                                 key=lambda kv: kv[1]["data_offsets"][0]):
            if spec["dtype"] not in _NAME_DTYPES:
                raise TypeError(f"{name}: dtype {spec['dtype']} not read")
            t = torch.empty(spec["shape"], dtype=_NAME_DTYPES[spec["dtype"]])
            lo, hi = spec["data_offsets"]
            raw = t.reshape(-1).view(torch.uint8).numpy()
            if hi - lo != raw.nbytes:
                raise ValueError(f"{name}: {hi - lo} bytes for shape "
                                 f"{spec['shape']} {spec['dtype']}")
            f.seek(base + lo)
            view, got = memoryview(raw), 0
            while got < raw.nbytes:
                k = f.readinto(view[got:])
                if not k:
                    raise ValueError(f"{path}: truncated at {name}")
                got += k
            out[name] = t
    return out


def _save_sharded(path: str, entries: dict, max_shard_bytes: int) -> None:
    """Split archives as ``hetu_tpu`` cuts them (:188): tensors in order,
    a new shard when the next one would pass ``max_shard_bytes``."""
    shards: list = [{}]
    sizes = [0]
    for name, e in entries.items():
        if sizes[-1] > 0 and sizes[-1] + e.nbytes > max_shard_bytes:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = e
        sizes[-1] += e.nbytes
    n = len(shards)
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"checkpoint-{i + 1:05d}-of-{n:05d}.safetensors"
        save_tensors(os.path.join(path, fname), shard)
        for name in shard:
            weight_map[name] = fname
    with open(os.path.join(path, _INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_shards": n},
                   "weight_map": weight_map}, f)


# -- the state in hetu_tpu's layout -------------------------------------------

def _host(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    """A host copy of ``t`` in ``hetu_tpu``'s layout (a Linear weight
    transposed where it lives, so the copy is contiguous)."""
    t = t.detach()
    if transposed:
        t = t.t().contiguous()
    return t.to("cpu", copy=True)


def _jax_parts(layout: dict, tensors: Mapping) -> dict:
    """``{hetu_tpu key: _Entry}`` of per-name host copies in
    ``hetu_tpu``'s layout (params, or a moment of each): a block leaf
    stacked, one part a layer."""
    out = {}
    for key, parts in layout.items():
        views = tuple(tensors[name] for name, _ in parts)
        shape = tuple(views[0].shape)
        out[key] = _Entry(views, (len(views), *shape)
                          if key.startswith("blocks.") else shape)
    return out


def _quantized(e: _Entry) -> tuple:
    """``quantize_int8`` of each part over its last axis (the stacked
    leaf's last axis): the codes and scales ``hetu_tpu`` stores."""
    qs, scales = zip(*(quantize_int8(p.float()) for p in e.parts))
    n = len(e.parts) if len(e.shape) > qs[0].dim() else None
    if n is None:
        return _Entry(qs, e.shape), _Entry(scales, tuple(scales[0].shape))
    return (_Entry(qs, e.shape),
            _Entry(scales, (n, *scales[0].shape)))


#: each optimizer-state kind of ``hetu_tpu`` (``jax_state_layout``):
#: whether it keeps its own update count, and (port state key, field) of
#: its per-param moments; adafactor's factored moments are laid out by
#: :func:`_adafactor_entries`
_KINDS = {"adam": (True, (("mu", "mu"), ("nu", "nu"))),
          "amsgrad": (True, (("mu", "mu"), ("nu", "nu"),
                             ("max_nu", "max_nu"))),
          "trace": (False, (("trace", "velocity"),)),
          "adagrad": (False, (("accum", "accum"),)),
          "adafactor": (True, ())}


def _kind(slots: dict):
    return next((k for k in _KINDS if k in slots), None)


def _optimizer_state(optimizer, names: dict, transposed: dict) -> tuple:
    """``(count, {state key: {param name: host copy}})`` of a port
    optimizer: its update count (one for all params, as ``hetu_tpu``
    keeps it) and its moments, in ``hetu_tpu``'s layout."""
    counts, moments = set(), {}
    for p, st in optimizer.state.items():
        for k, v in st.items():
            if k == "count":
                counts.add(int(v))
            else:
                moments.setdefault(k, {})[names[p]] = _host(
                    v, transposed[names[p]])
    if len(counts) > 1:
        raise ValueError(f"the params' update counts differ "
                         f"({sorted(counts)}): hetu_tpu keeps one count")
    return (counts.pop() if counts else 0), moments


def _adafactor_factored(optimizer, shape) -> bool:
    from hetu_tpu_torch.optim.optimizers import adafactor_factored
    return adafactor_factored(
        shape, optimizer.param_groups[0]["min_dim_size_to_factor"])


def _moment_shapes(key: str, shape: tuple, factored: bool) -> dict:
    """``hetu_tpu``'s shapes of adafactor's ``v_row``/``v_col``/``v`` for
    a leaf of ``shape``: the row and column means of a factored leaf and
    a (1,) placeholder for ``v``, or the other way round."""
    one = (1,)
    if factored:
        return {"v_row": shape[:-1], "v_col": shape[:-2] + shape[-1:],
                "v": one}
    return {"v_row": one, "v_col": one, "v": shape}


def _adafactor_entries(optimizer, layout: dict, moments: dict,
                       params: dict, prefix: str) -> dict:
    """``opt.<slot>.v_row/v_col/v.<key>`` of every leaf: the trained
    parts' moments (stacked over a block leaf's layers), zeros for a
    frozen part and for the placeholders."""
    out = {}
    for key, parts in layout.items():
        shape = tuple(params[parts[0][0]].shape)    # hetu_tpu's layout
        shape = (len(parts), *shape) if key.startswith("blocks.") else shape
        factored = _adafactor_factored(optimizer, shape)
        for field, jshape in _moment_shapes(key, shape, factored).items():
            name = f"{prefix}.{field}.{key}"
            if jshape == (1,):
                out[name] = torch.zeros(1, dtype=torch.float32)
                continue
            got = moments.get(field, {})
            part = jshape[1:] if key.startswith("blocks.") else jshape
            full = {n: got[n] if n in got else torch.zeros(
                part, dtype=torch.float32) for n, _ in parts}
            out[name] = _jax_parts({key: parts}, full)[key]
    return out


def copy_optimizer_state(into, src) -> None:
    """Copy ``src``'s state into the optimizer ``into`` over the same
    params, tensor by tensor in place (counts by value), so a captured
    step that reads ``into``'s tensors by address sees the new state."""
    for p, st in into.state.items():
        new = src.state[p]
        if sorted(new) != sorted(st):
            raise ValueError(f"optimizer state keys differ: {sorted(new)} "
                             f"vs {sorted(st)}")
        for k, v in new.items():
            if isinstance(v, torch.Tensor):
                st[k].copy_(v)
            else:
                st[k] = v


class CheckpointWriter:
    """Handle of a save: ``wait()`` joins its write (and raises what the
    write raised). ``snapshot_seconds`` is the time the save blocked its
    caller (the device-to-host copy), ``write_seconds`` the write's
    (known once it ends), ``nbytes`` the bytes written."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.snapshot_seconds: Optional[float] = None
        self.write_seconds: Optional[float] = None
        self.nbytes: Optional[int] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error


def save_checkpoint(path: str, state: TrainState, *,
                    async_save: bool = False,
                    max_shard_bytes: Optional[int] = None,
                    quantize: Optional[str] = None) -> CheckpointWriter:
    """Save ``state`` (params, optimizer state, step) to the directory
    ``path`` in ``hetu_tpu``'s format. The host snapshot is taken before
    this returns; with ``async_save`` the write runs on a thread.
    ``max_shard_bytes`` splits the archive with an index;
    ``quantize="int8"`` stores each float param of two or more axes (in
    ``hetu_tpu``'s layout: every stacked block leaf) as int8 codes and
    per-channel fp32 scales over its last axis (``<key>.q8scale``);
    optimizer state stays fp32."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    t0 = time.perf_counter()
    with telemetry.span("checkpoint_gather", path=path):
        named = dict(state.model.named_parameters())
        names = {p: n for n, p in named.items()}
        layout = jax_param_layout(named)
        transposed = {n: tr for parts in layout.values() for n, tr in parts}
        params = {n: _host(p, transposed[n]) for n, p in named.items()}
        count, moments = _optimizer_state(state.optimizer, names,
                                          transposed)
    slots = state.optimizer.state_layout
    step = int(state.step)
    writer = CheckpointWriter()
    writer.snapshot_seconds = time.perf_counter() - t0

    def tensors() -> dict:
        out, quantized = {}, []
        for key, e in _jax_parts(layout, params).items():
            if quantize and len(e.shape) >= 2 and e.dtype.is_floating_point:
                out[_MODEL_PREFIX + key], out[
                    _MODEL_PREFIX + key + ".q8scale"] = _quantized(e)
                quantized.append(_MODEL_PREFIX + key)
            else:
                out[_MODEL_PREFIX + key] = e
        kind = _kind(slots)
        if kind is not None:
            has_count, fields = _KINDS[kind]
            prefix = f"{_OPT_PREFIX}{slots[kind]}"
            if has_count:
                out[f"{prefix}.count"] = torch.tensor(count,
                                                      dtype=torch.int32)
            for field, tag in fields:
                got = moments.get(field, {})
                full = {n: got[n] if n in got else torch.zeros(
                    params[n].shape, dtype=torch.float32) for n in params}
                for key, e in _jax_parts(layout, full).items():
                    out[f"{prefix}.{tag}.{key}"] = e
            if kind == "adafactor":
                out.update(_adafactor_entries(state.optimizer, layout,
                                              moments, params, prefix))
        if "wd_count" in slots:
            out[_OPT_PREFIX + slots["wd_count"]] = torch.tensor(
                step, dtype=torch.int32)
        out[_OPT_PREFIX + slots["count"]] = torch.tensor(step,
                                                         dtype=torch.int32)
        return out, quantized

    def write():
        t1 = time.perf_counter()
        with telemetry.span("checkpoint_write", background=async_save):
            entries, quantized = tensors()
            entries = {k: _entry(v) for k, v in entries.items()}
            os.makedirs(path, exist_ok=True)
            if max_shard_bytes is None:
                save_tensors(os.path.join(path, _WEIGHTS_FILE), entries)
            else:
                _save_sharded(path, entries, max_shard_bytes)
            with open(os.path.join(path, _META_FILE), "w") as f:
                json.dump({"step": step, "format_version": 1,
                           "framework": "hetu_tpu_torch",
                           "quantized": quantized}, f)
        writer.nbytes = sum(e.nbytes for e in entries.values())
        writer.write_seconds = time.perf_counter() - t1
        if telemetry.enabled():
            telemetry.get_registry().histogram(
                "checkpoint_write_seconds",
                "checkpoint file-write latency").observe(
                    writer.write_seconds,
                    mode="async" if async_save else "sync")

    if not async_save:
        write()
        return writer

    def run():
        try:
            write()
        except BaseException as e:  # raised again by wait()
            writer._error = e

    writer._thread = threading.Thread(target=run, daemon=True)
    writer._thread.start()
    return writer


def _take(tensors: dict, key: str, shape: Sequence[int]) -> torch.Tensor:
    if key not in tensors:
        raise KeyError(f"checkpoint missing tensor {key!r}")
    t = tensors[key]
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                         f"expected {tuple(shape)}")
    return t


def _jax_shape(key: str, parts: list, named: dict) -> tuple:
    p = named[parts[0][0]]
    shape = tuple(p.shape[::-1]) if parts[0][1] else tuple(p.shape)
    return (len(parts), *shape) if key.startswith("blocks.") else shape


def _scatter(t: torch.Tensor, key: str, parts: list, into: dict) -> None:
    """Copy each layer's piece of ``hetu_tpu`` leaf ``t`` into the port
    tensor ``into[name]``, where ``into`` has one (in its dtype; moved to
    its device whole, then transposed there)."""
    for i, (name, tr) in enumerate(parts):
        if name not in into:
            continue
        piece = (t[i] if key.startswith("blocks.") else t).to(
            into[name].device)
        into[name].copy_(piece.t() if tr else piece)


def load_checkpoint(path: str, model: nn.Module, opt) -> TrainState:
    """The train state saved at ``path`` (by either package): the params
    are copied into ``model`` (each in its param's dtype and on its
    device), and a fresh optimizer from the spec ``opt`` gets its state
    for every trainable param: Adam's count, mu and nu, or SGD's trace.
    A param that ``opt`` freezes (``masked``) gets none."""
    from hetu_tpu_torch.engine.state import TrainState
    tensors = load_tensors(path)
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    for key in meta.get("quantized", []):
        tensors[key] = dequantize_int8(tensors[key],
                                       tensors.pop(key + ".q8scale"))
    named = dict(model.named_parameters())
    layout = jax_param_layout(named)
    with torch.no_grad():
        for key, parts in layout.items():
            _scatter(_take(tensors, _MODEL_PREFIX + key,
                           _jax_shape(key, parts, named)),
                     key, parts, named)
    optimizer = opt.build(model)
    slots = optimizer.state_layout
    _take(tensors, _OPT_PREFIX + slots["count"], ())
    if "wd_count" in slots:
        _take(tensors, _OPT_PREFIX + slots["wd_count"], ())
    trained = {n for n, p in named.items() if p.requires_grad}
    kind = _kind(slots)
    if kind is not None:
        has_count, fields = _KINDS[kind]
        prefix = f"{_OPT_PREFIX}{slots[kind]}"
        state = {n: {} for n in trained}
        if has_count:
            count = int(_take(tensors, f"{prefix}.count", ()))
            for n in trained:
                state[n]["count"] = count
        for field, tag in fields:
            bufs = {n: torch.empty(named[n].shape, dtype=torch.float32,
                                   device=named[n].device) for n in trained}
            for key, parts in layout.items():
                t = _take(tensors, f"{prefix}.{tag}.{key}",
                          _jax_shape(key, parts, named))
                _scatter(t, key, parts, bufs)
            for n in trained:
                state[n][field] = bufs[n]
        if kind == "adafactor":
            for key, parts in layout.items():
                shape = _jax_shape(key, parts, named)
                factored = _adafactor_factored(optimizer, shape)
                for field, jshape in _moment_shapes(key, shape,
                                                    factored).items():
                    t = _take(tensors, f"{prefix}.{field}.{key}", jshape)
                    if jshape == (1,):
                        continue
                    part = jshape[1:] if key.startswith("blocks.") \
                        else jshape
                    if factored:
                        bufs = {n: torch.empty(part, dtype=torch.float32,
                                               device=named[n].device)
                                for n, _ in parts if n in trained}
                    else:
                        bufs = {n: torch.empty(named[n].shape,
                                               dtype=torch.float32,
                                               device=named[n].device)
                                for n, _ in parts if n in trained}
                    _scatter(t, key, parts, bufs)
                    for n, b in bufs.items():
                        state[n][field] = b
        for n in trained:
            optimizer.state[named[n]] = state[n]
    return TrainState(int(meta["step"]), model, optimizer)


__all__ = ["CheckpointWriter", "copy_optimizer_state", "load_checkpoint",
           "load_tensors", "save_checkpoint", "save_tensors"]
