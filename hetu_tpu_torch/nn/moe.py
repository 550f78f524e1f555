"""Mixture-of-experts on one device (counterpart of
``hetu_tpu/nn/moe.py``): the gate zoo, ``MoEMLP``'s capacity-free
forward with its load-balance auxiliary loss, and its decode lane.

- Gates route in fp32 on fp32 weights (``x @ W``, W stored ``(d, E)`` as
  ``hetu_tpu`` stores it): top-k softmax (``TopKGate``), k top-1 routers
  over disjoint expert groups (``KTop1Gate``), group-then-top-k
  (``SAMGate``) and Sinkhorn-balanced top-1 (``BalanceGate``). The aux
  loss reads each token's first choice only, over every token (pad rows
  included), as ``hetu_tpu`` does.
- Expert params stay stacked on a leading expert axis: ``wi``/``wg``
  ``(E, d, H)``, ``wo`` ``(E, H, d)`` (``models.convert`` un-stacks the
  layer axis only).
- ``MoEMLP.forward`` is ``hetu_tpu``'s single-device branch
  (``_dense_forward``): every expert runs every token in the compute
  dtype, and the combine over one-hot times gate weight runs in fp32.
  It returns ``(out, aux)``.
- ``MoEMLP.decode`` computes only the k chosen experts of each row
  through gathered weight slices (``wi[idx]`` is ``(T, k, d, H)``), with
  static shapes and no host sync, so it runs inside the serving engine's
  captured lanes. A batch-coupled gate (``BalanceGate``) cannot decode:
  its routing of one row depends on the rows batched with it.
- Its W8A8 lane (``decode(w8a8=True, wq=MoEMLP.prequantize())``)
  contracts int8 activations with int8 expert weights in int32, exactly
  as ``hetu_tpu``'s gathered int8 einsums do, through one
  ``torch._int_mm`` a projection over every expert at once (PyTorch has
  no batched int8 product on CUDA): each expert's int8 weights are read
  once, and each row keeps the columns of its chosen experts.

The expert-plane telemetry (``hetu_tpu/nn/moe.py:281-345``) reaches the
host without a callback: JAX gates it at trace time, the port at capture
time. A train or eval step that runs its body with telemetry on opens an
:class:`ExpertPlane` (:func:`expert_plane`), and each ``MoEMLP.forward``
then writes, on the device, its per-expert load (pre-capacity), its
dropped count (0: the capacity-free form) and its aux loss into the
plane's static ring (``steps × layers``), at the step's ring slot, a
device operand the host stages before each replay. A remat recompute
writes the same values into the same cells. The host drains the ring
where it already reads the device (the trainer's log boundary,
``evaluate``'s read) and makes JAX's observations in JAX's order: one
``moe_aux_loss`` and one ``moe_overflow_fraction`` a layer call and
step, ``moe_expert_tokens`` set at each (a train step emits from its
backward, last layer first, so the gauge ends on layer 0; an eval step
from its forward, so it ends on the last layer).

Expert parallelism (the ep all-to-all, its overlap and the hierarchical
exchange) is not ported.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
import warnings
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hetu_tpu_torch.core.dtypes import current_policy
from hetu_tpu_torch.ops.activations import gelu, swiglu
from hetu_tpu_torch.ops.quantization import int8_mm, quantize_int8


def _balance_aux(first_idx, probs, n: int):
    """``n · Σ_e f_e · P_e``: f from the first choices, P the mean
    probability (over the last axis of ``probs``, means over tokens)."""
    first = F.one_hot(first_idx.long(), n).to(torch.float32)
    return n * torch.sum(first.mean(0) * probs.mean(0))


class TopKGate(nn.Module):
    """Softmax router with top-k selection and the Switch/GShard aux loss
    (``hetu_tpu/nn/moe.py:55``); the weights renormalize when k > 1."""

    batch_coupled = False

    def __init__(self, features: int, num_experts: int, k: int = 2, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.num_experts = num_experts
        self.k = k
        self.weight = nn.Parameter(torch.empty(features, num_experts,
                                               device=device, dtype=dtype))

    def forward(self, x):
        """x (T, d) → (idx (T, k) int32, weights (T, k) fp32, aux)."""
        probs = torch.softmax(x.float() @ self.weight.float(), dim=-1)
        top_w, top_idx = torch.topk(probs, self.k, dim=-1)
        if self.k > 1:
            top_w = top_w / top_w.sum(-1, keepdim=True)
        aux = _balance_aux(top_idx[:, 0], probs, self.num_experts)
        return top_idx.to(torch.int32), top_w, aux


class KTop1Gate(nn.Module):
    """k independent top-1 routers over disjoint groups of E/k experts
    (``:88``): one expert a group, weighted by its raw group softmax
    probability; aux is the sum of the groups' balance losses."""

    batch_coupled = False

    def __init__(self, features: int, num_experts: int, k: int = 2, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        if num_experts % k != 0:
            raise ValueError(f"num_experts {num_experts} must divide by "
                             f"k {k} prototype groups")
        self.num_experts = num_experts
        self.k = k
        self.weight = nn.Parameter(torch.empty(features, num_experts,
                                               device=device, dtype=dtype))

    def forward(self, x):
        T, Eg = x.shape[0], self.num_experts // self.k
        logits = x.float() @ self.weight.float()
        probs = torch.softmax(logits.view(T, self.k, Eg), dim=-1)
        local = probs.argmax(-1)                             # (T, k)
        w = torch.gather(probs, -1, local[..., None])[..., 0]
        offs = torch.arange(self.k, device=x.device) * Eg
        idx = (local + offs[None, :]).to(torch.int32)
        aux = _balance_aux(local, probs, Eg)
        return idx, w, aux


class SAMGate(nn.Module):
    """Locality-aware gate (``:129``): the expert group with the most gate
    mass wins, then the top-k experts inside it (raw probabilities). Aux:
    the balance loss plus ``alignment_coef`` times the mean mass outside
    the chosen group."""

    batch_coupled = False

    def __init__(self, features: int, num_experts: int, k: int = 2, *,
                 num_groups: int = 2, alignment_coef: float = 1.0,
                 device=None, dtype=torch.float32):
        super().__init__()
        if num_experts % num_groups != 0:
            raise ValueError(f"num_experts {num_experts} must divide by "
                             f"num_groups {num_groups}")
        if k > num_experts // num_groups:
            raise ValueError("k cannot exceed experts per group")
        self.num_experts = num_experts
        self.k = k
        self.num_groups = num_groups
        self.alignment_coef = alignment_coef
        self.weight = nn.Parameter(torch.empty(features, num_experts,
                                               device=device, dtype=dtype))

    def forward(self, x):
        T = x.shape[0]
        G, Eg = self.num_groups, self.num_experts // self.num_groups
        probs = torch.softmax(x.float() @ self.weight.float(), dim=-1)
        pg = probs.view(T, G, Eg)
        group_mass = pg.sum(-1)                              # (T, G)
        g_star = group_mass.argmax(-1)                       # (T,)
        in_group = torch.gather(
            pg, 1, g_star[:, None, None].expand(T, 1, Eg))[:, 0]
        w, local = torch.topk(in_group, self.k, dim=-1)
        idx = (local + g_star[:, None] * Eg).to(torch.int32)
        aux = _balance_aux(idx[:, 0], probs, self.num_experts)
        out_of_group = 1.0 - torch.gather(group_mass, 1,
                                          g_star[:, None])[:, 0]
        return idx, w, aux + self.alignment_coef * out_of_group.mean()


class BalanceGate(nn.Module):
    """Balanced assignment by Sinkhorn (``:182``): ``n_iters`` row/column
    renormalizations of ``x @ centroids^T / temperature`` towards T/E
    tokens an expert, then each token's argmax; weight ``sigmoid`` of the
    chosen affinity, k = 1, aux 0."""

    #: the column marginal couples every row of the batch, so a row's
    #: routing depends on its batch-mates (decode refuses this gate)
    batch_coupled = True

    def __init__(self, features: int, num_experts: int, *,
                 n_iters: int = 24, temperature: float = 0.02,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.num_experts = num_experts
        self.k = 1
        self.n_iters = n_iters
        self.temperature = temperature
        self.centroids = nn.Parameter(torch.empty(
            num_experts, features, device=device, dtype=dtype))

    def forward(self, x):
        T = x.shape[0]
        scores = x.float() @ self.centroids.float().t()
        logp = scores / self.temperature
        log_col = math.log(T / self.num_experts)
        for _ in range(self.n_iters):
            logp = torch.log_softmax(logp, dim=1)
            logp = logp - torch.logsumexp(logp, dim=0, keepdim=True) \
                + log_col
        idx = logp.argmax(-1)[:, None]
        w = torch.sigmoid(torch.gather(scores, -1, idx))
        return (idx.to(torch.int32), w,
                torch.zeros((), dtype=torch.float32, device=x.device))


GATE_TYPES = {"topk": TopKGate, "ktop1": KTop1Gate, "sam": SAMGate,
              "balance": BalanceGate}


def make_gate(gate_type: str, features: int, num_experts: int,
              k: int = 2, **kw) -> nn.Module:
    """Gate factory for config-driven construction (``:239``); the
    balance gate is top-1 whatever ``k`` asks, with a warning."""
    if gate_type not in GATE_TYPES:
        raise ValueError(f"unknown gate {gate_type!r}; "
                         f"have {sorted(GATE_TYPES)}")
    if gate_type == "balance":
        if k != 1:
            warnings.warn(
                f"balance gate is top-1 by construction (BASE layers); "
                f"requested k={k} is downgraded to 1 (capacity and "
                f"per-token compute follow)", stacklevel=2)
        return BalanceGate(features, num_experts, **kw)
    return GATE_TYPES[gate_type](features, num_experts, k=k, **kw)


class HashGate:
    """Hash routing (``:372``): expert = token id mod E, weight 1, aux 0.
    It routes token ids, not hidden states, and holds no params."""

    def __init__(self, num_experts: int):
        self.num_experts = num_experts
        self.k = 1

    def __call__(self, token_ids):
        idx = (token_ids.reshape(-1, 1) % self.num_experts).to(torch.int32)
        return (idx, torch.ones(idx.shape, dtype=torch.float32,
                                device=idx.device),
                torch.zeros((), dtype=torch.float32, device=idx.device))


def gate_drop_stats(idx, num_experts: int, k: int,
                    capacity_factor: float) -> dict:
    """Capacity statistics of a gate decision (``:259``): the share of
    (token, choice) slots past an expert's capacity ``ceil(factor · T ·
    k / E)`` in token order, the per-expert load and its max over mean."""
    T, E = idx.shape[0], num_experts
    C = max(1, math.ceil(capacity_factor * T * k / E))
    idx_f = idx.reshape(T * k).long()
    oh = F.one_hot(idx_f, E)
    pos = (torch.cumsum(oh, 0) - oh)[torch.arange(T * k,
                                                  device=idx.device), idx_f]
    load = oh.sum(0)
    return {"drop_frac": (pos >= C).to(torch.float32).mean(),
            "expert_load": load,
            "load_imbalance": load.max() / load.float().mean().clamp(min=1),
            "capacity": C}


def _ordered_gaps(scores, k: int):
    """Per-row least gap between consecutive sorted scores down to the
    (k+1)-th (or the last): a top-k set and its order flip only under
    it."""
    s = torch.sort(scores, dim=-1, descending=True).values
    n = min(k + 1, s.shape[-1])
    return (s[..., :n - 1] - s[..., 1:n]).min(-1).values


@torch.no_grad()
def routing_margins(gate, x):
    """Each row's decision margin under ``gate`` on ``x`` (T, d): the
    least score gap any of its discrete choices rests on (the top-k
    probabilities and their order; each group's top-1; SAM's group, then
    its top-k; the balance gate's final Sinkhorn log-plan). Rounding
    noise of the size of the margin can flip a row's routing, so a
    comparison of two implementations compares routing first and counts
    the rows with small margins."""
    T = x.shape[0]
    if isinstance(gate, BalanceGate):
        scores = x.float() @ gate.centroids.float().t()
        logp = scores / gate.temperature
        for _ in range(gate.n_iters):
            logp = torch.log_softmax(logp, dim=1)
            logp = logp - torch.logsumexp(logp, dim=0, keepdim=True) \
                + math.log(T / gate.num_experts)
        return _ordered_gaps(logp, 1)
    probs = torch.softmax(x.float() @ gate.weight.float(), dim=-1)
    if isinstance(gate, KTop1Gate):
        return _ordered_gaps(probs.view(T, gate.k, -1), 1).min(-1).values
    if isinstance(gate, SAMGate):
        pg = probs.view(T, gate.num_groups, -1)
        mass = pg.sum(-1)
        in_group = pg[torch.arange(T, device=x.device), mass.argmax(-1)]
        return torch.minimum(_ordered_gaps(mass, 1),
                             _ordered_gaps(in_group, gate.k))
    return _ordered_gaps(probs, gate.k)


def refuse_batch_coupled(model) -> None:
    """Raise if ``model`` routes through a batch-coupled gate: a serving
    step packs rows of unrelated requests, so its tokens would depend on
    which requests share it and could never match one-shot generation."""
    for mod in model.modules():
        if isinstance(mod, MoEMLP) and mod.gate.batch_coupled:
            raise NotImplementedError(
                f"MoE decoding needs a per-token gate; "
                f"{type(mod.gate).__name__} routes over the whole "
                f"co-batched row set, so decoded tokens would depend on "
                f"which rows share a step")


# -- the expert plane -----------------------------------------------------------

_PLANE = threading.local()
_STAGED = itertools.count(1)         # process-wide order of staged steps


class ExpertPlane:
    """The expert-plane ring of one step entry: ``aux`` and ``dropped``
    ``(steps, layers)`` and ``load`` ``(steps, layers, E)``, fp32 on the
    device, with the ring slot ``slot`` (int64, ``(1,)``) the host stages
    before each step (:meth:`stage`). ``backward`` orders a step's
    observations as a differentiated step emits them (last layer
    first). Layers take their columns in the order they first write."""

    def __init__(self, layers: int, num_experts: int, *, steps: int,
                 device, backward: bool):
        kw = dict(dtype=torch.float32, device=device)
        self.steps, self.backward = max(1, int(steps)), backward
        self.aux = torch.zeros(self.steps, layers, **kw)
        self.dropped = torch.zeros(self.steps, layers, **kw)
        self.load = torch.zeros(self.steps, layers, num_experts, **kw)
        self.slot = torch.zeros(1, dtype=torch.int64, device=device)
        self.columns: dict = {}
        self.armed = False           # the next step writes the ring
        #: a weak reference (``weakref.WeakMethod``) to what drains a full
        #: ring: a trainer drains all its planes, oldest first (None, or
        #: the owner gone: the plane drains itself)
        self.on_full: Optional[Callable] = None
        self._staged = 0             # steps staged since the last drain
        self._next = 0
        #: process-wide order of this plane's last staged step (planes of
        #: one trainer drain oldest first, so the gauge ends on the last)
        self.last_staged = 0

    def stage(self) -> None:
        """Point the next step at its ring slot (a device fill: no
        sync). A step staged on a full ring (``steps`` staged since the
        last drain) drains it first: a device read, the one sync the
        plane adds, only where the drains come rarer than the ring
        holds."""
        if self.armed:
            if self._staged >= self.steps:
                owner = self.on_full() if self.on_full is not None \
                    else None
                (owner or self.drain)()
            self.slot.fill_(self._next)
            self._next = (self._next + 1) % self.steps
            self._staged += 1
            self.last_staged = next(_STAGED)

    def record(self, layer, idx, aux) -> None:
        """One layer call's stats, written on the device (inside the
        captured body: no host read)."""
        col = self.columns.setdefault(id(layer), len(self.columns))
        load = F.one_hot(idx.reshape(-1).long(),
                         self.load.shape[-1]).sum(0).to(torch.float32)
        self.load.select(1, col).index_copy_(0, self.slot, load[None])
        self.aux.select(1, col).index_copy_(
            0, self.slot, aux.detach().to(torch.float32).reshape(1))
        self.dropped.select(1, col).index_fill_(0, self.slot, 0.0)

    def drain(self) -> int:
        """Read the steps staged since the last drain (one device-to-host
        copy: call it where the host already syncs) and make JAX's
        observations; returns the steps observed."""
        n = self._staged
        if n == 0:
            return 0
        from hetu_tpu_torch import telemetry
        aux, dropped, load = (t.cpu() for t in (self.aux, self.dropped,
                                                 self.load))
        self._staged = 0
        if not telemetry.enabled():
            return 0
        cols = range(len(self.columns))
        order = list(reversed(cols)) if self.backward else list(cols)
        for k in range(n):
            slot = (self._next - n + k) % self.steps
            for col in order:
                _emit_expert_plane(load[slot, col], dropped[slot, col],
                                   aux[slot, col])
        return n


def _emit_expert_plane(load, dropped, aux) -> None:
    """The host side of one layer call's stats (``hetu_tpu/nn/moe.py:281
    _emit_expert_plane``: the same series, labels and help)."""
    from hetu_tpu_torch import telemetry
    reg = telemetry.get_registry()
    gauge = reg.gauge(
        "moe_expert_tokens",
        "tokens routed to each expert on the last observed MoE layer "
        "call (pre-capacity, global batch)")
    for e, n in enumerate(load.tolist()):
        gauge.set(float(n), expert=str(e))
    d = float(dropped)
    if d:
        reg.counter(
            "moe_dropped_tokens_total",
            "(token, choice) slots dropped by the EP capacity limit "
            "— contributions that silently vanish from the combine").inc(d)
    total = float(load.sum())
    reg.histogram(
        "moe_overflow_fraction",
        "fraction of (token, choice) slots dropped by the capacity "
        "limit, per MoE layer call").observe(d / max(total, 1.0))
    reg.histogram(
        "moe_aux_loss",
        "MoE load-balance aux loss per layer call").observe(float(aux))


@contextlib.contextmanager
def expert_plane(plane: Optional[ExpertPlane]):
    """Route this thread's ``MoEMLP.forward`` stats into ``plane`` (None:
    nowhere) for the body of one step."""
    prev = getattr(_PLANE, "plane", None)
    _PLANE.plane = plane
    try:
        yield plane
    finally:
        _PLANE.plane = prev


def make_expert_plane(model, *, steps: int, backward: bool
                      ) -> Optional[ExpertPlane]:
    """An :class:`ExpertPlane` for ``model``'s MoE layers, or None for a
    dense model."""
    layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
    if not layers:
        return None
    return ExpertPlane(len(layers), layers[0].num_experts, steps=steps,
                       device=layers[0].wi.device, backward=backward)


class MoEMLP(nn.Module):
    """The FFN of an MoE block (``:388``): a gate and E stacked expert
    FFNs, GELU (``gated=False``) or SwiGLU (``gated=True``). ``forward``
    returns ``(out, aux)``; ``decode`` returns the output alone."""

    def __init__(self, features: int, hidden: int, num_experts: int, *,
                 k: int = 2, capacity_factor: float = 1.25,
                 gated: bool = False, gate_type: str = "topk",
                 gate_kwargs: Optional[dict] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_experts = num_experts
        #: read only by :func:`gate_drop_stats` on one device
        self.capacity_factor = capacity_factor
        self.gated = gated
        self.gate = make_gate(gate_type, features, num_experts, k=k,
                              **(gate_kwargs or {}), **kw)
        self.k = self.gate.k          # the balance gate forces k = 1
        self.wi = nn.Parameter(torch.empty(num_experts, features, hidden,
                                           **kw))
        if gated:
            self.wg = nn.Parameter(torch.empty(num_experts, features,
                                               hidden, **kw))
        self.wo = nn.Parameter(torch.empty(num_experts, hidden, features,
                                           **kw))

    def _activate(self, x, w_in, w_gate):
        """The expert hidden from ``x @ w_in`` (and ``x @ w_gate``), with
        ``matmul`` broadcasting ``x`` against each weight's batch dims."""
        h = torch.matmul(x, w_in)
        if self.gated:
            return swiglu(torch.matmul(x, w_gate), h)
        return gelu(h)

    def forward(self, x):
        """x (b, s, d) → (out (b, s, d) in x's dtype, aux fp32)."""
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        idx, wgt, aux = self.gate(xf)
        dt = current_policy().compute_dtype
        xc = xf.to(dt)
        h = self._activate(xc, self.wi.to(dt),
                           self.wg.to(dt) if self.gated else None)
        ye = torch.matmul(h, self.wo.to(dt))                 # (E, T, d)
        combine = torch.zeros(xf.shape[0], self.num_experts,
                              dtype=torch.float32, device=x.device)
        for j in range(self.k):
            combine = combine + wgt[:, j, None] * F.one_hot(
                idx[:, j].long(), self.num_experts).to(torch.float32)
        out = torch.einsum("te,etd->td", combine, ye.float())
        plane = getattr(_PLANE, "plane", None)
        if plane is not None:
            plane.record(self, idx, aux)
        return out.reshape(b, s, d).to(x.dtype), aux

    def _names(self) -> tuple:
        return ("wi", "wo") + (("wg",) if self.gated else ())

    @torch.no_grad()
    def prequantize(self, into: Optional[dict] = None) -> dict:
        """Quantize the expert stacks into the W8A8 lane's ``{name: {"q":
        int8, "scale": fp32}}`` tree (``hetu_tpu/nn/moe.py:514``): per
        (expert, output channel) over each product's contraction axis —
        ``wi``/``wg`` ``(E, d, H)`` over d (scale ``(E, 1, H)``), ``wo``
        ``(E, H, d)`` over H (scale ``(E, 1, d)``). ``q`` has the
        weight's shape, and its codes are ``hetu_tpu``'s; it is stored
        with the contraction axis innermost (a transposed view of an
        ``(E, out, in)`` tensor), so the lane's ``(in, E out)`` operand is
        the column-major view that ``torch._int_mm`` runs fastest. ``into``
        (an earlier tree of this layer) re-quantizes the current weights
        in place, into the same tensors."""
        tree = {} if into is None else into
        for name in self._names():
            q, scale = quantize_int8(getattr(self, name), axis=1)
            if into is None:
                tree[name] = {"q": q.transpose(1, 2).contiguous()
                              .transpose(1, 2), "scale": scale}
            else:
                tree[name]["q"].copy_(q)
                tree[name]["scale"].copy_(scale)
        return tree

    def _q_lane(self, xc, idx, wgt, wq):
        """``hetu_tpu``'s ``q_lane`` (``:579-604``): x quantized per token;
        each projection one int32 product over every expert's columns,
        ``(T, d) @ (d, E H)``, of which each row keeps its k experts'; the
        rescale ``acc * x_scale * w_scale`` in that order. The hidden is
        activated in fp32 and quantized per (row, choice) before the
        down-projection, ``(T k, H) @ (H, E d)``."""
        T = xc.shape[0]
        rows = torch.arange(T, device=xc.device)[:, None]       # (T, 1)
        xq, xs = quantize_int8(xc, axis=-1)                     # (T,d),(T,1)

        def experts_mm(a, name):
            """``a (M, in)`` int8 against every expert: (M, E, out)."""
            q = wq[name]["q"]                                    # (E,in,out)
            E, d_in, d_out = q.shape
            acc = int8_mm(a, q.transpose(1, 2).reshape(E * d_out, d_in).t())
            return acc.view(a.shape[0], E, d_out)

        def up(name):
            acc = experts_mm(xq, name)[rows, idx]                # (T,k,H)
            ws = wq[name]["scale"][idx][:, :, 0, :]
            return acc.float() * xs[:, :, None] * ws

        h = up("wi")
        h = swiglu(up("wg"), h) if self.gated else gelu(h)
        hq, hs = quantize_int8(h, axis=-1)                      # (T,k,H)
        k = idx.shape[1]
        acc = experts_mm(hq.reshape(T * k, -1), "wo").view(T, k, -1,
                                                           xc.shape[1])
        acc = acc[rows, torch.arange(k, device=xc.device)[None, :], idx]
        y = acc.float() * hs * wq["wo"]["scale"][idx][:, :, 0, :]
        return torch.sum(wgt[..., None] * y, dim=1)

    def decode(self, x, *, w8a8: bool = False, wq: Optional[dict] = None):
        """Per-row top-k through the chosen experts' gathered weights
        (``:533``, its fp lane): x (b, s, d) → (b, s, d) in x's dtype,
        the k outputs summed in fp32 by gate weight. ``w8a8`` with ``wq``
        (a :meth:`prequantize` tree) takes the W8A8 lane (:meth:`_q_lane`);
        without a tree the fp lane runs, as in ``hetu_tpu``. The gate
        routes in fp on either lane."""
        refuse_batch_coupled(self)
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        idx, wgt, _ = self.gate(xf)
        idx = idx.long()
        dt = current_policy().compute_dtype
        if w8a8 and wq is not None:
            out = self._q_lane(xf.to(dt), idx, wgt, wq)
            return out.reshape(b, s, d).to(x.dtype)
        xc = xf.to(dt)[:, None, None, :]                     # (T, 1, 1, d)
        h = self._activate(xc, self.wi[idx].to(dt),          # (T, k, 1, H)
                           self.wg[idx].to(dt) if self.gated else None)
        y = torch.matmul(h, self.wo[idx].to(dt))[:, :, 0]    # (T, k, d)
        out = torch.sum(wgt[..., None] * y.float(), dim=1)
        return out.reshape(b, s, d).to(x.dtype)


def moe_mlp(cfg, hidden: int, *, gated: bool, **kw) -> MoEMLP:
    """The MoE FFN of a GPT or Llama config's block (SAM's group count
    passed only when set, as ``hetu_tpu`` does)."""
    gkw = {"num_groups": cfg.moe_num_groups} \
        if cfg.moe_gate == "sam" and cfg.moe_num_groups else None
    return MoEMLP(cfg.hidden_size, hidden, cfg.num_experts,
                  k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                  gated=gated, gate_type=cfg.moe_gate, gate_kwargs=gkw,
                  **kw)


def with_aux(blocks, out):
    """``(h, aux)`` from ``StackedBlocks.forward``'s result: an fp32 zero
    aux for dense blocks, which return ``h`` alone."""
    if blocks.returns_aux:
        return out
    return out, torch.zeros((), dtype=torch.float32, device=out.device)


def add_aux(cfg, lm, aux):
    """``lm + moe_aux_coef · aux``; a dense model's loss is ``lm`` itself
    (its aux is 0), so its value and graph stay as they were."""
    return lm + cfg.moe_aux_coef * aux if cfg.num_experts > 0 else lm


__all__ = ["BalanceGate", "ExpertPlane", "GATE_TYPES", "HashGate",
           "KTop1Gate", "MoEMLP", "expert_plane", "make_expert_plane",
           "SAMGate", "TopKGate", "add_aux", "gate_drop_stats", "make_gate",
           "moe_mlp", "refuse_batch_coupled", "routing_margins", "with_aux"]
