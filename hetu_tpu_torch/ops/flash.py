"""Flash attention: the wrappers of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, their plain PyTorch versions, the dropout mask,
and the differentiable op that training runs.

Counterpart of ``hetu_tpu/ops/flash_pallas.py``: ``_flash_fwd`` (:257)
around ``_fwd_kernel`` (:184), ``_flash_bwd`` (:492) around
``_bwd_dq_kernel`` (:355) and ``_bwd_dkv_kernel`` (:418), and the
``custom_vjp`` pair ``_flash_core`` (:625-668), in the same
``(b, h, s, d)`` layouts. On a CUDA tensor a wrapper launches its
hand-written kernel or raises; on a CPU tensor it runs the plain
version. There is no fallback from one to the other.

The forward and backward are bound as ``torch.library`` custom ops
(``hetu_tpu_torch::flash_fwd`` / ``flash_bwd``) with a registered
autograd formula and fakes for tracing, so a selective-checkpoint
policy can name the forward and keep its ``out``/``lse``
(``nn/parallel.py`` ``remat_policy``): the backward then never runs the
forward kernel again. The differentiable
``(b, s, h, d)`` entry over them, ``flash_attention`` (the counterpart of
``flash_attention_pallas`` :671), lives in ``ops/attention.py`` beside
the plain attention.

Dropout on the attention probabilities reproduces ``_dropout_keep``
(:108) bit for bit: keep (q, k) iff ``fmix32(qpos*0x9E3779B1 ^
kpos*0x85EBCA77 ^ salt) >= threshold`` with ``salt = fmix32(seed ^
b*0x27D4EB2F ^ h*0x165667B1)`` (h the q head) over absolute positions,
so the three kernels draw one mask whatever their tiles. The seed
reaches the kernels as a device word (an int32 tensor of one element,
read once per block), so a captured step replays with the seed its host
staged for that step; an int seed is put in such a word first.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hetu_tpu_torch.core.bits import MASK32, fmix32, mul32
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops.attention import NEG_INF
from hetu_tpu_torch.ops.dropout import seed_word

FWD, DQ, DKV = "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"
# the seed word's address, the uint32 threshold, then the reciprocal keep
# probability
_DROP_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
                  ctypes.c_float]
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
    + [ctypes.c_float] + [ctypes.c_int] * 4 + _DROP_ARGTYPES \
    + [ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
    + [ctypes.c_float] + [ctypes.c_int] * 4 + _DROP_ARGTYPES \
    + [ctypes.c_void_p]
_DKV_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
    + [ctypes.c_float] + [ctypes.c_int] * 4 + _DROP_ARGTYPES \
    + [ctypes.c_void_p]


# -- the dropout mask ---------------------------------------------------------

def dropout_threshold(rate: float) -> int:
    """The uint32 cut of ``_dropout_keep``, computed on the host."""
    return min(2 ** 32 - 1, int(rate * 2 ** 32))


def _seed_bits(seed) -> int:
    """The 32 bits of an int seed, a staged seed or a seed word."""
    if not isinstance(seed, int):
        seed = int(seed_word(seed, None).reshape(-1)[0])
    return seed & MASK32


def _keep(seed, b_idx, h_idx, qpos, kpos, rate):
    salt = fmix32(_seed_bits(seed) ^ mul32(b_idx, 0x27D4EB2F)
                  ^ mul32(h_idx, 0x165667B1))
    u = fmix32(mul32(qpos & MASK32, 0x9E3779B1)
               ^ mul32(kpos & MASK32, 0x85EBCA77) ^ salt)
    return u >= dropout_threshold(rate)


def dropout_keep(seed: int, ib: int, ih: int, iq: int, ik: int, *,
                 rate: float, block_q: int, block_k: int, q_offset: int = 0,
                 kv_offset: int = 0, device=None) -> torch.Tensor:
    """(block_q, block_k) keep mask of tile (iq, ik) of batch row ``ib``
    and q head ``ih`` — the twin of ``_dropout_keep``."""
    qpos = iq * block_q + q_offset + torch.arange(block_q, device=device)
    kpos = ik * block_k + kv_offset + torch.arange(block_k, device=device)
    one = torch.ones((), dtype=torch.long, device=device)
    return _keep(seed, one * ib, one * ih, qpos[:, None], kpos[None, :],
                 rate)


def dropout_keep_bh(seed: int, nb: int, nh: int, sq: int, sk: int, *,
                    rate: float, q_offset: int = 0, kv_offset: int = 0,
                    device=None) -> torch.Tensor:
    """(nb, nh, sq, sk) keep mask — the full-array twin of
    ``dropout_keep_bh`` (``flash_pallas.py:132``), with the absolute
    positions of q row 0 and key 0 at ``q_offset``/``kv_offset``."""
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    return _keep(seed, ar(nb)[:, None, None, None],
                 ar(nh)[None, :, None, None],
                 (ar(sq) + q_offset)[None, None, :, None],
                 (ar(sk) + kv_offset)[None, None, None, :], rate)


def _drop_args(dropout_rate: float, seed, device=None) -> list:
    """The kernels' dropout arguments; on ``device`` (a CUDA call) the
    seed as the address of its int32 device word."""
    if dropout_rate <= 0.0:
        return [0, ctypes.c_void_p(None), 0, 1.0]
    if not dropout_rate < 1.0:
        raise ValueError(f"dropout rate must be < 1, got {dropout_rate}")
    if seed is None:
        raise ValueError("a dropout rate needs a seed")
    if device is None:
        return []
    word = seed_word(seed, device)
    if word.dtype != torch.int32 or word.numel() != 1 \
            or word.device != device:
        raise ValueError(f"the dropout seed word must be one int32 element "
                         f"on {device}, got {word.dtype} {tuple(word.shape)}"
                         f" on {word.device}")
    return [1, _build.ptr(word), dropout_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate)]


# -- plain versions -----------------------------------------------------------

def _masked_logits(q, k, q_seg, kv_seg, causal, scale, q_offset, kv_offset):
    """fp32 ``(b, hq, sq, sk)`` logits of the pre-scaled q (rounded to q's
    dtype, as the kernels do), masked to ``NEG_INF``, plus the mask and
    the fp32 operands (k repeated over each GQA group)."""
    b, hq, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qs = (q.float() * scale).to(q.dtype).float()
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    dev = q.device
    qi = torch.arange(sq, device=dev)[:, None] + q_offset
    ki = torch.arange(sk, device=dev)[None, :] + kv_offset
    mask = (qi >= ki) if causal else torch.ones(sq, sk, dtype=torch.bool,
                                                device=dev)
    mask = mask[None, None]
    if q_seg is not None:
        mask = mask & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    s = torch.where(mask, qs @ kf.transpose(-1, -2),
                    torch.full((), NEG_INF, device=dev))
    return s, mask, qs, kf


def _dropped(p, keep, dropout_rate):
    if keep is None:
        return p
    return torch.where(keep, p / (1.0 - dropout_rate), torch.zeros_like(p))


def _keep_bh(q, k, dropout_rate, seed, q_offset, kv_offset):
    if dropout_rate <= 0.0:
        return None
    b, hq, sq, _ = q.shape
    return dropout_keep_bh(seed, b, hq, sq, k.shape[2], rate=dropout_rate,
                           q_offset=q_offset, kv_offset=kv_offset,
                           device=q.device)


def flash_attention_fwd_reference(q, k, v, q_seg, kv_seg, *, causal: bool,
                                  scale: float, q_offset: int = 0,
                                  kv_offset: int = 0,
                                  dropout_rate: float = 0.0,
                                  seed=None):
    """The plain forward on full matrices in fp32: q (b, hq, sq, d), k/v
    (b, hkv, sk, d), seg ids (b, s) or None. Returns out (b, hq, sq, d)
    in q's dtype and lse (b, hq, sq). Dropout masks only what multiplies
    v; the lse stays undropped. With bf16 inputs the probabilities are
    rounded to bf16 before ``p v``, as in the TPU kernel."""
    _drop_args(dropout_rate, seed)
    s, mask, _, _ = _masked_logits(q, k, q_seg, kv_seg, causal, scale,
                                   q_offset, kv_offset)
    lse = torch.logsumexp(s, dim=-1)
    keep = _keep_bh(q, k, dropout_rate, seed, q_offset, kv_offset)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    if v.dtype == torch.float32:
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        return (_dropped(p, keep, dropout_rate) @ vf).to(q.dtype), lse
    # low precision: the TPU kernel's rounding point (flash_pallas.py:235)
    # -- p relative to the row max, dropped, rounded to v's dtype before
    # p v; the sum l stays fp32, undropped and unrounded
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    pv = _dropped(p, keep, dropout_rate).to(v.dtype).float() @ vf
    return (pv / torch.where(l == 0, 1.0, l)).to(q.dtype), lse


def _delta(out, do):
    return (out.float() * do.float()).sum(-1)


def flash_attention_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, *,
                                  causal: bool, scale: float,
                                  q_offset: int = 0, kv_offset: int = 0,
                                  delta: Optional[torch.Tensor] = None,
                                  dropout_rate: float = 0.0,
                                  seed=None):
    """The plain backward on full matrices in fp32, from the saved ``lse``
    and ``delta = rowsum(dO * O)`` (computed here unless given):
    ``p = exp(s - lse)`` zeroed under the mask, ``dp = dO v^T`` (dropped
    and rescaled), ``ds = p (dp - delta)``; dq = ds k * scale, dk = ds^T
    q~, dv = p~^T dO, dk/dv summed over each GQA group; with bf16 inputs
    ds and p~ are rounded to bf16 before those products, as in the TPU
    kernels. Returns dq in q's dtype and dk/dv in k's."""
    _drop_args(dropout_rate, seed)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    s, mask, qs, kf = _masked_logits(q, k, q_seg, kv_seg, causal, scale,
                                     q_offset, kv_offset)
    delta = _delta(out, do) if delta is None else delta.float()
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    keep = _keep_bh(q, k, dropout_rate, seed, q_offset, kv_offset)
    dof = do.float()
    vf = v.float().repeat_interleave(g, dim=1)
    dp = _dropped(dof @ vf.transpose(-1, -2), keep, dropout_rate)
    ds = p * (dp - delta[..., None])
    # the TPU kernels' rounding points (flash_pallas.py:402, :466, :475):
    # ds to k's dtype before dq and to q's before dk, p~ to dO's before dv
    # (no-ops at fp32)
    dq = (ds.to(k.dtype).float() @ kf) * scale
    dk = (ds.to(q.dtype).float().transpose(-1, -2) @ qs
          ).reshape(b, hkv, g, sk, d).sum(2)
    dv = (_dropped(p, keep, dropout_rate).to(do.dtype).float()
          .transpose(-1, -2) @ dof).reshape(b, hkv, g, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- the kernel wrappers ------------------------------------------------------

#: head dims at which bf16 calls of #2, #3 and #4, and fp32 calls of #2,
#: take a tensor-core lane
TC_HEAD_DIMS = (64, 128)


def flash_lane(dtype: torch.dtype, head_dim: int, kernel: str = FWD) -> str:
    """The lane a CUDA call of ``kernel`` -- the flash forward (#2,
    ``FWD``), dQ (#3, ``DQ``) or dK/dV (#4, ``DKV``) -- takes, from dtype
    and head_dim alone, decided before the launch (``hetu_flash_fwd``,
    ``hetu_flash_bwd_dq`` and ``hetu_flash_bwd_dkv`` branch on the same
    rule): ``"tensor_core"`` (bf16 ``mma.sync``, a ``cp.async``
    pipeline) for bf16 at head_dim 64 or 128; for fp32 there, the
    forward's ``"tensor_core_f32"`` (3xTF32 ``mma.sync``: products to
    about fp32's precision, a ``cp.async`` ring); else ``"cuda_core"``
    (fp32 CUDA cores)."""
    if kernel not in (FWD, DQ, DKV):
        raise ValueError(f"no flash kernel {kernel!r}: {FWD}, {DQ} or {DKV}")
    if head_dim in TC_HEAD_DIMS:
        if dtype == torch.bfloat16:
            return "tensor_core"
        if dtype == torch.float32 and kernel == FWD:
            return "tensor_core_f32"
    return "cuda_core"


def _check_inputs(what, kernel, q, k, v, q_seg, kv_seg, extra=()):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"{what}: k/v {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if d % 32 or d > 256:
        raise ValueError(f"head_dim {d}: the kernels take multiples of 32 "
                         f"up to 256")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes fp32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t, shape, dtype in (("q", q, None, None), ("k", k, None, None),
                                  ("v", v, None, None), *extra):
        if t.device != q.device or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape) \
                or (dtype is not None and t.dtype != dtype):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dtype or q.dtype} {shape or ''} tensor on "
                             f"{q.device}")
    if flash_lane(q.dtype, d, kernel) != "cuda_core":
        # the tensor-core lanes copy rows 16 bytes at a time
        rows = [("q", q), ("k", k), ("v", v)]
        rows += [(name, t) for name, t, *_ in extra if name == "do"]
        for name, t in rows:
            if t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} is not 16-byte aligned")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both q_seg and kv_seg, or neither")
    if q_seg is not None:
        for name, t, n in (("q_seg", q_seg, sq), ("kv_seg", kv_seg, sk)):
            if t.shape != (b, n) or t.dtype != torch.int32 \
                    or t.device != q.device or not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be a contiguous "
                                 f"int32 ({b}, {n}) tensor on {q.device}")
    return b, hq, hkv, sq, sk, d


def _seg_ptrs(q_seg, kv_seg):
    null = ctypes.c_void_p(None)
    return (_build.ptr(q_seg) if q_seg is not None else null,
            _build.ptr(kv_seg) if kv_seg is not None else null)


def flash_attention_fwd(q, k, v, q_seg: Optional[torch.Tensor],
                        kv_seg: Optional[torch.Tensor], *, causal: bool,
                        scale: float, q_offset: int = 0, kv_offset: int = 0,
                        dropout_rate: float = 0.0, seed=None):
    """Flash forward: out (b, hq, sq, d) in q's dtype and fp32 lse
    (b, hq, sq). ``q_offset``/``kv_offset`` are static absolute offsets
    of the causal mask and of the dropout positions. ``seed`` is an int,
    a :class:`~hetu_tpu_torch.ops.dropout.StagedSeed` or a one-element
    int32 word on q's device; the kernel reads the word."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(
            q, k, v, q_seg, kv_seg, causal=causal, scale=scale,
            q_offset=q_offset, kv_offset=kv_offset,
            dropout_rate=dropout_rate, seed=seed)
    b, hq, hkv, sq, sk, d = _check_inputs("flash_attention_fwd", FWD, q, k,
                                          v, q_seg, kv_seg)
    drop = _drop_args(dropout_rate, seed, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib, fn = _build.kernel(FWD, "hetu_flash_fwd", _FWD_ARGTYPES)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
             *_seg_ptrs(q_seg, kv_seg), _build.ptr(out), _build.ptr(lse),
             b, hq, hkv, sq, sk, d, float(scale), int(bool(causal)),
             int(q_offset), int(kv_offset), int(q.dtype == torch.bfloat16),
             *drop, _build.stream_ptr(q.device))
    _build.check(lib, err, "flash_attention_fwd launch")
    _build.count_launch(FWD)
    return out, lse


def flash_attention_bwd(q, k, v, q_seg: Optional[torch.Tensor],
                        kv_seg: Optional[torch.Tensor], out, lse, do, *,
                        causal: bool, scale: float, q_offset: int = 0,
                        kv_offset: int = 0,
                        delta: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0, seed=None):
    """Flash backward: (dq, dk, dv) in q's/k's dtype from the forward's
    out and lse and the output grad ``do``. ``delta`` (b, hq, sq) fp32
    defaults to ``rowsum(out * do)``; a caller that combines partial
    outputs (the ring hop) passes its own. Two launches, each in the lane
    :func:`flash_lane` names: the dQ kernel (one block per q tile,
    streaming kv tiles) and the dK/dV kernel (one block per kv tile and
    kv head, streaming the q tiles of every q head of its group, so the
    GQA sum needs no atomics)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, q_seg, kv_seg, out, lse, do, causal=causal,
            scale=scale, q_offset=q_offset, kv_offset=kv_offset,
            delta=delta, dropout_rate=dropout_rate, seed=seed)
    if delta is None:
        delta = _delta(out, do)
    stats = tuple(q.shape[:3])
    b, hq, hkv, sq, sk, d = _check_inputs(
        "flash_attention_bwd", DQ, q, k, v, q_seg, kv_seg,
        extra=(("out", out, tuple(q.shape), q.dtype),
               ("do", do, tuple(q.shape), q.dtype),
               ("lse", lse, stats, torch.float32),
               ("delta", delta, stats, torch.float32)))
    drop = _drop_args(dropout_rate, seed, q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    common = (b, hq, hkv, sq, sk, d, float(scale), int(bool(causal)),
              int(q_offset), int(kv_offset), int(q.dtype == torch.bfloat16),
              *drop, _build.stream_ptr(q.device))
    ins = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
           _build.ptr(lse), _build.ptr(delta), *_seg_ptrs(q_seg, kv_seg))
    lib, fn = _build.kernel("flash_bwd", "hetu_flash_bwd_dq", _DQ_ARGTYPES)
    _build.check(lib, fn(*ins, _build.ptr(dq), *common),
                 "flash_attention_bwd dq launch")
    _build.count_launch(DQ)
    lib, fn = _build.kernel("flash_bwd", "hetu_flash_bwd_dkv", _DKV_ARGTYPES)
    _build.check(lib, fn(*ins, _build.ptr(dk), _build.ptr(dv), *common),
                 "flash_attention_bwd dk/dv launch")
    _build.count_launch(DKV)
    return dq, dk, dv


# -- the differentiable op ----------------------------------------------------

@torch.library.custom_op("hetu_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_seg: Optional[torch.Tensor],
                 kv_seg: Optional[torch.Tensor], causal: bool, scale: float,
                 q_offset: int, kv_offset: int, dropout_rate: float,
                 seed: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd` as a dispatcher op: ``seed`` is the
    int32 seed word, read only when ``dropout_rate > 0``."""
    return flash_attention_fwd(q, k, v, q_seg, kv_seg, causal=causal,
                               scale=scale, q_offset=q_offset,
                               kv_offset=kv_offset, dropout_rate=dropout_rate,
                               seed=seed)


@torch.library.custom_op("hetu_tpu_torch::flash_bwd", mutates_args=())
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_seg: Optional[torch.Tensor],
                 kv_seg: Optional[torch.Tensor], out: torch.Tensor,
                 lse: torch.Tensor, do: torch.Tensor, causal: bool,
                 scale: float, q_offset: int, kv_offset: int,
                 dropout_rate: float, seed: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_bwd` as a dispatcher op."""
    return flash_attention_bwd(q, k, v, q_seg, kv_seg, out, lse, do,
                               causal=causal, scale=scale, q_offset=q_offset,
                               kv_offset=kv_offset, dropout_rate=dropout_rate,
                               seed=seed)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, q_seg, kv_seg, causal, scale, q_offset,
                    kv_offset, dropout_rate, seed):
    return torch.empty_like(q), q.new_empty(q.shape[:3],
                                            dtype=torch.float32)


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, q_seg, kv_seg, out, lse, do, causal, scale,
                    q_offset, kv_offset, dropout_rate, seed):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, q_seg, kv_seg, causal, scale, q_off, kv_off, rate, seed = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
    ctx.args = (causal, scale, q_off, kv_off, rate, seed)
    ctx.mark_non_differentiable(lse)


def _backward(ctx, d_out, _d_lse):
    q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd_op(q, k, v, q_seg, kv_seg, out, lse,
                              d_out.contiguous(), *ctx.args)
    return dq, dk, dv, None, None, None, None, None, None, None, None


flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)
