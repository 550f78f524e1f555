"""Fused LM-head cross-entropy: the wrappers of ``csrc/fused_ce.cu``, their
plain PyTorch versions, and the differentiable op the fused loss runs.

Counterpart of ``hetu_tpu/ops/fused_ce_pallas.py``: ``fused_lse_tgt``
(:166, a ``custom_vjp``) around ``_fwd_kernel`` (:53), ``_dh_kernel``
(:112) and ``_dw_kernel`` (:134), and ``fused_lm_ce`` (:275). The (N, V)
logits never reach device memory: the forward streams vocab tiles with an
online logsumexp and returns per-token ``(lse, tgt)``; the backward
recomputes each logits tile and feeds the dlogits tile
``glse * softmax + gtgt * onehot`` into the dH and dW products. On a CUDA
tensor a wrapper launches its hand-written kernel or raises; on a CPU
tensor it runs the plain version. There is no fallback from one to the
other.

Dtypes, as in JAX: h is in the compute dtype; w may be fp32 or bf16 and
is cast to h's dtype tile by tile; the logits, the softmax and the
dlogits tile are fp32, and the dlogits tile is rounded to h's dtype
before both backward products; dh comes back in h's dtype, dw in w's,
both summed in fp32. Token rows are not padded (the kernels mask the
ragged edge), so N is free; E must be a multiple of 64, of any size.

Lanes (:func:`fused_ce_lane`): with bf16 h all three kernels run the
tensor-core lane (``fused_ce_fwd_tc_kernel``; ``fused_ce_dh_tc_kernel``
and ``fused_ce_dw_tc_kernel``, each on a two-CTA cluster); with fp32 h
they run the CUDA-core lane. Past ``MAX_E`` = 768 (Llama's 4,096, say)
each takes its wide form (``"tensor_core_wide"``, ``"cuda_core_wide"``):
the tensor-core forward splits the vocab across a cluster of 1-8 CTAs
that share one 128-token tile and combine their online-softmax states
(:func:`wide_fwd_plan`); the tensor-core dH and dW split E across a
cluster of up to 8 CTAs that compute the logits once and share them
(:func:`wide_plan`); the CUDA-core ones split E into 512-column blocks
on a grid axis, each recomputing the logits over all of E (still one
launch a call). The forward and dH tensor-core kernels
read bf16 w, so an fp32 w is cast to bf16 once before their launch (the
values the TPU kernels' per-tile cast gives); dW, whose resident operand
is w, reads w in its own dtype, rounds an fp32 w to bf16 as it stages
it, and returns dw in w's dtype; on the wide lane, whose products read
bf16 operands only, dW too gets w cast once, and still returns dw in
the caller's w dtype. Every lane counts its launches under the same
names.

The forward and backward are ``torch.library`` custom ops
(``hetu_tpu_torch::fused_ce_fwd`` / ``fused_ce_bwd``) with a registered
autograd formula and fakes for tracing, as the flash kernels are. The
backward takes the general cotangents ``(glse, gtgt)`` of ``(lse,
tgt)``, not only the ``(g, -g)`` of the dense loss, so a vocab-parallel
combine can sit above it.
"""

from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops import _build

FWD, DH, DW = "fused_ce_fwd", "fused_ce_dh", "fused_ce_dw"
#: the widest E of the narrow lanes (``kMaxE`` in ``csrc/fused_ce.cu``);
#: wider E takes the wide lanes
MAX_E = 768
#: vocab columns per step of the plain versions
PLAIN_BLOCK_V = 4096
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]
#: dW's entry also takes dw's dtype (its wide tensor-core lane reads w cast)
_DW_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


# -- plain versions -----------------------------------------------------------

def _logits(h, w_blk):
    """fp32 logits of h against a block of w cast to h's dtype (a product
    of two bf16 values is exact in fp32)."""
    return h.float() @ w_blk.to(h.dtype).float().t()


def _onehot(labels, v0, cols, device):
    return labels.long()[:, None] == (v0 + torch.arange(cols, device=device)
                                      )[None, :]


def fused_lse_tgt_reference(h: torch.Tensor, w: torch.Tensor,
                            labels: torch.Tensor):
    """Per-token fp32 ``(lse, tgt)`` of ``h (N, E) @ w (V, E)^T``, vocab
    block by vocab block; label -1 gives ``tgt = 0``."""
    n, vocab = h.shape[0], w.shape[0]
    lse = torch.full((n,), float("-inf"), device=h.device)
    tgt = torch.zeros(n, device=h.device)
    for v0 in range(0, vocab, PLAIN_BLOCK_V):
        s = _logits(h, w[v0:v0 + PLAIN_BLOCK_V])
        lse = torch.logaddexp(lse, torch.logsumexp(s, dim=1))
        hit = _onehot(labels, v0, s.shape[1], h.device)
        tgt = tgt + torch.where(hit, s, 0.0).sum(1)
    return lse, tgt


def _p_block(h, w_blk, v0, labels, lse, glse, gtgt):
    """The dlogits block ``glse * exp(s - lse) + gtgt * onehot``, fp32,
    rounded to h's dtype (``_p_tile``, ``fused_ce_pallas.py:96``)."""
    s = _logits(h, w_blk)
    hit = _onehot(labels, v0, s.shape[1], h.device)
    p = glse.float()[:, None] * torch.exp(s - lse[:, None]) \
        + torch.where(hit, gtgt.float()[:, None], 0.0)
    return p.to(h.dtype).float()


def fused_ce_dh_reference(h, w, labels, lse, glse, gtgt):
    """dH ``(N, E)`` in h's dtype: the sum over vocab blocks of the
    rounded dlogits block times w (cast to h's dtype), in fp32."""
    dh = torch.zeros(h.shape, device=h.device)
    for v0 in range(0, w.shape[0], PLAIN_BLOCK_V):
        w_blk = w[v0:v0 + PLAIN_BLOCK_V]
        dh += _p_block(h, w_blk, v0, labels, lse, glse, gtgt) \
            @ w_blk.to(h.dtype).float()
    return dh.to(h.dtype)


def fused_ce_dw_reference(h, w, labels, lse, glse, gtgt):
    """dW ``(V, E)`` in w's dtype: per vocab block, the rounded dlogits
    block transposed times h, in fp32."""
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    for v0 in range(0, w.shape[0], PLAIN_BLOCK_V):
        w_blk = w[v0:v0 + PLAIN_BLOCK_V]
        p = _p_block(h, w_blk, v0, labels, lse, glse, gtgt)
        dw[v0:v0 + PLAIN_BLOCK_V] = (p.t() @ h.float()).to(w.dtype)
    return dw


# -- the kernel wrappers ------------------------------------------------------

def fused_ce_lane(h_dtype: torch.dtype, w_dtype: torch.dtype, e: int,
                  what: str = "fused_ce") -> str:
    """The lane a CUDA call of the forward (#5), dH (#6) or dW (#7)
    kernel takes, decided before the launch (``hetu_fused_ce_fwd``,
    ``hetu_fused_ce_dh`` and ``hetu_fused_ce_dw`` branch on the same
    rule): ``"tensor_core"`` for bf16 h, whatever w's dtype (the forward
    and dH get an fp32 w cast to bf16 first, dW rounds it as it stages
    it), and ``"cuda_core"`` for fp32 h; each with ``"_wide"`` appended
    for E past ``MAX_E`` (the E-split kernels; on ``"tensor_core_wide"``
    dW gets w cast too). Raises for what no lane
    takes: a dtype other than fp32 or bf16, or E not a positive multiple
    of 64."""
    for name, dtype in (("h", h_dtype), ("w", w_dtype)):
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{what}: {name} must be fp32 or bf16, got "
                            f"{dtype}")
    if e < 64 or e % 64:
        raise ValueError(f"{what}: E = {e}; the kernels take multiples of "
                         f"64")
    lane = "tensor_core" if h_dtype == torch.bfloat16 else "cuda_core"
    return lane + "_wide" if e > MAX_E else lane


def wide_plan(e: int) -> tuple[int, int, int]:
    """``(C, p, groups)`` of the wide tensor-core dH and dW at width e
    (``wide_plan`` in ``csrc/fused_ce.cu``, which the launch follows): a
    cluster of C CTAs (the least of 2, 4 and 8 that gives each at most 8
    of the e / 64 chunks) shares one s, CTA r summing it over chunks [r p,
    r p + p), p = ceil(chunks / C); past 4,096 columns each CTA outputs 8
    of its p chunks per E-group, and each of the ``groups`` E-groups
    computes the same s (the recompute factor)."""
    chunks = e // 64
    c = 2
    while c < 8 and c * 8 < chunks:
        c *= 2
    p = -(-chunks // c)
    return c, p, -(-p // 8)


def wide_fwd_plan(n: int, vocab: int, slots: dict) -> int:
    """The cluster size C of the wide tensor-core forward (#5 past
    ``MAX_E``) at n tokens and ``vocab`` (``fwd_wide_cluster`` in
    ``csrc/fused_ce.cu``, which the launch follows): C CTAs share one tile
    of 128 tokens, CTA r walking the 128-column vocab tiles r, r + C, ...
    Of C = 1, 2, 4 and 8, the one with the fewest tile-steps,
    ``ceil(C ceil(n / 128) / slots[C])`` waves of ``ceil(vocab tiles /
    C)`` tiles each; a tie goes to the smaller C. ``slots[C]`` is how many
    CTAs in clusters of C the card holds at once (:func:`wide_fwd_info`
    reads it from the card); 0 if no cluster size fits."""
    tiles, vtiles = -(-n // 128), -(-vocab // 128)
    best, best_steps = 0, 0
    for c in (1, 2, 4, 8):
        if slots.get(c, 0) <= 0:
            continue
        steps = -(-c * tiles // slots[c]) * -(-vtiles // c)
        if best == 0 or steps < best_steps:
            best, best_steps = c, steps
    return best


def wide_fwd_info(n: int, vocab: int) -> dict:
    """The wide tensor-core forward's launch at (n, vocab) as the library
    plans it on the current card (``hetu_fused_ce_fwd_wide_info``):
    ``cluster`` (C), ``slots`` (CTAs in clusters of 1, 2, 4 and 8 the card
    holds at once, from ``cudaOccupancyMaxActiveClusters``), ``ctas`` (C
    ceil(n / 128)) and ``sms_busy`` (the CTAs of the first wave). Needs
    the built kernels and a CUDA device."""
    lib, fn = _build.kernel("fused_ce", "hetu_fused_ce_fwd_wide_info",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    info = (ctypes.c_int * 6)()
    _build.check(lib, fn(n, vocab, info), "fused_ce fwd_wide_info")
    slots = {1 << i: info[1 + i] for i in range(4)}
    return dict(cluster=info[0], slots=slots, ctas=info[5],
                sms_busy=min(info[5], slots.get(info[0], 0)))


def wide_info(e: int, which: str) -> dict:
    """The wide tensor-core dH (``which="dh"``) or dW launch at width e as
    the library plans it on the current card (``hetu_fused_ce_wide_info``):
    ``cluster`` (C), ``slice_chunks`` (p), ``groups`` (the recompute
    factor) and ``max_active_clusters``
    (``cudaOccupancyMaxActiveClusters``). Needs the built kernels and a
    CUDA device."""
    lib, fn = _build.kernel("fused_ce", "hetu_fused_ce_wide_info",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    info = (ctypes.c_int * 4)()
    _build.check(lib, fn(e, int(which == "dw"), info), "fused_ce wide_info")
    return dict(cluster=info[0], slice_chunks=info[1], groups=info[2],
                max_active_clusters=info[3])


def _launch_w(h, w, which: str = "fwd"):
    """w as kernel ``which`` (``fwd``, ``dh``, ``dw``) takes it: cast to
    bf16 once where its tensor-core kernel reads bf16 w only (the forward
    and dH on both tensor-core lanes, dW on the wide one, whose wgmma
    operands are bf16); as it is otherwise."""
    lane = fused_ce_lane(h.dtype, w.dtype, h.shape[1])
    if w.dtype == torch.float32 and (
            lane == "tensor_core_wide"
            or (lane == "tensor_core" and which != "dw")):
        return w.to(torch.bfloat16)
    return w


def _check(what, h, w, labels, stats=()):
    """Validate the operands of a launch; returns (n, vocab, E)."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"{what}: h {tuple(h.shape)} and w "
                         f"{tuple(w.shape)} must be (N, E) and (V, E)")
    n, e = h.shape
    fused_ce_lane(h.dtype, w.dtype, e, what)
    if h.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {h.device}")
    for name, t, dtype, shape in (("h", h, None, None), ("w", w, None, None),
                                  ("labels", labels, torch.int32, (n,)),
                                  *((k, s, torch.float32, (n,))
                                    for k, s in stats)):
        # h and w are staged with 16-byte vector loads
        if t.device != h.device or not t.is_contiguous() \
                or (dtype is None and t.data_ptr() % 16) \
                or (dtype is not None and t.dtype != dtype) \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dtype or '16-byte aligned'} {shape or ''} "
                             f"tensor on {h.device}")
    return n, w.shape[0], e


def _flags(h, w):
    return int(h.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16)


def fused_ce_fwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
    """Kernel #5: per-token fp32 ``(lse, tgt)`` of h (N, E) against w
    (V, E); ``labels`` (N,) int32 in [-1, V). The lane is
    :func:`fused_ce_lane`'s."""
    if h.device.type == "cpu":
        return fused_lse_tgt_reference(h, w, labels)
    n, vocab, e = _check("fused_ce_fwd", h, w, labels)
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    tgt = torch.empty(n, dtype=torch.float32, device=h.device)
    if n == 0:
        return lse, tgt
    w = _launch_w(h, w)
    lib, fn = _build.kernel("fused_ce", "hetu_fused_ce_fwd", _FWD_ARGTYPES)
    err = fn(_build.ptr(h), _build.ptr(w), _build.ptr(labels),
             _build.ptr(lse), _build.ptr(tgt), n, vocab, e, *_flags(h, w),
             _build.stream_ptr(h.device))
    _build.check(lib, err, "fused_ce_fwd launch")
    _build.count_launch(FWD)
    return lse, tgt


def _bwd(which, h, w, labels, lse, glse, gtgt):
    n, vocab, e = _check(f"fused_ce_{which}", h, w, labels,
                         (("lse", lse), ("glse", glse), ("gtgt", gtgt)))
    out = torch.empty_like(h if which == "dh" else w)
    if n == 0:
        return out.zero_()
    w = _launch_w(h, w, which)
    # dW writes dw in the caller's w dtype, whatever w it reads
    flags = (*_flags(h, w), int(out.dtype == torch.bfloat16)) \
        if which == "dw" else _flags(h, w)
    lib, fn = _build.kernel("fused_ce", f"hetu_fused_ce_{which}",
                            _DW_ARGTYPES if which == "dw" else _BWD_ARGTYPES)
    err = fn(_build.ptr(h), _build.ptr(w), _build.ptr(labels),
             _build.ptr(lse), _build.ptr(glse), _build.ptr(gtgt),
             _build.ptr(out), n, vocab, e, *flags,
             _build.stream_ptr(h.device))
    _build.check(lib, err, f"fused_ce_{which} launch")
    _build.count_launch(DH if which == "dh" else DW)
    return out


def fused_ce_dh(h, w, labels, lse, glse, gtgt):
    """Kernel #6: dH (N, E) in h's dtype from the forward's lse and the
    cotangents ``glse``/``gtgt`` (N,) fp32 of ``(lse, tgt)``; the lane
    is :func:`fused_ce_lane`'s."""
    if h.device.type == "cpu":
        return fused_ce_dh_reference(h, w, labels, lse, glse, gtgt)
    return _bwd("dh", h, w, labels, lse, glse, gtgt)


def fused_ce_dw(h, w, labels, lse, glse, gtgt):
    """Kernel #7: dW (V, E) in w's dtype, from the same inputs; the lane
    is :func:`fused_ce_lane`'s (w is passed in its own dtype)."""
    if h.device.type == "cpu":
        return fused_ce_dw_reference(h, w, labels, lse, glse, gtgt)
    return _bwd("dw", h, w, labels, lse, glse, gtgt)


# -- the differentiable op ----------------------------------------------------

@torch.library.custom_op("hetu_tpu_torch::fused_ce_fwd", mutates_args=())
def fused_ce_fwd_op(h: torch.Tensor, w: torch.Tensor,
                    labels: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_ce_fwd` as a dispatcher op."""
    return fused_ce_fwd(h, w, labels)


@torch.library.custom_op("hetu_tpu_torch::fused_ce_bwd", mutates_args=())
def fused_ce_bwd_op(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    lse: torch.Tensor, glse: torch.Tensor,
                    gtgt: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_ce_dh` and :func:`fused_ce_dw` as one dispatcher
    op."""
    return (fused_ce_dh(h, w, labels, lse, glse, gtgt),
            fused_ce_dw(h, w, labels, lse, glse, gtgt))


@fused_ce_fwd_op.register_fake
def _fused_ce_fwd_fake(h, w, labels):
    n = h.shape[0]
    return (h.new_empty((n,), dtype=torch.float32),
            h.new_empty((n,), dtype=torch.float32))


@fused_ce_bwd_op.register_fake
def _fused_ce_bwd_fake(h, w, labels, lse, glse, gtgt):
    return torch.empty_like(h), torch.empty_like(w)


def _setup_context(ctx, inputs, output):
    h, w, labels = inputs
    ctx.save_for_backward(h, w, labels, output[0])


def _backward(ctx, glse, gtgt):
    h, w, labels, lse = ctx.saved_tensors
    zero = torch.zeros_like(lse)
    glse = zero if glse is None else glse.float().contiguous()
    gtgt = zero if gtgt is None else gtgt.float().contiguous()
    dh, dw = fused_ce_bwd_op(h, w, labels, lse, glse, gtgt)
    return dh, dw, None


fused_ce_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def fused_lse_tgt(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
    """Per-token ``(lse, target logit)`` of ``h (N, E)`` over this weight
    ``w (V, E)``, differentiable in h and w; ``labels`` (N,) are local
    vocab ids, -1 for a token outside this weight (``tgt = 0``)."""
    return fused_ce_fwd_op(h.contiguous(), w.contiguous(),
                           labels.to(torch.int32).contiguous())


def fused_lm_ce(hidden: torch.Tensor, vocab_weight: torch.Tensor,
                labels: torch.Tensor, *,
                ignore_index: int = -100) -> torch.Tensor:
    """Mean LM cross-entropy of ``hidden (B, S, E) @ vocab_weight^T``
    without the logits (``fused_ce_pallas.py:275``): ignored positions
    are excluded from the mean and give zero cotangents."""
    e = hidden.shape[-1]
    h = hidden.reshape(-1, e)
    labels = labels.reshape(-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse, tgt = fused_lse_tgt(h, vocab_weight, safe)
    loss = torch.where(valid, lse - tgt, 0.0)
    return loss.sum() / valid.sum().clamp(min=1)
