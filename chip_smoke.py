#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hetu_tpu_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, serves GPT-2 small through ``ServingEngine`` and trains
it with ``build_train_step``.

Run from the repository root, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- the card's name and power limit (``nvidia-smi``); compute
   capability 9.0 (Hopper) is required.
2. build   -- ``nvcc`` builds every kernel from ``hetu_tpu_torch/csrc``,
   one process per source, all at once.
3. kernel  -- each kernel against its plain version on the card, at the
   serving path's shapes (fp32 and bf16) and at edge shapes (GQA, segment
   pads, offsets that leave rows with no key, dropout 0.1); max abs error
   against its bound (1e-4 fp32: summation order; 2e-2 bf16: output
   rounding), and times: kernel, plain version, one PyTorch library call
   computing the same function (a yardstick the port never calls), and
   the bound (bytes over 3.35 TB/s or flops over the peak rate of the
   inputs' type, whichever is larger). Every timed launch finds the L2
   cold.
4. engine  -- GPT-2 small (fp32, random weights from a seed) served by
   ``ServingEngine(slots=16, max_len=512, prefill_chunk=64,
   block_size=16)``: 48 greedy requests with 4-448-token prompts and
   ``max_tokens=64``, then 16 that share a 128-token system prompt. The
   launch counters are zeroed just before and read just after; each
   kernel must have launched 12 times (once per layer) per engine
   iteration of the lanes that run it. Every request's tokens must equal
   the one-shot ``generate`` oracle (dense cache, plain attention: no
   kernel), except at a step where the oracle's top-2 logit gap is below
   1e-4 (a near-tie, printed).
5. train   -- GPT-2 small at ``bench.py main()``'s TPU configuration:
   seq 1024, fp32 params with bf16 compute, ``Strategy(remat=
   "selective", unroll=True)``, AdamW(1e-4, wd 0.01). First a step
   oracle: one fp32 step's loss and every grad with the kernels on the
   card against the same weights and batch on the CPU (plain path), at
   batch 1. Then the batch ladder 32/16/8 (a CUDA out-of-memory error
   steps down; any other error fails): 3 warm-up and 10 timed steps on
   one repeated batch; the loss must fall, and the counters (zeroed just
   before the timed steps) must read exactly 12 launches per step of
   ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``. One step under
   full remat must read 24/12/12. Step ms, tokens/s, MFU against the
   989 TFLOP/s bf16 dense peak, the batch that ran and peak memory.
6. train_kernels -- the three flash kernels at the batch that ran (12
   heads, seq 1024, d 64, causal), fp32 and bf16, against their plain
   versions, then timed in bf16 as the main path runs them.
7. train_profile -- ``torch.profiler`` over 3 steps: device ms per step
   by class and the device's idle share.
8. fused_ce kernels -- the fused LM-head CE kernels (forward, dH, dW)
   against their plain versions with h and w each fp32 or bf16, at V =
   50257 and a ragged V = 1013, N not a multiple of any token tile,
   labels of -1 and random general (glse, gtgt) cotangents. Bounds: fp32
   h (and output) lse/tgt 1e-4 and dh/dw 1e-4 of max |reference|; bf16 h
   or output 2e-2 and 1e-2 of max |reference|.
9. train_fused -- ``bench.py``'s fused-CE combo (``workloads/
   mfu_sweep.py --one {48,32}:selective:1:auto --param-dtype bf16 --ce
   fused``): ``HETU_LM_LOSS_IMPL=fused`` (set for these phases and
   restored after), bf16 params and compute, the rest as in ``train``.
   First the fp32 step oracle of ``train`` with the fused loss (launches
   exactly 1 per fused kernel and 12 per flash kernel), then the batch
   ladder 48/32/16 with 3 warm-up and 10 timed steps: launches exactly
   10 per fused kernel and 120 per flash kernel; then its profile.
10. fused_ce times -- the three kernels at the combo's training shape (N
   = batch x 1024 tokens, bf16 h and w) against their plain versions,
   then timed; ``library_ms`` is the port's ``chunked_lm_loss`` (cuBLAS
   plus torch ops: no single PyTorch call computes these functions),
   forward only for the forward kernel, forward and backward for dH/dW.
11. summary -- one ``{"kernels": [...]}`` line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Any failure exits nonzero before the ``ok`` line. Without a CUDA device,
or without the ``hetu_tpu_torch`` package beside this file, it exits
nonzero at once.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
PEAK_FLOPS = {torch.float32: 67e12,       # CUDA cores, no tensor cores
              torch.bfloat16: 989e12}     # dense tensor-core bf16
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SEED = 0
L2_FLUSH_BYTES = 256 << 20
C = 64                             # the engine's prefill chunk
#: one packed prefill chunk as the engine builds it: (slot, tokens, chunk
#: start) per request run -- a third chunk of a long prompt, a new prompt,
#: a second chunk -- then 5 pad tokens (segment -1)
PACK = ((3, 20, 128), (7, 9, 0), (0, 30, 64))
TRAIN_SEQ = 1024
LADDER = (32, 16, 8)               # bench.py main()'s batch ladder
FUSED_LADDER = (48, 32, 16)        # bench.py's fused-CE combo (bench.py:159)
DROP_SEED = 1234
FUSED = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


class SmokeFailure(RuntimeError):
    pass


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

class Timer:
    """Device time of one call, averaged over ``iters`` launches, each
    after a write of ``L2_FLUSH_BYTES`` that evicts the 50 MB L2 (the
    engine reads a different layer's arena every call)."""

    def __init__(self, device):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)

    def __call__(self, fn, iters: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    def per_kernel(self, fn, keys, iters: int = 10) -> dict:
        """Mean device ms per call of each kernel whose name contains one
        of ``keys``, from ``torch.profiler`` over ``iters`` calls (for a
        function that launches several kernels)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        ms = {key: 0.0 for key in keys}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for key in keys:
                    if key in e.name:
                        ms[key] += e.time_range.elapsed_us() / 1e3 / iters
        check(all(v > 0 for v in ms.values()),
              f"profiler saw no device time for {keys}: {ms}")
        return ms


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


# -- kernel cases ------------------------------------------------------------

def paged_case(gens, device, dtype, *, R, hq, hkv, d, bs, W, n_blocks,
               offsets, row_slot=None):
    """q (S, R, hq, d) with S = len(offsets), an arena of ``n_blocks``
    pages, and per-row tables: row i reads the table of request
    ``row_slot[i]`` (default: its own), which maps the request's live
    pages to distinct random blocks and pads the rest with the null
    block 0."""
    S = len(offsets)
    row_slot = list(range(S)) if row_slot is None else list(row_slot)
    gen = gens.device
    q = torch.randn(S, R, hq, d, generator=gen, device=device).to(dtype)
    k = torch.randn(n_blocks, bs, hkv, d, generator=gen,
                    device=device).to(dtype)
    v = torch.randn(n_blocks, bs, hkv, d, generator=gen,
                    device=device).to(dtype)
    live: dict[int, int] = {}
    for o, slot in zip(offsets, row_slot):
        live[slot] = max(live.get(slot, 0), min(W, -(-(int(o) + R) // bs)))
    perm = (torch.randperm(n_blocks - 1, generator=gens.host) + 1).tolist()
    check(sum(live.values()) <= n_blocks - 1, "paged case overfills arena")
    table = {}
    for slot, n in live.items():
        table[slot] = perm[:n] + [0] * (W - n)
        perm = perm[n:]
    tables = torch.tensor([table[slot] for slot in row_slot],
                          dtype=torch.int32)
    off = torch.as_tensor(offsets, dtype=torch.int32)
    return q, k, v, tables.to(device), off.to(device)


def paged_work(q, k, tables, off):
    """Bytes and flops the paged call needs on these inputs: every arena
    row some slot attends read once (slots that share pages share the
    read), q read and out/lse written once; 4 flops per (row, key, head,
    column) for q.k and p.v."""
    S, R, hq, d = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    item = q.element_size()
    W = tables.shape[1]
    tables, off = tables.long().cpu(), off.long().cpu()
    pos = torch.arange(W * bs)
    seen = pos[None, :] < (off[:, None] + R)               # (S, W*bs)
    rows = tables[:, pos // bs] * bs + pos % bs
    kv_rows = int(torch.unique(rows[seen]).numel())
    nbytes = (2 * kv_rows * hkv * d * item + 2 * q.numel() * item
              + S * hq * R * 4 + tables.numel() * 4 + S * 4)
    keys = (off[:, None] + 1 + torch.arange(R)[None, :]).clamp(0, W * bs)
    return nbytes, 4.0 * int(keys.sum()) * hq * d


def flash_case(gens, device, dtype, *, b, hq, hkv, s, d, seg):
    gen = gens.device
    q = torch.randn(b, hq, s, d, generator=gen, device=device).to(dtype)
    k = torch.randn(b, hkv, s, d, generator=gen, device=device).to(dtype)
    v = torch.randn(b, hkv, s, d, generator=gen, device=device).to(dtype)
    seg = None if seg is None else torch.as_tensor(
        seg, dtype=torch.int32).reshape(b, s).to(device)
    return q, k, v, seg


def flash_mask(seg, sq, sk, causal, q_offset, kv_offset, device):
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :] + kv_offset
    mask = (qi >= ki) if causal else torch.ones(sq, sk, dtype=torch.bool,
                                                device=device)
    mask = mask[None, None]
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    return mask                                     # (b|1, 1, sq, sk)


def flash_work(q, k, seg, causal, q_offset=0, kv_offset=0):
    b, hq, sq, d = q.shape
    item = q.element_size()
    live = int(flash_mask(seg, sq, k.shape[2], causal, q_offset, kv_offset,
                          q.device).expand(b, 1, sq, k.shape[2]).sum())
    nbytes = (2 * q.numel() * item + 2 * k.numel() * item
              + b * hq * sq * 4 + (0 if seg is None else 2 * seg.numel() * 4))
    return nbytes, 4.0 * live * hq * d


def bwd_work(q, k, seg, causal, q_offset=0, kv_offset=0):
    """``((bytes, flops) of dq, (bytes, flops) of dk/dv)`` on these
    inputs. Both read q, dO, k, v, lse and delta; dq writes dq, dk/dv
    write dk and dv. Per live (q, k) pair and head, dq does three
    products of 2d flops (s, dp, ds k) and dk/dv four (s, dp, p dO, ds
    q)."""
    b, hq, sq, d = q.shape
    item = q.element_size()
    live = int(flash_mask(seg, sq, k.shape[2], causal, q_offset, kv_offset,
                          q.device).expand(b, 1, sq, k.shape[2]).sum())
    stats = 2 * b * hq * sq * 4 + (0 if seg is None else 2 * seg.numel() * 4)
    dq = (3 * q.numel() + 2 * k.numel()) * item + stats
    dkv = (2 * q.numel() + 4 * k.numel()) * item + stats
    return (dq, 6.0 * live * hq * d), (dkv, 8.0 * live * hq * d)


def bwd_inputs(gens, q, causal, scale, qo, ko, rate, seg, ops, k, v):
    """dO from the card's generator, out/lse from the plain forward."""
    do = torch.randn(q.shape, generator=gens.device,
                     device=q.device).to(q.dtype)
    args = dict(causal=causal, scale=scale, q_offset=qo, kv_offset=ko,
                dropout_rate=rate, seed=DROP_SEED if rate else None)
    out, lse = ops.flash_attention_fwd_reference(q, k, v, seg, seg, **args)
    return do, out, lse, args


def check_bwd(name, case, dtype, shape, got, want, errs, dead_rows=0):
    """Hold (dq, dk, dv) against the plain version; dq of rows that see
    no key must be exactly 0."""
    torch.cuda.synchronize()
    tag = str(dtype).split(".")[1]
    for kernel, parts in (("flash_bwd_dq", (0,)), ("flash_bwd_dkv", (1, 2))):
        err = max(max_err(got[i], want[i]) for i in parts)
        ok = err <= TOL[dtype]
        emit(phase="kernel", kernel=kernel, case=case, dtype=tag,
             shape=shape, max_abs_err=err, bound=TOL[dtype], ok=ok)
        check(ok, f"{kernel} {case} {tag}: max abs err {err} > "
                  f"{TOL[dtype]}")
        errs[kernel][dtype] = max(errs[kernel][dtype], err)
    if dead_rows:
        check(bool((got[0][:, :, :dead_rows] == 0).all()),
              f"{name} {case}: dq of rows with no key not 0")


class Generators:
    """A generator on the card for tensors and one on the host for block
    permutations, both seeded from one seed."""

    def __init__(self, device, seed):
        self.device = torch.Generator(device=device).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed)


def phase_kernels(device, timer, ops):
    """The four kernels against their plain versions at the serving
    shapes and the edge shapes; returns the summary entries (without
    ``launches``, which the main paths fill)."""
    gens = Generators(device, SEED)
    results = {}

    # ---- paged attention ----
    rng = np.random.default_rng(SEED)
    decode_off = rng.integers(3, 511, 16).tolist()   # 16 slots mid-decode
    # the packed prefill's history rows: one row per pack token, reading
    # its request's table up to the request's chunk start - 1 (-1: the
    # chunk starts the prompt); pad rows read slot 0's table at -1
    hist_off, hist_slot = [], []
    for slot, n, start in PACK:
        hist_off += [start - 1] * n
        hist_slot += [slot] * n
    hist_off += [-1] * (C - len(hist_off))
    hist_slot += [0] * (C - len(hist_slot))
    main = dict(R=1, hq=12, hkv=12, d=64, bs=16, W=32, n_blocks=513)
    cases = [
        ("decode", dict(main, offsets=decode_off), False),
        ("prefill_history", dict(main, offsets=hist_off,
                                 row_slot=hist_slot), True),
        ("gqa2_R3_empty_rows", dict(R=3, hq=12, hkv=6, d=64, bs=16,
                                    W=8, n_blocks=41,
                                    offsets=[-1, 0, 17, 60, 124]), True),
    ]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timed = None
    for name, kw, want_lse in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, tbl, off = paged_case(gens, device, dtype, **kw)
            out, lse = ops.paged_attention(q, k, v, tbl, off,
                                           return_lse=True)
            ref_o, ref_l = ops.paged_attention_reference(
                q, k, v, tbl, off, return_lse=True)
            torch.cuda.synchronize()
            err = max(max_err(out, ref_o), max_err(lse, ref_l))
            dead = (off < 0)
            if bool(dead.any()):          # rows at position -1: exact
                check(bool((out[dead][:, 0] == 0).all())
                      and bool((lse[dead][:, :, 0] == ops.NEG_INF).all()),
                      f"paged {name}: empty-history rows not 0/-1e30")
            emit(phase="kernel", kernel="paged_attention", case=name,
                 dtype=str(dtype).split(".")[1], shape=list(q.shape),
                 max_abs_err=err, bound=TOL[dtype], ok=err <= TOL[dtype])
            check(err <= TOL[dtype], f"paged {name} {dtype}: max abs err "
                                     f"{err} > {TOL[dtype]}")
            errs[dtype] = max(errs[dtype], err)
            if name in ("decode", "prefill_history") \
                    and dtype == torch.float32:
                t = time_paged(timer, ops, q, k, v, tbl, off, want_lse)
                emit(phase="kernel_time", kernel="paged_attention",
                     case=name, dtype="float32", **t)
                if name == "decode":
                    timed = t
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="hetu_tpu_torch/csrc/paged_attention.cu",
        replaces="hetu_tpu/ops/paged_pallas.py:86",
        max_abs_err=errs[torch.float32],
        max_abs_err_bf16=errs[torch.bfloat16], shape="decode", **timed)

    # ---- flash forward ----
    pack_seg = np.full(C, -1)
    at = 0
    for slot, n, _ in PACK:
        pack_seg[at:at + n] = slot
        at += n
    skip_seg = np.repeat(np.arange(4), 64)
    skip_seg[-10:] = -1
    skip2 = np.stack([skip_seg, skip_seg])
    # (name, shape, causal, q_offset, kv_offset, dropout rate)
    cases = [
        ("packed_prefill", dict(b=1, hq=12, hkv=12, s=C, d=64, seg=pack_seg),
         True, 0, 0, 0.0),
        ("gqa2_pads", dict(b=1, hq=12, hkv=6, s=C, d=64, seg=pack_seg),
         True, 0, 0, 0.0),
        ("causal_block_skip", dict(b=2, hq=4, hkv=2, s=256, d=64, seg=skip2),
         True, 0, 0, 0.0),
        ("offsets_masked_rows", dict(b=1, hq=4, hkv=4, s=48, d=64,
                                     seg=None), True, 0, 5, 0.0),
        ("non_causal_seg", dict(b=1, hq=4, hkv=4, s=C, d=64, seg=pack_seg),
         False, 0, 0, 0.0),
        ("dropout_gqa", dict(b=2, hq=4, hkv=2, s=256, d=64, seg=None),
         True, 0, 0, 0.1),
        ("dropout_offsets_d128", dict(b=1, hq=4, hkv=4, s=96, d=128,
                                      seg=None), True, 3, 8, 0.1),
    ]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, kw, causal, qo, ko, rate in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, seg = flash_case(gens, device, dtype, **kw)
            scale = q.shape[-1] ** -0.5
            args = dict(causal=causal, scale=scale, q_offset=qo,
                        kv_offset=ko, dropout_rate=rate,
                        seed=DROP_SEED if rate else None)
            out, lse = ops.flash_attention_fwd(q, k, v, seg, seg, **args)
            ref_o, ref_l = ops.flash_attention_fwd_reference(
                q, k, v, seg, seg, **args)
            torch.cuda.synchronize()
            err = max(max_err(out, ref_o), max_err(lse, ref_l))
            if ko > qo:                   # rows before the first key
                dead = slice(0, ko - qo)
                check(bool((out[:, :, dead] == 0).all())
                      and bool((lse[:, :, dead] == ops.NEG_INF).all()),
                      f"flash {name}: fully masked rows not 0/-1e30")
            emit(phase="kernel", kernel="flash_fwd", case=name,
                 dtype=str(dtype).split(".")[1], shape=list(q.shape),
                 max_abs_err=err, bound=TOL[dtype], ok=err <= TOL[dtype])
            check(err <= TOL[dtype], f"flash {name} {dtype}: max abs err "
                                     f"{err} > {TOL[dtype]}")
            errs[dtype] = max(errs[dtype], err)
            if name == "packed_prefill" and dtype == torch.float32:
                timed = time_flash(timer, ops, q, k, v, seg, scale)
                emit(phase="kernel_time", kernel="flash_fwd", case=name,
                     dtype="float32", **timed)
    results["flash_fwd"] = dict(
        name="flash_fwd", route="cuda",
        source="hetu_tpu_torch/csrc/flash_fwd.cu",
        replaces="hetu_tpu/ops/flash_pallas.py:184",
        max_abs_err=errs[torch.float32],
        max_abs_err_bf16=errs[torch.bfloat16], shape="packed_prefill",
        **timed)

    # ---- flash backward: dq and dk/dv, on the same cases ----
    errs = {n: {torch.float32: 0.0, torch.bfloat16: 0.0}
            for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    for name, kw, causal, qo, ko, rate in cases[1:]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, seg = flash_case(gens, device, dtype, **kw)
            scale = q.shape[-1] ** -0.5
            do, out, lse, args = bwd_inputs(gens, q, causal, scale, qo, ko,
                                            rate, seg, ops, k, v)
            got = ops.flash_attention_bwd(q, k, v, seg, seg, out, lse, do,
                                          **args)
            want = ops.flash_attention_bwd_reference(q, k, v, seg, seg, out,
                                                     lse, do, **args)
            check_bwd("flash backward", name, dtype, list(q.shape), got,
                      want, errs, dead_rows=max(0, ko - qo))
    for kernel, line in (("flash_bwd_dq", 355), ("flash_bwd_dkv", 418)):
        results[kernel] = dict(
            name=kernel, route="cuda",
            source="hetu_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"hetu_tpu/ops/flash_pallas.py:{line}",
            max_abs_err=errs[kernel][torch.float32],
            max_abs_err_bf16=errs[kernel][torch.bfloat16])
    return results


def time_paged(timer, ops, q, k, v, tbl, off, want_lse):
    import torch.nn.functional as F
    S, R, hq, d = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    W = tbl.shape[1]
    ms = timer(lambda: ops.paged_attention(q, k, v, tbl, off,
                                           return_lse=want_lse))
    plain_ms = timer(lambda: ops.paged_attention_reference(
        q, k, v, tbl, off, return_lse=want_lse))
    kpos = torch.arange(W * bs, device=q.device)
    qpos = off.long()[:, None] + torch.arange(R, device=q.device)[None, :]
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]   # (S,1,R,L)
    g = hq // hkv

    def library():
        kk = ops.gather_block_rows(k, tbl).transpose(1, 2)
        vv = ops.gather_block_rows(v, tbl).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kk, vv, attn_mask=mask,
            enable_gqa=g > 1)

    library_ms = timer(library)
    nbytes, flops = paged_work(q, k, tbl, off)
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops)


def time_flash(timer, ops, q, k, v, seg, scale):
    import torch.nn.functional as F
    ms = timer(lambda: ops.flash_attention_fwd(q, k, v, seg, seg,
                                               causal=True, scale=scale))
    plain_ms = timer(lambda: ops.flash_attention_fwd_reference(
        q, k, v, seg, seg, causal=True, scale=scale))
    mask = flash_mask(seg, q.shape[2], k.shape[2], True, 0, 0, q.device)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale,
        enable_gqa=q.shape[1] != k.shape[1]))
    nbytes, flops = flash_work(q, k, seg, True)
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops)


# -- the engine --------------------------------------------------------------

def workload(vocab: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    burst = [rng.integers(0, vocab, int(n)).tolist()
             for n in rng.integers(4, 449, 48)]
    system = rng.integers(0, vocab, 128).tolist()
    shared = [system + rng.integers(0, vocab, int(n)).tolist()
              for n in rng.integers(4, 65, 16)]
    return burst, shared


def percentile(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p))


def phase_engine(device, card):
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, generate
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.small()
    t0 = time.perf_counter()
    model = GPTLMHeadModel(cfg, device=device, seed=SEED).eval()
    eng = ServingEngine(model, slots=16, max_len=512, prefill_chunk=64,
                        block_size=16, seed=SEED, device=device)
    emit(phase="engine_setup", config="GPTConfig.small", dtype="float32",
         layers=cfg.num_layers, hidden=cfg.hidden_size,
         heads=cfg.num_heads, vocab=cfg.vocab_size, slots=16, max_len=512,
         prefill_chunk=64, block_size=16, kv_blocks=eng.pool.n_blocks,
         arena_bytes=eng.pool.nbytes(),
         seconds=time.perf_counter() - t0)
    burst, shared = workload(cfg.vocab_size)
    sp = SamplingParams(max_tokens=64)

    # warm the allocator and cuBLAS on a throwaway engine, so the timed
    # run measures serving, not first-call set-up
    warm = ServingEngine(model, slots=2, max_len=512, prefill_chunk=64,
                         block_size=16, device=device)
    warm.generate_many([burst[0][:70]], SamplingParams(max_tokens=3))
    del warm
    torch.cuda.synchronize()

    # ---- the main path: counters zeroed just before, read just after --
    reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, sp) for p in burst]
    steps = eng.run_until_drained()
    torch.cuda.synchronize()
    t_burst = time.perf_counter() - t0
    it_burst = dict(eng.lane_iters)
    # the shared-prompt batch: its first request caches the system
    # prompt's blocks, the other 15 then map them from the prefix cache
    t1 = time.perf_counter()
    reqs2 = [eng.submit(shared[0], sp)]
    while reqs2[0].first_token_s is None:
        eng.step()
    reqs2 += [eng.submit(p, sp) for p in shared[1:]]
    eng.run_until_drained()
    torch.cuda.synchronize()
    t_shared = time.perf_counter() - t1
    counts = launch_counts()
    iters = dict(eng.lane_iters)
    # ------------------------------------------------------------------

    L = cfg.num_layers
    want = {"paged_attention": L * (iters["decode"] + iters["prefill"]),
            "flash_fwd": L * iters["prefill"]}
    emit(phase="engine_launches", counts=counts, lane_iters=iters,
         expected=want)
    for name, n in want.items():
        check(counts.get(name, 0) > 0, f"{name} never launched on the "
                                       f"main path")
        check(counts.get(name, 0) == n,
              f"{name}: {counts.get(name, 0)} launches, expected {n} "
              f"({L} layers x lane iterations {iters})")

    bad = [r for r in reqs + reqs2 if r.status != "done"]
    check(not bad, f"{len(bad)} requests did not finish")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    timings = [r.timing() for r in reqs]
    ttft = [t["ttft_ms"] for t in timings]
    tpot = [t["decode_ms"] / (len(r.tokens) - 1)
            for t, r in zip(timings, reqs) if len(r.tokens) > 1]
    hits = sum(r.cached_tokens for r in reqs2)
    perf = dict(phase="engine", card=card,
                burst_requests=len(reqs),
                burst_prompt_tokens=sum(len(p) for p in burst),
                burst_generated_tokens=gen_tokens,
                burst_seconds=t_burst,
                burst_tokens_per_s=gen_tokens / t_burst,
                burst_steps=steps,
                burst_ms_per_step=t_burst / steps * 1e3,
                burst_lane_iterations=it_burst,
                ttft_samples=len(ttft), tpot_samples=len(tpot),
                ttft_ms_p50=percentile(ttft, 50),
                ttft_ms_p99=percentile(ttft, 99),
                tpot_ms_p50=percentile(tpot, 50),
                shared_requests=len(reqs2),
                shared_prefix_hit_tokens=hits,
                shared_seconds=t_shared,
                shared_tokens_per_s=sum(len(r.tokens) for r in reqs2)
                / t_shared,
                peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit(**perf)
    check(hits >= 15 * 128, f"shared-prompt batch hit only {hits} cached "
                            f"tokens")

    # ---- the oracle: one-shot generate, dense cache, plain attention --
    t0 = time.perf_counter()
    near_ties = []
    for r in reqs + reqs2:
        prompt = r.prompt.tolist()
        ids, logits = generate(model, [prompt], max_new_tokens=64,
                               device=device, return_logits=True)
        check(bool(torch.isfinite(logits).all()),
              f"request {r.id}: non-finite oracle logits")
        want_toks = ids[0, len(prompt):].tolist()
        got = list(r.tokens)
        check(len(got) == 64 and all(0 <= t < cfg.vocab_size for t in got),
              f"request {r.id}: bad token list")
        if got == want_toks:
            continue
        t = next(i for i, (a, b) in enumerate(zip(got, want_toks)) if a != b)
        top2 = torch.topk(logits[0, t].float(), 2).values
        gap = float(top2[0] - top2[1])
        near_ties.append(dict(request=r.id, step=t, gap=gap))
        check(gap < 1e-4, f"request {r.id} diverges from generate at step "
                          f"{t} where the oracle's top-2 gap is {gap}")
    emit(phase="engine_oracle", requests=len(reqs) + len(reqs2),
         identical=len(reqs) + len(reqs2) - len(near_ties),
         near_ties=near_ties, seconds=time.perf_counter() - t0)
    phase_profile(eng, burst[:16], sp)
    return counts


def device_kernel_ms(prof) -> tuple[dict, int]:
    """Device ms by kernel name, and the number of kernels, in a
    ``torch.profiler`` trace. ``record_function`` ranges mirrored on the
    device timeline (``Optimizer.step#...``) are skipped: they span
    kernels that are counted on their own."""
    from torch.autograd import DeviceType
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return by_name, n_kernels


KERNEL_CLASSES = (("paged_attention", "paged_attention"),
                  ("flash_fwd", "flash_fwd"),
                  ("gemm", "matmul"), ("xmma", "matmul"),
                  ("cutlass", "matmul"))


def phase_profile(eng, prompts, sp, n_steps: int = 20):
    """Where an engine iteration's time goes: ``torch.profiler`` over
    ``n_steps`` steady iterations with 16 requests in flight (decode and
    packed prefill mixed). Device busy time is the sum of kernel
    durations (one stream: kernels do not overlap); the rest of the
    wall time the card waits on the host. The profiler's own host cost
    inflates the wall time, so ``ms_per_step`` here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [eng.submit(p, sp) for p in prompts]
    for _ in range(4):                       # admissions, first chunks
        eng.step()
    torch.cuda.synchronize()
    before = dict(eng.lane_iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    lanes = {k: eng.lane_iters[k] - before[k] for k in before}
    eng.run_until_drained()
    check(all(r.status == "done" for r in reqs), "profiled requests did "
                                                "not finish")
    by_name, n_kernels = device_kernel_ms(prof)
    busy_ms = sum(by_name.values())
    by_class: dict[str, float] = {}
    for name, ms in by_name.items():
        cls = next((c for key, c in KERNEL_CLASSES if key in name), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms / n_steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit(phase="engine_profile", steps=n_steps, lane_iterations=lanes,
         ms_per_step=wall_ms / n_steps,
         device_kernels_per_step=n_kernels / n_steps,
         device_busy_ms_per_step=busy_ms / n_steps if busy_ms else None,
         device_idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
         device_ms_per_step_by_class=by_class,
         top_kernels_ms_per_step=[[n[:80], ms / n_steps] for n, ms in top])


# -- training ----------------------------------------------------------------

def train_batch(vocab: int, b: int, device, seed: int = SEED) -> dict:
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, TRAIN_SEQ + 1)))
    return {"input_ids": ids[:, :-1].to(device),
            "labels": ids[:, 1:].to(device)}


def launches_of(counts, names=FLASH) -> dict:
    return {k: counts.get(k, 0) for k in names}


@contextlib.contextmanager
def fused_loss():
    """``HETU_LM_LOSS_IMPL=fused`` inside, the caller's value after."""
    prev = os.environ.get("HETU_LM_LOSS_IMPL")
    os.environ["HETU_LM_LOSS_IMPL"] = "fused"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("HETU_LM_LOSS_IMPL", None)
        else:
            os.environ["HETU_LM_LOSS_IMPL"] = prev


def train_oracle(cfg, device, fused: bool = False):
    """One fp32 step, kernels on the card (selective remat) against the
    plain path on the CPU (no remat), same weights and batch; ``fused``:
    under ``HETU_LM_LOSS_IMPL=fused`` (the caller sets it), with one
    launch of each fused CE kernel expected. Bounds:
    |loss difference| <= 1e-4; each grad's max abs difference <= 1e-3 of
    its own max |grad| plus 1e-5 of the largest grad of the model (sums
    run in other orders; a grad that is zero in exact arithmetic, such
    as the key bias's, is summation noise on both sides)."""
    from hetu_tpu_torch.models import GPTLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    gpu = GPTLMHeadModel(cfg, device=device, seed=SEED + 1)
    cpu = GPTLMHeadModel(cfg, device="cpu", seed=SEED + 1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batch = train_batch(cfg.vocab_size, 1, "cpu", seed=SEED + 1)
    reset_launch_counts()
    loss_gpu = gpu.loss(batch["input_ids"].to(device),
                        batch["labels"].to(device), remat="selective")
    loss_gpu.backward()
    torch.cuda.synchronize()
    counts = launches_of(launch_counts(), FLASH + FUSED)
    loss_cpu = cpu.loss(batch["input_ids"], batch["labels"])
    loss_cpu.backward()
    loss_gpu, loss_cpu = float(loss_gpu.detach()), float(loss_cpu.detach())
    want = dict(cpu.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in want.values())
    worst, worst_name = 0.0, None
    for name, p in gpu.named_parameters():
        ref = want[name].grad
        err = float((p.grad.cpu() - ref).abs().max())
        bound = 1e-3 * float(ref.abs().max()) + 1e-5 * gmax
        if err / bound > worst:
            worst, worst_name = err / bound, name
    dloss = abs(loss_gpu - loss_cpu)
    L = cfg.num_layers
    emit(phase="train_fused_oracle" if fused else "train_oracle",
         dtype="float32", batch=1, seq=TRAIN_SEQ,
         loss_gpu=loss_gpu, loss_cpu=loss_cpu,
         loss_abs_diff=dloss, worst_grad_err_over_bound=worst,
         worst_grad=worst_name, largest_grad=gmax, launches=counts,
         seconds=time.perf_counter() - t0)
    check(dloss <= 1e-4, f"train oracle: loss differs by {dloss}")
    check(worst <= 1.0, f"train oracle: grad {worst_name} off by "
                        f"{worst} x its bound")
    want = {**{k: L for k in FLASH}, **{k: int(fused) for k in FUSED}}
    check(counts == want, f"train oracle: launches {counts}, expected "
                          f"{want}")


def train_rung(model, opt, plan, b, device):
    """3 warm-up and 10 timed steps at batch ``b``; the launch counters
    are zeroed just before the timed steps and read just after."""
    from hetu_tpu_torch.engine import build_train_step, init_state
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    model.reset_parameters(SEED)
    state = init_state(model, opt, plan)
    step = build_train_step(model, opt, plan)
    batch = train_batch(model.cfg.vocab_size, b, device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        state, m = step(state, batch)
    float(m["loss"])
    warm_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(10):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 10
    counts = launch_counts()
    losses = [float(m["loss"]) for m in metrics]
    return dict(state=state, step=step, batch=batch, dt=dt, warm_s=warm_s,
                counts=counts, losses=losses,
                grad_norm=float(metrics[-1]["grad_norm"]),
                peak=torch.cuda.max_memory_allocated())


def phase_train(device, card):
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.core import BF16_COMPUTE, autocast
    from hetu_tpu_torch.engine import build_train_step, make_plan
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.parallel import Strategy

    cfg = GPTConfig.small()
    train_oracle(cfg, device)
    gc.collect()
    torch.cuda.empty_cache()

    model = GPTLMHeadModel(cfg, device=device, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    opt = optim.adamw(1e-4, weight_decay=0.01)
    with autocast(BF16_COMPUTE):          # the plan keeps the policy
        plan = make_plan(model, opt, Strategy(remat="selective",
                                              unroll=True), device=device)
        plan_full = make_plan(model, opt, Strategy(remat="full"),
                              device=device)
    run = None
    for b in LADDER:
        try:
            run = train_rung(model, opt, plan, b, device)
        except torch.cuda.OutOfMemoryError as e:
            emit(phase="train_oom", batch=b, error=str(e)[:200])
        if run is not None:
            break
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
    check(run is not None, f"no batch of {LADDER} fit")
    L = cfg.num_layers
    want = {"flash_fwd": 10 * L, "flash_bwd_dq": 10 * L,
            "flash_bwd_dkv": 10 * L}
    got = launches_of(run["counts"])
    tokens_per_s = b * TRAIN_SEQ / run["dt"]
    # bench.py:133: 6N matmul flops per token + 6 L H s for attention
    flops_per_token = 6.0 * n_params + 6.0 * L * cfg.hidden_size * TRAIN_SEQ
    emit(phase="train", card=card, config="GPTConfig.small",
         params=n_params, seq=TRAIN_SEQ, batch=b, policy="BF16_COMPUTE",
         remat="selective", step_ms=run["dt"] * 1e3,
         tokens_per_s=tokens_per_s,
         mfu=tokens_per_s * flops_per_token / PEAK_FLOPS[torch.bfloat16],
         flops_per_token=flops_per_token,
         peak_memory_bytes=run["peak"], warmup_seconds=run["warm_s"],
         losses=run["losses"], grad_norm_last=run["grad_norm"],
         launches=got, expected=want)
    check(all(np.isfinite(run["losses"])), "non-finite training loss")
    check(run["losses"][-1] < run["losses"][0],
          f"loss did not fall: {run['losses']}")
    check(got == want, f"train launches {got}, expected {want} "
                       f"(12 per kernel per step, 10 steps)")

    # full remat re-runs the flash forward in the backward: 24 per step
    step_full = build_train_step(model, opt, plan_full)
    reset_launch_counts()
    run["state"], _ = step_full(run["state"], run["batch"])
    torch.cuda.synchronize()
    full = launches_of(launch_counts())
    emit(phase="train_full_remat", launches=full)
    check(full == {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                   "flash_bwd_dkv": L},
          f"full remat launches {full}, expected {2 * L}/{L}/{L}")
    run.update(batch_size=b, model=model, counts=got)
    return run


TRAIN_CLASSES = (("flash_fwd", "flash_fwd"),
                 ("flash_bwd_dq", "flash_bwd_dq"),
                 ("flash_bwd_dkv", "flash_bwd_dkv"),
                 ("fused_ce_fwd", "fused_ce_fwd"),
                 ("fused_ce_dh", "fused_ce_dh"),
                 ("fused_ce_dw", "fused_ce_dw"),
                 ("gemm", "matmul"), ("xmma", "matmul"),
                 ("cutlass", "matmul"), ("nvjet", "matmul"),
                 ("sm90_", "matmul"))


def phase_train_profile(run, n_steps: int = 3, phase: str = "train_profile"):
    """Where a training step's time goes: ``torch.profiler`` over
    ``n_steps`` steps at the batch that ran. Device busy is the sum of
    kernel times (one stream); the rest of the wall time the card waits
    on the host. The profiler's host cost inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile

    state, step, batch = run["state"], run["step"], run["batch"]
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, n_kernels = device_kernel_ms(prof)
    busy_ms = sum(by_name.values())
    check(busy_ms > 0, "the profiler saw no device time")
    by_class: dict[str, float] = {}
    for name, ms in by_name.items():
        cls = next((c for key, c in TRAIN_CLASSES if key in name), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms / n_steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit(phase=phase, steps=n_steps, batch=run["batch_size"],
         ms_per_step=wall_ms / n_steps,
         device_kernels_per_step=n_kernels / n_steps,
         device_busy_ms_per_step=busy_ms / n_steps,
         device_idle_share=1.0 - busy_ms / wall_ms,
         device_ms_per_step_by_class=by_class,
         top_kernels_ms_per_step=[[n[:80], ms / n_steps] for n, ms in top])


def phase_train_kernels(device, timer, ops, b, results):
    """The three flash kernels at the training shape (b, 12 heads, seq
    1024, d 64, causal): fp32 and bf16 against their plain versions, then
    timed in bf16, as the main path runs them."""
    import torch.nn.functional as F
    gens = Generators(device, SEED + 2)
    shape = dict(b=b, hq=12, hkv=12, s=TRAIN_SEQ, d=64, seg=None)
    scale = 64 ** -0.5
    errs = {n: {torch.float32: 0.0, torch.bfloat16: 0.0}
            for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = flash_case(gens, device, dtype, **shape)
        do, out, lse, args = bwd_inputs(gens, q, True, scale, 0, 0, 0.0,
                                        None, ops, k, v)
        got_o, got_l = ops.flash_attention_fwd(q, k, v, None, None,
                                               causal=True, scale=scale)
        torch.cuda.synchronize()
        err = max(max_err(got_o, out), max_err(got_l, lse))
        tag = str(dtype).split(".")[1]
        emit(phase="kernel", kernel="flash_fwd", case="train", dtype=tag,
             shape=list(q.shape), max_abs_err=err, bound=TOL[dtype],
             ok=err <= TOL[dtype])
        check(err <= TOL[dtype], f"flash_fwd train {tag}: {err}")
        del got_o, got_l
        got = ops.flash_attention_bwd(q, k, v, None, None, out, lse, do,
                                      **args)
        want = ops.flash_attention_bwd_reference(q, k, v, None, None, out,
                                                 lse, do, **args)
        check_bwd("flash backward", "train", dtype, list(q.shape), got, want,
                  errs)
        del got, want
        gc.collect()
        torch.cuda.empty_cache()
    for kernel in errs:
        for dtype, key in ((torch.float32, "max_abs_err"),
                           (torch.bfloat16, "max_abs_err_bf16")):
            results[kernel][key] = max(results[kernel][key],
                                       errs[kernel][dtype])

    # times, bf16 (q/k/v/dO/out left from the loop)
    fwd = lambda: ops.flash_attention_fwd(q, k, v, None, None,  # noqa: E731
                                          causal=True, scale=scale)
    bwd = lambda: ops.flash_attention_bwd(  # noqa: E731
        q, k, v, None, None, out, lse, do, **args)
    kern = timer.per_kernel(fwd, ["flash_fwd_kernel"])
    kern.update(timer.per_kernel(bwd, ["flash_bwd_dq_kernel",
                                       "flash_bwd_dkv_kernel"]))
    plain_fwd = timer(lambda: ops.flash_attention_fwd_reference(
        q, k, v, None, None, causal=True, scale=scale), iters=5)
    plain_bwd = timer(lambda: ops.flash_attention_bwd_reference(
        q, k, v, None, None, out, lse, do, **args), iters=5)
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             scale=scale)
    lib_bwd = timer(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do, retain_graph=True))
    del lib_out
    nbytes, flops = flash_work(q, k, None, True)
    (dq_b, dq_f), (dkv_b, dkv_f) = bwd_work(q, k, None, True)
    for kernel, key, plain, lib, nb, fl in (
            ("flash_fwd", "flash_fwd_kernel", plain_fwd, lib_fwd, nbytes,
             flops),
            ("flash_bwd_dq", "flash_bwd_dq_kernel", plain_bwd, lib_bwd, dq_b,
             dq_f),
            ("flash_bwd_dkv", "flash_bwd_dkv_kernel", plain_bwd, lib_bwd,
             dkv_b, dkv_f)):
        bound_ms, bound_by = bound(nb, fl, q.dtype)
        t = dict(ms=kern[key], plain_ms=plain, library_ms=lib,
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nb, flops=fl)
        emit(phase="kernel_time", kernel=kernel, case="train",
             dtype="bfloat16", shape=list(q.shape), **t)
        if kernel == "flash_fwd":
            results[kernel].update({f"train_{k}": v for k, v in t.items()})
        else:
            results[kernel].update(t, shape="train_bf16")
    emit(phase="kernel_note", note="plain_ms and library_ms of flash_bwd_dq "
         "and flash_bwd_dkv both time one whole backward (dq, dk and dv "
         "together); library = SDPA(is_causal) backward via "
         "torch.autograd.grad")


# -- the fused LM-head CE ------------------------------------------------------

#: lse/tgt, absolute, in every dtype pairing (fp32 logits and softmax in
#: both; only the summation order differs)
FUSED_TOL_LSE = 1e-4


def ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s values at |x| (0 where x is 0)."""
    _, e = torch.frexp(x.float().abs())
    bits = 8 if dtype == torch.bfloat16 else 24
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(e, dtype=
                                                               torch.float32),
                                                e - bits))


def fused_grad_bound(want: torch.Tensor, h_dtype) -> torch.Tensor:
    """Per element of dh or dw: 2 ulps of the output's dtype at |reference|
    (the fp32 sums round apart) plus a floor of c * max |reference|, c =
    1e-4 for fp32 h (summation order only) and 2e-4 for bf16 h (a dlogits
    entry near a bf16 rounding boundary may round the other way)."""
    c = 2e-4 if h_dtype == torch.bfloat16 else 1e-4
    return 2 * ulp(want, want.dtype) + c * float(want.float().abs().max())


def fused_inputs(gen, device, n, vocab, h_dtype, w_dtype, e=768):
    """h ~ N(0, 1), w ~ N(0, 0.05^2) (GPT-2's init scale), labels with
    every 7th -1, and random general cotangents (glse, gtgt)."""
    h = torch.randn(n, e, generator=gen, device=device).to(h_dtype)
    w = (torch.randn(vocab, e, generator=gen, device=device) * 0.05
         ).to(w_dtype)
    lab = torch.randint(0, vocab, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    lab[::7] = -1
    glse = torch.randn(n, generator=gen, device=device)
    gtgt = torch.randn(n, generator=gen, device=device)
    return h, w, lab, glse, gtgt


def check_fused(case, h, w, got, want, errs) -> None:
    """Hold (lse, tgt, dh, dw) against the plain versions' (lse/tgt within
    ``FUSED_TOL_LSE``, dh/dw element by element within
    :func:`fused_grad_bound`) and record the kernels' absolute errors."""
    torch.cuda.synchronize()
    tags = [str(t.dtype).split(".")[1] for t in (h, w)]
    for kernel, parts in (("fused_ce_fwd", (0, 1)), ("fused_ce_dh", (2,)),
                          ("fused_ce_dw", (3,))):
        out_dtype = got[parts[0]].dtype
        err = max(max_err(got[i], want[i]) for i in parts)
        if kernel == "fused_ce_fwd":
            worst = err / FUSED_TOL_LSE
            extra = dict(bound=FUSED_TOL_LSE)
        else:
            g, r = got[parts[0]], want[parts[0]]
            bnd = fused_grad_bound(r, h.dtype)
            worst = float(((g.float() - r.float()).abs() / bnd).max())
            extra = dict(bound="2 ulp(out) + %g max|ref|" % (
                2e-4 if h.dtype == torch.bfloat16 else 1e-4),
                max_abs_ref=float(r.float().abs().max()))
        ok = worst <= 1.0
        emit(phase="kernel", kernel=kernel, case=case, h_dtype=tags[0],
             w_dtype=tags[1], shape=[h.shape[0], w.shape[0], h.shape[1]],
             max_abs_err=err, worst_err_over_bound=worst, ok=ok, **extra)
        check(ok, f"{kernel} {case} h {tags[0]} w {tags[1]}: max abs err "
                  f"{err}, {worst} of its bound")
        key = "max_abs_err" if h.dtype == out_dtype == torch.float32 \
            else "max_abs_err_bf16"
        errs[kernel][key] = max(errs[kernel][key], err)


def check_w_cast(ops, case, h, w32, lab, glse, gtgt) -> None:
    """Each w tile is cast to h's dtype inside the kernels
    (``fused_ce_pallas.py:64, :121, :144``): with bf16 h, an fp32 w gives
    bit for bit what ``w.to(bfloat16)`` gives (dw, which comes back in
    w's dtype, once rounded to bf16)."""
    w16 = w32.to(torch.bfloat16)
    a, b = ops.fused_ce_fwd(h, w32, lab), ops.fused_ce_fwd(h, w16, lab)
    lse = a[0]
    pairs = (("lse", a[0], b[0]), ("tgt", a[1], b[1]),
             ("dh", ops.fused_ce_dh(h, w32, lab, lse, glse, gtgt),
              ops.fused_ce_dh(h, w16, lab, lse, glse, gtgt)),
             ("dw", ops.fused_ce_dw(h, w32, lab, lse, glse, gtgt).to(
                 torch.bfloat16),
              ops.fused_ce_dw(h, w16, lab, lse, glse, gtgt)))
    same = {name: bool(torch.equal(x, y)) for name, x, y in pairs}
    emit(phase="kernel_w_cast", case=case, h_dtype="bfloat16",
         shape=[h.shape[0], w32.shape[0], h.shape[1]], identical=same,
         ok=all(same.values()))
    check(all(same.values()), f"fused_ce {case}: bf16 h with fp32 w is not "
                              f"bit-identical to w cast to bf16: {same}")


def run_fused(ops, h, w, lab, glse, gtgt):
    """(lse, tgt, dh, dw) from the kernels and from the plain versions;
    the backward of both takes the plain forward's lse."""
    want_l, want_t = ops.fused_lse_tgt_reference(h, w, lab)
    got = (*ops.fused_ce_fwd(h, w, lab),
           ops.fused_ce_dh(h, w, lab, want_l, glse, gtgt),
           ops.fused_ce_dw(h, w, lab, want_l, glse, gtgt))
    want = (want_l, want_t,
            ops.fused_ce_dh_reference(h, w, lab, want_l, glse, gtgt),
            ops.fused_ce_dw_reference(h, w, lab, want_l, glse, gtgt))
    return got, want


def phase_fused_kernels(device, ops):
    """Kernels #5-#7 against their plain versions: one draw of h and w,
    each taken in fp32 and in bf16; the GPT-2 vocab and a ragged one;
    token counts that are not a multiple of any token tile; then the w
    cast of the bf16-h lane (:func:`check_w_cast`). Returns the summary
    entries (without times and launches)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    errs = {k: {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0} for k in FUSED}
    for case, n, vocab in (("vocab_50257", 333, 50257),
                           ("ragged_vocab_1013", 1000, 1013)):
        h32, w32, lab, glse, gtgt = fused_inputs(
            gen, device, n, vocab, torch.float32, torch.float32)
        for h_dtype in (torch.float32, torch.bfloat16):
            h = h32.to(h_dtype)
            for w_dtype in (torch.float32, torch.bfloat16):
                w = w32.to(w_dtype)
                got, want = run_fused(ops, h, w, lab, glse, gtgt)
                check_fused(case, h, w, got, want, errs)
                check(bool((got[1][lab == -1] == 0).all()),
                      f"fused_ce_fwd {case}: tgt of label -1 not 0")
        check_w_cast(ops, case, h, w32, lab, glse, gtgt)
    results = {}
    for kernel, line in zip(FUSED, (53, 112, 134)):
        results[kernel] = dict(
            name=kernel, route="cuda",
            source="hetu_tpu_torch/csrc/fused_ce.cu",
            replaces=f"hetu_tpu/ops/fused_ce_pallas.py:{line}",
            **errs[kernel])
    return results


def phase_train_fused(device, card):
    """The fused-CE combo: the fused fp32 oracle, then the bf16-param
    ladder 48/32/16, then its profile; ``HETU_LM_LOSS_IMPL=fused``
    throughout."""
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.core import Policy, autocast
    from hetu_tpu_torch.engine import make_plan
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.parallel import Strategy

    cfg = GPTConfig.small()
    policy = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    with fused_loss():
        train_oracle(cfg, device, fused=True)
        gc.collect()
        torch.cuda.empty_cache()
        model = GPTLMHeadModel(cfg, device=device, seed=SEED)
        n_params = sum(p.numel() for p in model.parameters())
        opt = optim.adamw(1e-4, weight_decay=0.01)
        with autocast(policy):
            plan = make_plan(model, opt, Strategy(remat="selective",
                                                  unroll=True), device=device)
        run = None
        for b in FUSED_LADDER:
            try:
                run = train_rung(model, opt, plan, b, device)
            except torch.cuda.OutOfMemoryError as e:
                emit(phase="train_fused_oom", batch=b, error=str(e)[:200])
            if run is not None:
                break
            gc.collect()
            torch.cuda.empty_cache()
        check(run is not None, f"no batch of {FUSED_LADDER} fit")
        dtypes = sorted({str(p.dtype) for p in model.parameters()})
        moments = sorted({str(v.dtype)
                          for st in run["state"].optimizer.state.values()
                          for k, v in st.items() if k in ("mu", "nu")})
        L = cfg.num_layers
        want = {**{k: 10 * L for k in FLASH}, **{k: 10 for k in FUSED}}
        got = launches_of(run["counts"], FLASH + FUSED)
        tokens_per_s = b * TRAIN_SEQ / run["dt"]
        flops_per_token = 6.0 * n_params \
            + 6.0 * L * cfg.hidden_size * TRAIN_SEQ
        emit(phase="train_fused", card=card, config="GPTConfig.small",
             params=n_params, seq=TRAIN_SEQ, batch=b,
             policy="param bf16, compute bf16", loss="fused",
             remat="selective", param_dtypes=dtypes, adam_state=moments,
             step_ms=run["dt"] * 1e3, tokens_per_s=tokens_per_s,
             mfu=tokens_per_s * flops_per_token / PEAK_FLOPS[torch.bfloat16],
             flops_per_token=flops_per_token,
             peak_memory_bytes=run["peak"], warmup_seconds=run["warm_s"],
             losses=run["losses"], grad_norm_last=run["grad_norm"],
             launches=got, expected=want)
        check(dtypes == ["torch.bfloat16"], f"params are {dtypes}")
        check(moments == ["torch.float32"], f"AdamW moments are {moments}")
        check(all(np.isfinite(run["losses"])), "non-finite training loss")
        check(run["losses"][-1] < run["losses"][0],
              f"loss did not fall: {run['losses']}")
        check(got == want, f"train_fused launches {got}, expected {want} "
                           f"(1 per fused kernel and {L} per flash kernel "
                           f"per step, 10 steps)")
        run.update(batch_size=b, model=model, counts=got)
        phase_train_profile(run, phase="train_fused_profile")
    return run


def phase_fused_kernel_times(device, timer, ops, b, results):
    """Kernels #5-#7 at the combo's training shape (N = b x 1024 tokens,
    V = 50257, E = 768, bf16 h and w): held against their plain versions,
    then timed with the plain versions and the port's chunked loss
    beside them."""
    from hetu_tpu_torch.ops import chunked_lm_loss
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    n, vocab, e = b * TRAIN_SEQ, 50257, 768
    h, w, lab, _, _ = fused_inputs(gen, device, n, vocab, torch.bfloat16,
                                   torch.bfloat16)
    lab[::7] = torch.randint(0, vocab, lab[::7].shape, generator=gen,
                             device=device, dtype=torch.int32)
    g = torch.full((n,), 1.0 / n, device=device)   # the mean loss's (g, -g)
    got, want = run_fused(ops, h, w, lab, g, -g)
    errs = {k: {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0} for k in FUSED}
    check_fused("train", h, w, got, want, errs)
    for k in FUSED:
        results[k]["max_abs_err_bf16"] = max(
            results[k]["max_abs_err_bf16"], errs[k]["max_abs_err_bf16"])
    lse = want[0]
    del got, want
    gc.collect()
    torch.cuda.empty_cache()

    calls = {"fused_ce_fwd": (lambda: ops.fused_ce_fwd(h, w, lab),
                              lambda: ops.fused_lse_tgt_reference(h, w, lab)),
             "fused_ce_dh": (lambda: ops.fused_ce_dh(h, w, lab, lse, g, -g),
                             lambda: ops.fused_ce_dh_reference(
                                 h, w, lab, lse, g, -g)),
             "fused_ce_dw": (lambda: ops.fused_ce_dw(h, w, lab, lse, g, -g),
                             lambda: ops.fused_ce_dw_reference(
                                 h, w, lab, lse, g, -g))}
    hid = h.view(b, TRAIN_SEQ, e)
    y = lab.long().view(b, TRAIN_SEQ)
    lib_fwd = timer(lambda: chunked_lm_loss(hid, w, y, mm_dt=torch.bfloat16),
                    iters=3, warmup=1)
    hg, wg = hid.detach().requires_grad_(), w.detach().requires_grad_()
    lib_both = timer(lambda: chunked_lm_loss(
        hg, wg, y, mm_dt=torch.bfloat16).backward(), iters=3, warmup=1)
    del hg, wg
    item = 2
    base = (n * e + vocab * e) * item + n * 4          # h, w, labels
    work = {"fused_ce_fwd": (base + 2 * n * 4, 2.0 * n * vocab * e),
            "fused_ce_dh": (base + 3 * n * 4 + n * e * item,
                            4.0 * n * vocab * e),
            "fused_ce_dw": (base + 3 * n * 4 + vocab * e * item,
                            4.0 * n * vocab * e)}
    for kernel, (fn, plain) in calls.items():
        ms = timer(fn, iters=5, warmup=1)
        plain_ms = timer(plain, iters=3, warmup=1)
        nbytes, flops = work[kernel]
        bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
        t = dict(ms=ms, plain_ms=plain_ms,
                 library_ms=lib_fwd if kernel == "fused_ce_fwd" else lib_both,
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                 flops=flops)
        emit(phase="kernel_time", kernel=kernel, case="train",
             dtype="bfloat16", shape=[n, vocab, e], **t)
        results[kernel].update(t, shape=f"train_bf16_N{n}")
    emit(phase="kernel_note", note="library_ms of the fused CE kernels is "
         "the port's chunked_lm_loss (cuBLAS bf16 head matmuls plus torch "
         "ops): its forward for fused_ce_fwd, forward and backward for "
         "fused_ce_dh and fused_ce_dw (no single PyTorch call computes "
         "these functions)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "hetu_tpu_torch")):
        print(f"chip_smoke: no hetu_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    emit(phase="device", nvidia_smi=smi,
         name=torch.cuda.get_device_name(0), capability=list(cap),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    check(tuple(cap) == (9, 0), f"compute capability {cap}: the kernels "
                                f"are built for sm_90a (Hopper)")

    t0 = time.perf_counter()
    built = _build.build()
    emit(phase="build", seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": b["seconds"], "cached": b["cached"]}
                  for n, b in built.items()})

    timer = Timer(device)
    kernels = phase_kernels(device, timer, ops)
    paths = {"engine": phase_engine(device, smi)}
    run = phase_train(device, smi)
    paths["train"] = run["counts"]
    phase_train_profile(run)
    batch = run["batch_size"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_kernels(device, timer, ops, batch, kernels)
    kernels.update(phase_fused_kernels(device, ops))
    run = phase_train_fused(device, smi)
    paths["train_fused"] = run["counts"]
    batch = run["batch_size"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    phase_fused_kernel_times(device, timer, ops, batch, kernels)
    del timer
    for name, entry in kernels.items():
        entry["launches_by_path"] = {p: c.get(name, 0)
                                     for p, c in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    line = [{**{k: e[k] for k in order},
             **{k: v for k, v in e.items() if k not in order}}
            for e in kernels.values()]
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
