#!/usr/bin/env python3
"""Probes of the PyTorch/CUDA port (``hetu_tpu_torch``) on one NVIDIA GPU,
beside ``chip_smoke.py``, whose phase functions they run:

    python3 port_probe.py kernels           # build, ptxas, kernel phases
    python3 port_probe.py fused             # fused CE rate against N, V
    python3 port_probe.py steps OLD NEW     # step times of two trees
    python3 port_probe.py serve OLD NEW     # serving bursts of two trees
    python3 port_probe.py int8              # torch._int_mm's rows, layouts

``kernels`` builds every kernel, prints the ``ptxas`` report of the
tensor-core instances and runs ``phase_kernels``, ``phase_train_kernels``
(batch 32), ``phase_llama_kernels``, ``phase_fused_kernels`` and
``phase_fused_kernel_times`` (batch 48, the combo's): each kernel
against its plain version, then timed. A failing phase is printed and
the next one still runs; the exit code is nonzero if any failed. It is
the short first call for a kernel that has not run on a card yet.

``fused`` times the fused CE forward (#5), dH (#6) and dW (#7) kernels,
bf16, E = 768, at the combo's N = 49,152 tokens against V = 50,257,
16,384 and 8,192, and at N = 8,448 (one wave of the dH lane's 2-CTA
clusters): whether a kernel's rate (TFLOP/s, 2NVE and 4NVE flops) moves
as w (streamed by #5 and #6) leaves the 50 MB L2 or the grid shrinks,
and whether dW's, which streams h (75.5 MB at N = 49,152, 13 MB at
8,448) and runs one cluster per 64 vocab rows, moves with them: that
tells a kernel bound inside the SM from one bound by the memory system.

``steps`` compares the training step of two checkouts (directories that
hold ``chip_smoke.py`` and ``hetu_tpu_torch``) on one card, in turns OLD,
NEW, NEW, OLD: each turn is a process of its own (both packages are named
``hetu_tpu_torch``) that times the pretraining step at batch 32 and the
fused-CE combo at batch 48 with that tree's ``train_rung`` (3 warm-up and
10 timed steps) and profiles 3 steps of each with its
``phase_train_profile``. ``steps-of TREE TAG`` is one such turn.

``serve`` compares the serving engines of two checkouts the same way,
OLD, NEW, NEW, OLD, a process each (serving throughput moves with the
host between processes): each turn serves ``chip_smoke.py``'s GPT-2
small workload (``ServingEngine(slots=16, max_len=512,
prefill_chunk=64)``, fp32) and its Llama-7B workload (bf16, int8 arena,
``ServingEngine(slots=16, max_len=2048, prefill_chunk=256)``) with that
tree's ``serve`` after a warm-up engine, and prints throughput, TTFT,
TPOT and the lane iterations of each burst. ``serve-of TREE TAG`` is one
such turn.

``int8`` asks ``torch._int_mm`` (the W8A8 lane's int32 product) which
row counts it takes on this card at Llama-7B's FFN shapes (4,096 ->
11,008 and back) and GPT-2's, against a float64 product, and times it
at 16-80 rows with the weight column-major (an ``(out, in)`` tensor's
``.t()``, as the lane passes it) and row-major, beside bf16
``F.linear``, each call after an L2-evicting write.

Each line of output is one JSON object, as ``chip_smoke.py`` prints them.
Without a CUDA device it exits nonzero at once.
"""

from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
import time
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def kernels() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    cs.emit(phase="device", nvidia_smi=cs.nvidia_smi(),
            torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    built = _build.build()
    cs.emit(phase="build", seconds=time.perf_counter() - t0)
    timer = cs.Timer(device)
    failed = []
    results = {}
    for name, fn, args in (
            ("ptxas", cs.check_ptxas, (built,)),
            ("kernels", cs.phase_kernels, (device, timer, ops)),
            ("train_kernels", cs.phase_train_kernels,
             (device, timer, ops, 32, results)),
            ("llama_kernels", cs.phase_llama_kernels,
             (device, timer, ops, results)),
            ("fused_kernels", cs.phase_fused_kernels, (device, ops)),
            ("fused_kernel_times", cs.phase_fused_kernel_times,
             (device, timer, ops, 48, results))):
        try:
            out = fn(*args)
        except Exception as e:  # a probe reports every phase
            failed.append(name)
            cs.emit(phase="probe_failed", of=name, error=repr(e))
            traceback.print_exc()
            if name == "kernels":    # the later phases extend its results
                break
            continue
        if name in ("kernels", "fused_kernels"):
            results.update(out)
    cs.emit(phase="probe", failed=failed,
            seconds=time.perf_counter() - t0)
    return 1 if failed else 0


def fused() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hetu_tpu_torch import ops

    device = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    timer = cs.Timer(device)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 5)
    for n, vocab in ((49152, 50257), (49152, 16384), (49152, 8192),
                     (8448, 50257)):
        h, w, lab, _, _ = cs.fused_inputs(gen, device, n, vocab,
                                          torch.bfloat16, torch.bfloat16)
        g = torch.full((n,), 1.0 / n, device=device)
        lse, _ = ops.fused_ce_fwd(h, w, lab)
        nve = float(n) * vocab * h.shape[1]
        fwd_ms = timer(lambda: ops.fused_ce_fwd(h, w, lab), iters=5)
        dh_ms = timer(lambda: ops.fused_ce_dh(h, w, lab, lse, g, -g),
                      iters=5)
        dw_ms = timer(lambda: ops.fused_ce_dw(h, w, lab, lse, g, -g),
                      iters=5)
        cs.emit(phase="fused_rate", card=card, n=n, vocab=vocab,
                fwd_ms=fwd_ms, dh_ms=dh_ms, dw_ms=dw_ms,
                fwd_tflops=2 * nve / fwd_ms / 1e9,
                dh_tflops=4 * nve / dh_ms / 1e9,
                dw_tflops=4 * nve / dw_ms / 1e9)
        del h, w, lab, g, lse
        torch.cuda.empty_cache()
    return 0


def steps_of(tree: str, tag: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.core import BF16_COMPUTE, Policy, autocast
    from hetu_tpu_torch.engine import make_plan
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.parallel import Strategy

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    cs.emit(phase="steps_build", tree=tag, seconds=time.perf_counter() - t0)
    cfg = GPTConfig.small()
    bf16 = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    failed = False
    for path, policy, b, fused in (("pretrain", BF16_COMPUTE, 32, False),
                                   ("combo", bf16, 48, True)):
        with cs.fused_loss() if fused else contextlib.nullcontext():
            model = GPTLMHeadModel(cfg, device=device, seed=cs.SEED)
            opt = optim.adamw(1e-4, weight_decay=0.01)
            with autocast(policy):
                plan = make_plan(model, opt, Strategy(remat="selective",
                                                      unroll=True),
                                 device=device)
            run = cs.train_rung(model, opt, plan, b, device)
            cs.emit(phase="steps", tree=tag, path=path, batch=b,
                    card=cs.nvidia_smi(), step_ms=run["dt"] * 1e3,
                    tokens_per_s=b * cs.TRAIN_SEQ / run["dt"],
                    losses=run["losses"], launches=cs.launches_of(
                        run["counts"]))
            run.update(batch_size=b)
            try:
                cs.phase_train_profile(
                    run, phase=f"steps_profile_{tag}_{path}")
            except cs.SmokeFailure as e:
                failed = True
                cs.emit(phase="probe_failed", of=f"{tag} {path} profile",
                        error=str(e))
        del model, opt, plan, run
        gc.collect()
        torch.cuda.empty_cache()
    return 1 if failed else 0


def burst_line(cs, run) -> dict:
    """Throughput, TTFT and TPOT of one ``serve`` run's burst."""
    reqs = run["reqs"]
    timings = [r.timing() for r in reqs]
    ttft = [t["ttft_ms"] for t in timings]
    tpot = [t["decode_ms"] / (len(r.tokens) - 1)
            for t, r in zip(timings, reqs) if len(r.tokens) > 1]
    gen = sum(len(r.tokens) for r in reqs)
    return dict(burst_generated_tokens=gen, burst_seconds=run["t_burst"],
                burst_tokens_per_s=gen / run["t_burst"],
                burst_lane_iterations=run["it_burst"],
                ttft_ms_p50=cs.percentile(ttft, 50),
                ttft_ms_p99=cs.percentile(ttft, 99),
                tpot_ms_p50=cs.percentile(tpot, 50),
                shared_seconds=run["t_shared"])


def serve_of(tree: str, tag: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.models import (
        GPTConfig, GPTLMHeadModel, LlamaConfig, LlamaLMHeadModel,
    )
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    cs.emit(phase="serve_build", tree=tag, seconds=time.perf_counter() - t0)
    card = cs.nvidia_smi()
    sp = SamplingParams(max_tokens=64)
    cfg = GPTConfig.small()
    model = GPTLMHeadModel(cfg, device=device, seed=cs.SEED).eval()
    burst, shared = cs.workload(cfg.vocab_size)
    kw = dict(max_len=512, prefill_chunk=64, block_size=16, device=device)
    ServingEngine(model, slots=2, **kw).generate_many(
        [burst[0][:70]], SamplingParams(max_tokens=3))
    run = cs.serve(ServingEngine(model, slots=16, seed=cs.SEED, **kw),
                   burst, shared, sp)
    cs.emit(phase="serve", tree=tag, path="gpt2", card=card,
            **burst_line(cs, run))
    del model, run
    gc.collect()
    torch.cuda.empty_cache()

    cfg = LlamaConfig.llama_7b()
    model = LlamaLMHeadModel(cfg, device=device, dtype=torch.bfloat16,
                             seed=cs.SEED).eval()
    burst, shared = cs.llama_workload(cfg.vocab_size)
    kw = dict(max_len=cs.LLAMA_MAX_LEN, prefill_chunk=cs.LLAMA_CHUNK,
              block_size=cs.LLAMA_BLOCK, cache_dtype=torch.int8,
              device=device)
    with autocast(BF16_FULL):
        ServingEngine(model, slots=2, **kw).generate_many(
            [burst[0][:300]], SamplingParams(max_tokens=3))
        run = cs.serve(ServingEngine(model, slots=cs.LLAMA_SLOTS,
                                     seed=cs.SEED, **kw), burst, shared, sp)
    cs.emit(phase="serve", tree=tag, path="llama", card=card,
            **burst_line(cs, run))
    return 0


def in_turns(verb: str, old: str, new: str) -> int:
    """``verb``-of OLD, NEW, NEW, OLD, each in a process of its own."""
    rc = 0
    for tree, tag in ((old, "old"), (new, "new"), (new, "new2"),
                      (old, "old2")):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               f"{verb}-of", tree, tag])
        rc = rc or proc.returncode
    return rc


def int8() -> int:
    import torch.nn.functional as F
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    cs.emit(phase="device", nvidia_smi=cs.nvidia_smi(),
            torch=torch.__version__, cuda=torch.version.cuda)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    for k, n in ((4096, 11008), (11008, 4096), (768, 3072), (3072, 768)):
        wt = codes(n, k)
        for m in (1, 8, 16, 17, 24, 80):
            a = codes(m, k)
            want = (a.double() @ wt.double().t()).long()
            try:
                got = torch._int_mm(a, wt.t())
                cs.emit(phase="int8_rows", shape=[m, k, n],
                        exact=bool(torch.equal(got.long(), want)))
            except RuntimeError as err:
                cs.emit(phase="int8_rows", shape=[m, k, n],
                        refused=str(err).splitlines()[0])
    timer = cs.Timer(dev)
    for k, n in ((4096, 11008), (11008, 4096)):
        wt = codes(n, k)
        wrow = wt.t().contiguous()
        wbf = torch.randn(n, k, generator=gen, device=dev,
                          dtype=torch.bfloat16)
        for m in (17, 24, 32, 80):
            x = torch.randn(m, k, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            a = codes(m, k)
            cs.emit(phase="int8_time", shape=[m, k, n],
                    bf16_linear_ms=timer(lambda: F.linear(x, wbf)),
                    int_mm_column_major_ms=timer(
                        lambda: torch._int_mm(a, wt.t())),
                    int_mm_row_major_ms=timer(
                        lambda: torch._int_mm(a, wrow)))
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("port_probe: no CUDA device is available", file=sys.stderr)
        return 2
    if argv[:1] == ["kernels"] and len(argv) == 1:
        return kernels()
    if argv[:1] == ["fused"] and len(argv) == 1:
        return fused()
    if argv[:1] == ["int8"] and len(argv) == 1:
        return int8()
    if argv[:1] in (["steps"], ["serve"]) and len(argv) == 3:
        return in_turns(argv[0], argv[1], argv[2])
    if argv[:1] == ["steps-of"] and len(argv) == 3:
        return steps_of(argv[1], argv[2])
    if argv[:1] == ["serve-of"] and len(argv) == 3:
        return serve_of(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
