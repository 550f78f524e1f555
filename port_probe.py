#!/usr/bin/env python3
"""Probes of the PyTorch/CUDA port (``hetu_tpu_torch``) on one NVIDIA GPU,
beside ``chip_smoke.py``, whose phase functions they run:

    python3 port_probe.py kernels           # build, ptxas, kernel phases
    python3 port_probe.py fused             # fused CE rate against N, V
    python3 port_probe.py fused OLD NEW     # the same, two trees in turns
    python3 port_probe.py wide-phases       # wide dH / dW cycles by phase
    python3 port_probe.py fwd-variants      # wide forward's costs, by variant
    python3 port_probe.py flash             # #2 at the fp32 packs, by lane
    python3 port_probe.py flash OLD NEW     # the same, two trees in turns
    python3 port_probe.py flash-variants    # #2's fp32 lane, by grid
    python3 port_probe.py steps OLD NEW     # step times of two trees
    python3 port_probe.py serve OLD NEW     # serving bursts of two trees
    python3 port_probe.py int8              # torch._int_mm's rows, layouts
    python3 port_probe.py pools             # a Trainer's shared graph pool
    python3 port_probe.py oracle            # the teacher-forced oracle's cost
    python3 port_probe.py noise             # bf16 engine and oracle vs fp32
    python3 port_probe.py fleet [PHASE ...] # the fleet phases alone
    python3 port_probe.py repl              # decode steps under KV replication

``kernels`` builds every kernel, prints the ``ptxas`` report of the
tensor-core instances and runs ``phase_kernels``, ``phase_train_kernels``
(batch 32), ``phase_llama_kernels``, ``phase_fused_kernels`` and
``phase_fused_kernel_times`` (batch 48, the combo's): each kernel
against its plain version, then timed. A failing phase is printed and
the next one still runs; the exit code is nonzero if any failed. It is
the short first call for a kernel that has not run on a card yet.

``fleet`` builds the kernels, serves ``chip_smoke.py``'s GPT-2 small
burst once on one engine (its tokens/s, TTFT and TPOT, and the oracle
memo of its prompts, as ``phase_engine`` hands them on) and runs the
fleet phases: ``fleet``, ``kill``, ``push``, ``pd``, ``server`` and
``rollout`` (all by default, or those named), about 2 minutes of command
time in all.

``fused`` times the fused CE forward (#5), dH (#6) and dW (#7) kernels,
bf16, E = 768, at the combo's N = 49,152 tokens against V = 50,257,
16,384 and 8,192, and at N = 8,448 (one wave of the dH lane's 2-CTA
clusters): whether a kernel's rate (TFLOP/s, 2NVE and 4NVE flops) moves
as w (streamed by #5 and #6) leaves the 50 MB L2 or the grid shrinks,
and whether dW's, which streams h (75.5 MB at N = 49,152, 13 MB at
8,448) and runs one cluster per 64 vocab rows, moves with them: that
tells a kernel bound inside the SM from one bound by the memory system.
Then the Llama training shape (8,192, 32,000, 4,096), where all three
take their wide tensor-core lanes. Each kernel is timed after
``SETTLE_S`` of idle card, so that no reading depends on the power the
kernel timed before it drew (dH timed right after a forward that runs
the card at full power read 7-8% slower than after the parent's lighter
forward). ``fused OLD NEW`` runs the same in
turns OLD, NEW, NEW, OLD, each tree in a process of its own
(``fused-of TREE TAG`` is one turn), so two trees' kernels are timed on
one card.

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

``wide-phases`` splits a tile of the wide tensor-core dH and dW
(``fused_ce_bwd_wide_tc_body``) into its phases at the Llama shape: it
writes a copy of ``csrc/fused_ce.cu`` with ``clock64()`` counters after
each step of the consumers' tile loop and of the exchange warpgroup's
(one thread of each role in each CTA; summed over CTAs into a device
array), builds it beside the real library under
``build/hetu_tpu_torch/probe/`` and prints, per kernel, its time with
the counters on and the cycles a tile of each phase. The counters cost a little time themselves; the kernel's own
time comes from ``fused``.

``fwd-variants`` builds copies of ``csrc/fused_ce.cu`` in which the
wide tensor-core forward (``fused_ce_fwd_wide_tc_kernel``) is changed in
one way each, and times each beside the kernel as built at the Llama
shape, in turns (each variant twice, the second pass in reverse order):
``no_products`` (the ring, the waits and the softmax without a wgmma:
the floor its copies set), ``no_w`` (h's multicast copies only, the
products on a w buffer never filled), ``one_cta`` (C = 1: one CTA a
token tile, no vocab split, no multicast), ``release_cluster`` (the
consumers' remote arrival with a cluster-scope release) and
``double_p`` (a second accumulator set, chunk q + 1 issued before chunk
q is added into s). Each variant's result against the plain version is
printed (the first two compute nothing meaningful) and its ``ptxas``
registers and spills.

``flash`` times the flash forward (#2) at GPT-2's packed prefill (1, 12,
64, 64) and the Llama pack (1, 32, 256, 128), both with their packs'
segments, causal, in fp32 (the 3xTF32 lane, ``tensor_core_f32``) and
bf16 (the tensor-core lane), each beside SDPA with the same bool mask
(a yardstick the port never calls) and its bounds (bytes; flops at the
fp32 cores' 67 TFLOP/s, at 3xTF32's 165 and at bf16's 989), each timing
after ``FLASH_SETTLE_S`` of idle card and checked against the plain
version first. The CUDA events are covered (a spin kernel after each
flush, so the host's enqueue is not timed), and beside each the device
time a call from a profile (``device_ms``, ``library_device_ms``).
``flash OLD NEW`` runs it in turns OLD, NEW, NEW, OLD, a process each
(``flash-of TREE TAG`` is one turn): the parent's fp32 calls take the
CUDA-core lane.

``flash-variants`` builds copies of ``csrc/flash_fwd.cu`` whose fp32
lane is changed one way each and times each, fp32, at both packs, in
turns (each variant twice, the second pass in reverse order), after
checking it against the plain version: ``cuda_core`` (no 3xTF32 branch:
fp32 takes ``flash_fwd_kernel<float>``, the CUDA-core lane), the grids
``q16_k1``, ``q16_k2``, ``q16_k4``, ``q32_k1``, ``q32_k2`` and
``q64_k1`` (``TfGrid``: 16, 32 or 64 query rows a block, each key tile
split over 1, 2 or 4 warps; tiles of 64 keys at d 64, 32 at d 128),
``d128_keys64`` (the built grid with 64-key tiles at d 128),
``d128_q_regs`` (d 128's q~ fragments held in registers), and
``s_chains1`` / ``s_chains2`` (S's products in one or two accumulator
chains instead of the built ``kTfSChains``). Each
variant's ``ptxas`` registers and spills of the 3xTF32 instances are
printed.

``int8`` asks ``torch._int_mm`` (the W8A8 lane's int32 product) which
row counts it takes on this card at Llama-7B's FFN shapes (4,096 ->
11,008 and back) and GPT-2's, against a float64 product, and times it
at 16-80 rows with the weight column-major (an ``(out, in)`` tensor's
``.t()``, as the lane passes it) and row-major, beside bf16
``F.linear``, each call after an L2-evicting write.

``pools`` builds ``llama_train_buckets``' Trainer (Llama-7B width, 2
layers, buckets 512 / 1,024 / 2,048) twice and captures the three
buckets in ascending, then in descending order: each bucket's graph
bytes in the trainer's one pool, the reserved bytes after training and
what ``Trainer.close()`` gives back.

``oracle`` serves 16 of ``llama_workload``'s burst prompts (64 new
tokens each) on the served Llama (all 32 layers, bf16, int8 arena) and
runs ``chip_smoke.oracle`` over them one request a call
(``ORACLE_ROWS = 1``, the oracle before it batched) and 16 a call:
seconds each, and both readings.

``noise`` serves three traffic sets on the served Llama (all 32
layers, bf16, int8 arena): ``chip_smoke.py``'s ``TTFT_WAVES`` of fresh
short prompts (16-256 tokens, 16 new tokens, one wave then the next),
the burst's 24 shortest prompts alone (16 new tokens) and llama_engine's
traffic (``serve``, 64 new tokens). Each set's recorded first-token
logits and greedy tokens are read against three teacher-forced oracles
over the dense int8 cache: the bf16 one 16 requests a call (the
script's), the bf16 one a request a call, and the same bf16 weights
computed in fp32 (``FP32`` casts them exactly). It prints, per set, the
largest first-token |dlogit| of the engine and of each bf16 oracle
against the fp32 one and against each other, the shortfall of the
engine's tokens under the fp32 oracle, and the requests where the
engine is farther from fp32 than the bf16 oracle is: whether the engine
sits within bf16's own reach of the exact arithmetic.

``repl`` times the steady decode steps of one GPT-2 small replica
serving ``gpt2_fleet_kill``'s 16 decode requests (64 new tokens), as
``chip_smoke.decode_step_ms`` does, with its decode KV replicated to a
``KVReplicaStore`` every 20 ms or not, in turns of four variants: off;
``pinned``, each shipment's host copy in fresh pinned buffers (the copy
the replication stream made before its staging buffers; the allocation
and the copy timed apart); ``staged``, the engine's own (pinned staging
allocated once, pageable copies handed on); ``gather``, the snapshot and
the device gather under the iteration lock, no host copy and no store.
All four, then again with ``REPL_BALLAST`` more objects on the heap.
Each run logs a host timeline (a step's lock wait and span; the
replication thread's lock hold, gather, host copy and store; the
garbage collector's passes) and prints, per variant, the step times and,
over the steps slower than 3x the off runs' median, what they
overlapped.

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

import numpy as np
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


#: ``fused``'s shapes (N, V, E): the combo's N against three vocabs, one
#: wave of the narrow dH lane's clusters, and the Llama training shape
#: (the wide tensor-core lane)
FUSED_SHAPES = ((49152, 50257, 768), (49152, 16384, 768),
                (49152, 8192, 768), (8448, 50257, 768), (8192, 32000, 4096))


#: seconds of idle card before each of ``fused``'s timings
SETTLE_S = 1.0


def fused_of(tree: str, tag: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs
    from hetu_tpu_torch import ops

    device = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    timer = cs.Timer(device)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 5)
    for n, vocab, e in FUSED_SHAPES:
        h, w, lab, _, _ = cs.fused_inputs(gen, device, n, vocab,
                                          torch.bfloat16, torch.bfloat16, e)
        g = torch.full((n,), 1.0 / n, device=device)
        lse, _ = ops.fused_ce_fwd(h, w, lab)
        nve = float(n) * vocab * e
        iters = 5 if e <= 768 else 3

        def settled(fn):
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
            return timer(fn, iters=iters)

        fwd_ms = settled(lambda: ops.fused_ce_fwd(h, w, lab))
        dh_ms = settled(lambda: ops.fused_ce_dh(h, w, lab, lse, g, -g))
        dw_ms = settled(lambda: ops.fused_ce_dw(h, w, lab, lse, g, -g))
        cs.emit(phase="fused_rate", tree=tag, card=card, n=n, vocab=vocab,
                e=e, lane=ops.fused_ce_lane(h.dtype, w.dtype, e),
                fwd_ms=fwd_ms, dh_ms=dh_ms, dw_ms=dw_ms,
                fwd_tflops=2 * nve / fwd_ms / 1e9,
                dh_tflops=4 * nve / dh_ms / 1e9,
                dw_tflops=4 * nve / dw_ms / 1e9)
        del h, w, lab, g, lse
        torch.cuda.empty_cache()
    return 0


#: ``wide-phases``' counters: (a line of the wide body, the counter read
#: after it, and that phase's name). Thread 0 times the consumers' loop,
#: thread ``kWConsumers`` the exchange warpgroup's.
WIDE_PHASES = (
    ("          s_streamed(j + 1);\n      }\n", "s_first_half"),
    ("      mbar_wait(bar_p, j & 1);  // (B) every band of tile j's P\n",
     "wait_p"),
    ("      py(j);\n", "p_times_y"),
    ("        if (resident) s_chunks(j + 1, half, ns);  // while tile j + 2 "
     "lands\n", "s_second_half"),
    ("        push_partials();\n      }\n", "push_partials"),
    ("      cp_async_wait<0>();  // tile j's statistics (and the next's)\n"
     "      named_sync(kWExchangeBar, 128);\n", None),
    ("      mbar_wait(bar_s, j & 1);  // (A) every partial of this band, "
     "tile j\n", "x_wait_partials"),
    ("            pack_bf16(p[0], p[1]);\n      }\n", "x_reduce_loop"),
    ("      fence_proxy_async();  // the rows, for the bulk copies and wgmma"
     "\n      named_sync(kWExchangeBar, 128);\n", "x_reduce_sync"),
    ("                         mapa(bar_p, peer));\n          }\n",
     "x_bulk_issue"),
    ("        mbar_expect(bar_p, (C - 1) * band * kWTile * 2);\n      }\n",
     "x_p_arrival"),
    ("        mbar_wait(empty(j & 1), (j >> 1) & 1);  // tile j's P Y done\n",
     "x_wait_empty"),
    ("        issue_tile(j + 2);\n      }\n", "x_copies"))


def wide_phase_source() -> str:
    """``csrc/fused_ce.cu`` with ``clock64()`` counters in the wide
    tensor-core body (the consumers' loop on thread 0, the exchange
    warpgroup's on its first thread), and an entry point to read and
    reset them."""
    from hetu_tpu_torch.ops import _build
    src = (_build.CSRC / "fused_ce.cu").read_text()
    k = len(WIDE_PHASES)
    anchor = ("  const int slot = band * 32;   // float2s a CTA receives from "
              "each peer\n")
    assert src.count(anchor) == 1, anchor
    # the counters live in shared memory: registers would crowd the
    # exchange warpgroup's 48
    src = src.replace(anchor, anchor + f"""  __shared__ unsigned long long wph[{k}];
  if (tid < {k}) wph[tid] = 0;
  __syncthreads();
  long long wph_last = clock64();
#define WPHASE(i) if (tid == 0 || tid == kWConsumers) {{ \\
    const long long now = clock64(); wph[i] += now - wph_last; \\
    wph_last = now; }}
""")
    # the exchange warpgroup's first counter starts its iteration
    for i, (line, _) in enumerate(WIDE_PHASES):
        assert src.count(line) == 1, line
        src = src.replace(line, line + f"    WPHASE({i})\n")
    # each role's thread adds its own counters (the exchange warpgroup's
    # are named x_...)
    xs = [i for i, (_, name) in enumerate(WIDE_PHASES)
          if not name or name.startswith("x_")]
    flush = (f"    for (int i = 0; i < {k}; ++i) "
             f"if ((tid == 0 && i < {xs[0]}) || "
             f"(tid == kWConsumers && i >= {xs[0]})) "
             "atomicAdd(&g_wphase[i], wph[i]);\n"
             f"    if (tid == 0) atomicAdd(&g_wphase[{k}], "
             "(unsigned long long)n_tiles);\n")
    sync = "    cluster.sync();  // no CTA leaves while a copy to or from it may"
    assert src.count(sync) == 2, sync
    src = src.replace(sync, flush + sync)
    src = src.replace('#include "mma_bf16.cuh"\n', '#include "mma_bf16.cuh"\n'
                      f"__device__ unsigned long long g_wphase[{k + 1}];\n")
    return src + f"""
extern "C" int hetu_wide_phases(unsigned long long* out, int reset) {{
  if (reset) {{
    unsigned long long zero[{k + 1}] = {{}};
    return (int)cudaMemcpyToSymbol(g_wphase, zero, sizeof(zero));
  }}
  return (int)cudaMemcpyFromSymbol(out, g_wphase, sizeof(g_wphase));
}}
"""


def wide_phases() -> int:
    import ctypes
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.ops import _build

    names = [n or "x_wait_stats" for _, n in WIDE_PHASES]
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "fused_ce_phases.cu"
    cu.write_text(wide_phase_source())
    so = cu.with_suffix(".so")
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    cs.emit(phase="wide_phases_build", rc=proc.returncode,
            seconds=time.perf_counter() - t0)
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hetu_fused_ce_dh.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.hetu_fused_ce_dw.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.hetu_wide_phases.argtypes = [vp, ci]
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 5)
    n, vocab, e = cs.LLAMA_FUSED_SHAPE
    h, w, lab, _, _ = cs.fused_inputs(gen, device, n, vocab, torch.bfloat16,
                                      torch.bfloat16, e)
    g = torch.full((n,), 1.0 / n, device=device)
    ng = -g
    lse, _ = ops.fused_lse_tgt_reference(h, w, lab)
    stream = vp(torch.cuda.current_stream(device).cuda_stream)
    for which in ("dh", "dw"):
        out = torch.empty_like(h if which == "dh" else w)
        args = [vp(t.data_ptr()) for t in (h, w, lab, lse, g, ng, out)]
        args += [n, vocab, e, 1, 1] + ([1] if which == "dw" else [])
        launch = getattr(lib, f"hetu_fused_ce_{which}")
        assert launch(*args, stream) == 0
        torch.cuda.synchronize()
        lib.hetu_wide_phases(None, 1)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        assert launch(*args, stream) == 0
        stop.record()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (len(names) + 1))()
        assert lib.hetu_wide_phases(buf, 0) == 0
        tiles = buf[len(names)]
        per = {k: buf[i] / tiles for i, k in enumerate(names)}
        cs.emit(phase="wide_phases", kernel=f"fused_ce_{which}",
                shape=[n, vocab, e], card=cs.nvidia_smi(),
                ms_with_counters=start.elapsed_time(stop),
                consumer_cycles_a_tile=sum(v for k, v in per.items()
                                           if not k.startswith("x_")),
                exchange_cycles_a_tile=sum(v for k, v in per.items()
                                           if k.startswith("x_")),
                phases={k: round(v, 1) for k, v in per.items()},
                note="x_: the exchange warpgroup's phases, each tile from "
                     "its statistics' wait to its next tile's copies")
    return 0


#: ``fwd-variants``: (variant, [(a piece of the wide forward's source, its
#: replacement)]); every piece occurs once
FWD_LOOP = """        wg_fence();
#pragma unroll
        for (int k = 0; k < kChunk / 16; ++k)
          wgmma_n128(p, da + 2 * k, db + 2 * k, k);
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          wg_pin(p[e]);
          s[e] += p[e];
        }
        // this warp is done with the stage: one arrival in every CTA
        __syncwarp();
        if (lane < C) mbar_arrive_remote(empty(st), lane);
        if (++st == kWfStages) {
          st = 0;
          ph ^= 1;
        }
      }
"""
FWD_VARIANTS = {
    "no_products": [("          wgmma_n128(p, da + 2 * k, db + 2 * k, k);\n",
                     "          ;\n")],
    "no_w": [("          mbar_expect(full(st), kWfHBytes + (vt < n_tiles ? "
              "kWfWBytes : 0));",
              "          mbar_expect(full(st), kWfHBytes);"),
             ("          if (vt < n_tiles)\n            tma_load(hs + "
              "kWfHBytes", "          if (false)\n            tma_load(hs + "
              "kWfHBytes")],
    "one_cta": [("  return best;\n}\n\nint launch_fwd_wide_tc",
                 "  return slots[0] > 0 ? 1 : 0;\n}\n\n"
                 "int launch_fwd_wide_tc")],
    "release_cluster": [('"mbarrier.arrive.shared::cluster.b64 _, [%0];',
                         '"mbarrier.arrive.release.cluster.shared::cluster.'
                         'b64 _, [%0];')],
    "double_p": [("    float s[64], p[64];\n",
                  "    float s[64], p[64], p2[64];\n"),
                 ("      for (int q = 0; q < kc; ++q) {\n"
                  "        mbar_wait(full(st), ph);\n"
                  "        const unsigned char* hs = smem + st * "
                  "kWfStageBytes;\n"
                  "        const uint64_t da = wg_desc(hs + wg * 64 * kChunk "
                  "* 2, 16, 1024);\n        const uint64_t db = wg_desc(hs "
                  "+ kWfHBytes, 16, 1024);\n" + FWD_LOOP, """      auto issue = [&](float (&d)[64]) {
        mbar_wait(full(st), ph);
        const unsigned char* hs = smem + st * kWfStageBytes;
        const uint64_t da = wg_desc(hs + wg * 64 * kChunk * 2, 16, 1024);
        const uint64_t db = wg_desc(hs + kWfHBytes, 16, 1024);
        wg_fence();
#pragma unroll
        for (int k = 0; k < kChunk / 16; ++k)
          wgmma_n128(d, da + 2 * k, db + 2 * k, k);
        wg_commit();
        const int done = st;
        if (++st == kWfStages) {
          st = 0;
          ph ^= 1;
        }
        return done;
      };
      auto retire = [&](float (&d)[64], int stage) {
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          wg_pin(d[e]);
          s[e] += d[e];
        }
        __syncwarp();
        if (lane < C) mbar_arrive_remote(empty(stage), lane);
      };
      int sa = issue(p);
      for (int q = 0; q < kc; q += 2) {
        int sb = 0;
        if (q + 1 < kc) {
          sb = issue(p2);
          wg_wait<1>();
        } else {
          wg_wait<0>();
        }
        retire(p, sa);
        if (q + 1 < kc) {
          if (q + 2 < kc) {
            sa = issue(p);
            wg_wait<1>();
          } else {
            wg_wait<0>();
          }
          retire(p2, sb);
        }
      }
""")],
}


def fwd_variant_source(name: str) -> str:
    """``csrc/fused_ce.cu`` with the wide forward changed as
    ``FWD_VARIANTS[name]`` says (the source as it is for ``as_built``)."""
    from hetu_tpu_torch.ops import _build
    src = (_build.CSRC / "fused_ce.cu").read_text()
    for old, new in FWD_VARIANTS.get(name, ()):
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    return src


def fwd_variants() -> int:
    import ctypes
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.ops import _build, fused_ce

    names = ["as_built", *FWD_VARIANTS]
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        cu = out_dir / f"fused_ce_fwd_{name}.cu"
        cu.write_text(fwd_variant_source(name))
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, rc = {}, 0
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        entry = [e for k, e in cs.ptxas_entries(log).items()
                 if "fused_ce_fwd_wide_tc_kernel" in k]
        cs.emit(phase="fwd_variant_build", variant=name, rc=proc.returncode,
                ptxas=entry, seconds=time.perf_counter() - t0)
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            rc = 1
            continue
        lib = ctypes.CDLL(str(so))
        lib.hetu_fused_ce_fwd.argtypes = fused_ce._FWD_ARGTYPES
        libs[name] = lib
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 5)
    n, vocab, e = cs.LLAMA_FUSED_SHAPE
    h, w, lab, _, _ = cs.fused_inputs(gen, device, n, vocab, torch.bfloat16,
                                      torch.bfloat16, e)
    want_lse, want_tgt = ops.fused_lse_tgt_reference(h, w, lab)
    lse, tgt = torch.empty_like(want_lse), torch.empty_like(want_tgt)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

    def launch(lib):
        err = lib.hetu_fused_ce_fwd(h.data_ptr(), w.data_ptr(),
                                    lab.data_ptr(), lse.data_ptr(),
                                    tgt.data_ptr(), n, vocab, e, 1, 1, stream)
        assert err == 0, err

    for name, lib in libs.items():
        launch(lib)
        torch.cuda.synchronize()
        cs.emit(phase="fwd_variant_check", variant=name,
                max_abs_err_lse=cs.max_err(lse, want_lse),
                max_abs_err_tgt=cs.max_err(tgt, want_tgt))
    timer = cs.Timer(device)
    ms = {name: [] for name in libs}
    for name in [*libs, *reversed(list(libs))]:
        ms[name].append(timer(lambda: launch(libs[name]), iters=5, warmup=1))
    cs.emit(phase="fwd_variants", card=cs.nvidia_smi(), shape=[n, vocab, e],
            plan=fused_ce.wide_fwd_info(n, vocab)["cluster"], ms=ms,
            note="each variant timed twice, the second pass in reverse "
                 "order; CUDA events over 5 calls, each after the "
                 "L2-evicting write")
    return rc


#: seconds of idle card before each of ``flash``'s timings
FLASH_SETTLE_S = 0.5


def flash_shapes(cs) -> tuple:
    """``flash``'s shapes: GPT-2's packed prefill chunk and the Llama
    pack, each with its pack's segment ids."""
    return (("gpt2_pack", dict(b=1, hq=12, hkv=12, s=cs.C, d=64,
                               seg=cs.pack_segments(cs.PACK, cs.C))),
            ("llama_pack", dict(b=1, hq=32, hkv=32, s=cs.LLAMA_CHUNK, d=128,
                                seg=cs.pack_segments(cs.LLAMA_PACK,
                                                     cs.LLAMA_CHUNK))))


def flash_bounds(cs, q, k, seg) -> dict:
    """#2's least times on these inputs: bytes at 3.35 TB/s, flops at the
    fp32 cores' rate, at 3xTF32's and at bf16's tensor-core rate."""
    nbytes, flops = cs.flash_work(q, k, seg, True)
    return dict(bytes_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                fp32_cores_ms=flops / 67e12 * 1e3,
                tf32x3_ms=flops / (495e12 / 3) * 1e3,
                bf16_ms=flops / 989e12 * 1e3, bytes=nbytes, flops=flops)


#: cycles of the spin kernel after each flush of a covered timing (about
#: 0.5 ms), as ``chip_smoke.py``'s ``COVER_CYCLES``
COVER_CYCLES = 1_000_000


def covered_ms(timer, fn, iters: int = 30, warmup: int = 3) -> float:
    """``timer(fn)`` (CUDA events over ``iters`` calls, each after the
    L2-evicting write) with a spin kernel after each write, so that the
    host's enqueue of ``fn`` is not timed; ``timer`` of either tree."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        timer.flush.zero_()
        torch.cuda._sleep(COVER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def device_ms(timer, fn, iters: int = 10) -> float:
    """Device ms a call of ``fn``, which launches each of its kernels
    once, from a ``torch.profiler`` window of ``timer`` (either tree's):
    the sum over its kernels, the L2-evicting fill left out, of each
    one's mean over its recorded launches (a window can drop some)."""
    counts: dict = {}
    by_name = timer.profile(fn, iters, counts)
    return sum(t / counts[n] for n, t in by_name.items()
               if "FillFunctor<unsigned char>" not in n)


def flash_of(tree: str, tag: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import torch.nn.functional as F
    import chip_smoke as cs
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    _build.build(["flash_fwd"])
    card = cs.nvidia_smi()
    timer = cs.Timer(device)
    gens = cs.Generators(device, cs.SEED + 6)

    def settled(fn):
        torch.cuda.synchronize()
        time.sleep(FLASH_SETTLE_S)
        return covered_ms(timer, fn)

    first = True
    for name, kw in flash_shapes(cs):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, seg = cs.flash_case(gens, device, dtype, **kw)
            scale = q.shape[-1] ** -0.5
            args = dict(causal=True, scale=scale)
            got = ops.flash_attention_fwd(q, k, v, seg, seg, **args)
            if first:   # a first timing in a process reads high: not kept
                settled(lambda: ops.flash_attention_fwd(q, k, v, seg, seg,
                                                        **args))
                first = False
            want = ops.flash_attention_fwd_reference(q, k, v, seg, seg,
                                                     **args)
            err = max(cs.max_err(a, b) for a, b in zip(got, want))
            mask = cs.flash_mask(seg, q.shape[2], k.shape[2], True, 0, 0,
                                 device)
            ms = settled(lambda: ops.flash_attention_fwd(q, k, v, seg, seg,
                                                         **args))
            library_ms = settled(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale))
            dev = device_ms(timer, lambda: ops.flash_attention_fwd(
                q, k, v, seg, seg, **args))
            lib_dev = device_ms(timer, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale))
            cs.emit(phase="flash_time", tree=tag, card=card, shape=name,
                    dims=list(q.shape), dtype=str(dtype).split(".")[1],
                    lane=ops.flash_lane(dtype, q.shape[-1]), ms=ms,
                    library_ms=library_ms, device_ms=dev,
                    library_device_ms=lib_dev, max_abs_err=err,
                    bound=flash_bounds(cs, q, k, seg))
            del q, k, v, seg, got, want
    return 0


#: ``flash-variants``' grids: (kWarpsQ, kWarpsK, kKeys) at d 64, then at
#: d 128
FLASH_GRIDS = {"q16_k1": ((1, 1, 64), (1, 1, 32)),
               "q16_k2": ((1, 2, 64), (1, 2, 32)),
               "q16_k4": ((1, 4, 64), (1, 4, 32)),
               "q32_k1": ((2, 1, 64), (2, 1, 32)),
               "q32_k2": ((2, 2, 64), (2, 2, 32)),
               "q64_k1": ((4, 1, 64), (4, 1, 32))}
TF_GRID_LINE = ("template <> struct TfGrid<{d}> {{ static constexpr int "
                "kWarpsQ = {0}, kWarpsK = {1}, kKeys = {2}; }};")


def flash_variant_source(name: str) -> str:
    """``csrc/flash_fwd.cu`` with the fp32 lane changed as ``name`` says
    (the source as it is for ``as_built``)."""
    import re
    from hetu_tpu_torch.ops import _build
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    pattern = re.compile(r"template <> struct TfGrid<(\d+)> \{[^\n]*\};")
    built = {int(m.group(1)): tuple(int(x) for x in re.findall(
        r"= (\d+)", m.group(0))) for m in pattern.finditer(src)}
    assert sorted(built) == [64, 128], built
    grids = dict(built)
    if name in FLASH_GRIDS:
        grids = dict(zip((64, 128), FLASH_GRIDS[name]))
    elif name == "d128_keys64":
        grids[128] = grids[128][:2] + (64,)
    src = pattern.sub(lambda m: TF_GRID_LINE.format(
        *grids[int(m.group(1))], d=m.group(1)), src)
    if name.startswith("s_chains"):
        src, n = re.subn(r"constexpr int kTfSChains = \d+;",
                         f"constexpr int kTfSChains = {name[-1]};", src)
        assert n == 1, name
    edits = {"cuda_core": [("  if (!bf16 && d == 64)\n", "  if (false)\n"),
                           ("  if (!bf16 && d == 128)\n", "  if (false)\n")],
             "d128_q_regs": [("constexpr bool kQRegs = D <= 64;",
                              "constexpr bool kQRegs = true;")]}
    for old, new in edits.get(name, ()):
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    return src


def flash_variants() -> int:
    import ctypes
    sys.path.insert(0, HERE)
    import torch.nn.functional as F
    import chip_smoke as cs
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.ops import _build, flash

    names = ["as_built", "cuda_core", *FLASH_GRIDS, "d128_keys64",
             "d128_q_regs", "s_chains1", "s_chains2"]
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        cu = out_dir / f"flash_fwd_{name}.cu"
        cu.write_text(flash_variant_source(name))
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, rc = {}, 0
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        entry = {k: e for k, e in cs.ptxas_entries(log).items()
                 if "flash_fwd_tf32x3_kernel" in k}
        cs.emit(phase="flash_variant_build", variant=name,
                rc=proc.returncode, ptxas=entry,
                seconds=time.perf_counter() - t0)
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            rc = 1
            continue
        lib = ctypes.CDLL(str(so))
        lib.hetu_flash_fwd.argtypes = flash._FWD_ARGTYPES
        libs[name] = lib
    device = torch.device("cuda", 0)
    gens = cs.Generators(device, cs.SEED + 6)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    timer = cs.Timer(device)
    cases = []
    for shape, kw in flash_shapes(cs):
        q, k, v, seg = cs.flash_case(gens, device, torch.float32, **kw)
        want = ops.flash_attention_fwd_reference(
            q, k, v, seg, seg, causal=True, scale=q.shape[-1] ** -0.5)
        cases.append((shape, q, k, v, seg, want, torch.empty_like(q),
                       torch.empty_like(want[1])))

    def launch(lib, case):
        _, q, k, v, seg, _, out, lse = case
        b, hq, sq, d = q.shape
        err = lib.hetu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            seg.data_ptr(), out.data_ptr(), lse.data_ptr(), b, hq,
            k.shape[1], sq, k.shape[2], d, d ** -0.5, 1, 0, 0, 0, 0, None,
            0, 1.0, stream)
        assert err == 0, err

    for name, lib in libs.items():
        errs = {}
        for case in cases:
            launch(lib, case)
            torch.cuda.synchronize()
            errs[case[0]] = max(cs.max_err(case[6], case[5][0]),
                                cs.max_err(case[7], case[5][1]))
        cs.emit(phase="flash_variant_check", variant=name, max_abs_err=errs,
                ok=all(e <= cs.TOL[torch.float32] for e in errs.values()))
    ms = {name: {case[0]: [] for case in cases} for name in libs}
    for case in cases:   # a first timing in a process reads high: not kept
        covered_ms(timer, lambda: launch(next(iter(libs.values())), case))
    for name in [*libs, *reversed(list(libs))]:
        for case in cases:
            torch.cuda.synchronize()
            time.sleep(FLASH_SETTLE_S)
            ms[name][case[0]].append(
                covered_ms(timer, lambda: launch(libs[name], case)))
    sdpa = {}
    for shape, q, k, v, seg, *_ in cases:
        mask = cs.flash_mask(seg, q.shape[2], k.shape[2], True, 0, 0, device)
        torch.cuda.synchronize()
        time.sleep(FLASH_SETTLE_S)
        sdpa[shape] = covered_ms(timer, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=q.shape[-1] ** -0.5))
    cs.emit(phase="flash_variants", card=cs.nvidia_smi(),
            shapes={c[0]: list(c[1].shape) for c in cases}, ms=ms,
            library_ms=sdpa,
            bounds={c[0]: flash_bounds(cs, c[1], c[2], c[4]) for c in cases},
            note="fp32, causal, the packs' segments; each variant timed "
                 "twice, the second pass in reverse order; CUDA events over "
                 "30 calls, each after the L2-evicting write and a spin "
                 "kernel that covers the host's enqueue")
    return rc


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


def pools() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.engine import StepCache, Trainer, TrainerConfig
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.parallel import Strategy
    _build.build()
    dev = torch.device("cuda", 0)
    cs.emit(phase="device", nvidia_smi=cs.nvidia_smi())
    cfg = cs.llama_train_cfg()
    batches = cs.ragged_llama_batches(cfg.vocab_size, 3, cs.SEED + 7)
    for order in ((0, 1, 2), (2, 1, 0)):
        cs.release()
        r0 = torch.cuda.memory_reserved()
        model = LlamaLMHeadModel(cfg, device=dev, seed=cs.SEED)
        tr = Trainer(model, optim.chain(optim.clip_by_global_norm(1.0),
                                        optim.adamw(1e-4)),
                     Strategy(remat="selective", unroll=True), device=dev,
                     step_cache=StepCache(),
                     config=TrainerConfig(precision="bf16", log_every=0,
                                          prefetch=0,
                                          seq_buckets=cs.LLAMA_BUCKETS))
        tr.initialize()
        for j in order:
            tr.train_step(batches[j])
        graphs = {b: pb for b, (c, pb) in tr.captures().items() if c}
        cs.release()
        r1 = torch.cuda.memory_reserved()
        tr.close()
        cs.release()
        cs.emit(phase="pools", order=[cs.LLAMA_BUCKETS[j] for j in order],
                graph_bytes={str(b): graphs[b] for b in
                             (cs.LLAMA_BUCKETS[j] for j in order)},
                pool_bytes=sum(graphs.values()), reserved_trained=r1 - r0,
                freed_by_close=r1 - torch.cuda.memory_reserved())
        del tr, model
    return 0


def oracle() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.models import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine
    _build.build()
    dev = torch.device("cuda", 0)
    cs.emit(phase="device", nvidia_smi=cs.nvidia_smi())
    cfg = LlamaConfig.llama_7b()
    model = LlamaLMHeadModel(cfg, device=dev, dtype=torch.bfloat16,
                             seed=cs.SEED)
    burst, _ = cs.llama_workload(cfg.vocab_size)
    with autocast(BF16_FULL):
        eng = ServingEngine(model, slots=cs.LLAMA_SLOTS,
                            max_len=cs.LLAMA_MAX_LEN,
                            prefill_chunk=cs.LLAMA_CHUNK,
                            block_size=cs.LLAMA_BLOCK,
                            cache_dtype=torch.int8, seed=cs.SEED,
                            device=dev, record_first_logits=True)
        reqs = [eng.submit(p, SamplingParams(max_tokens=64))
                for p in burst[:16]]
        eng.run_until_drained()
        for rows in (1, cs.ORACLE_ROWS):
            cs.ORACLE_ROWS = rows
            got = cs.oracle(model, reqs, 64, cfg.vocab_size)
            cs.emit(phase="oracle", rows_a_call=rows, **got)
    return 0


def noise() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hetu_tpu_torch.core import BF16_FULL, FP32, autocast
    from hetu_tpu_torch.models import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine
    _build.build()
    dev = torch.device("cuda", 0)
    cs.emit(phase="device", nvidia_smi=cs.nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama_7b()
    vocab = cfg.vocab_size
    model = LlamaLMHeadModel(cfg, device=dev, dtype=torch.bfloat16,
                             seed=cs.SEED).eval()
    burst, shared = cs.llama_workload(vocab)
    rng = np.random.default_rng(cs.SEED + 21)
    waves = [[rng.integers(0, vocab, int(n)).tolist()
              for n in rng.integers(16, 257, k)] for k in cs.TTFT_WAVES]
    shortest = sorted(burst, key=len)[:24]

    def engine():
        return ServingEngine(model, slots=cs.LLAMA_SLOTS,
                             max_len=cs.LLAMA_MAX_LEN,
                             prefill_chunk=cs.LLAMA_CHUNK,
                             block_size=cs.LLAMA_BLOCK,
                             cache_dtype=torch.int8, seed=cs.SEED,
                             device=dev, record_first_logits=True)

    def forced(reqs, rows):
        out = {}
        for i in range(0, len(reqs), rows):
            batch = reqs[i:i + rows]
            got = cs.forced_logits_rows(
                model, [r.prompt.tolist() for r in batch],
                [list(r.tokens) for r in batch], torch.int8)
            out.update((r.id, lg) for r, lg in zip(batch, got))
        return out

    def shortfall(logits, tokens):
        idx = torch.tensor(tokens, device=logits.device)[:, None]
        return float((logits.max(-1).values
                      - logits.gather(1, idx)[:, 0]).max())

    with autocast(BF16_FULL):
        eng = engine()
        eng.generate_many([burst[0][:300]], SamplingParams(max_tokens=3))
    sets = {}
    with autocast(BF16_FULL):
        eng = engine()
        got = []
        for w in waves:
            got += [eng.submit(p, SamplingParams(max_tokens=16)) for p in w]
            eng.run_until_drained()
        sets["fresh_waves"] = (got, 16)
        eng = engine()
        got = [eng.submit(p, SamplingParams(max_tokens=16))
               for p in shortest]
        eng.run_until_drained()
        sets["burst_24_shortest"] = (got, 16)
        eng = engine()
        run = cs.serve(eng, burst, shared, SamplingParams(max_tokens=64))
        sets["llama_engine"] = (run["reqs"] + run["reqs2"], 64)
        del eng, run
    for name, (reqs, new) in sets.items():
        t0 = time.perf_counter()
        with autocast(BF16_FULL):
            reading = cs.oracle(model, reqs, new, vocab)
            b16 = forced(reqs, cs.ORACLE_ROWS)
            b1 = forced(reqs, 1)
        with autocast(FP32):
            f32 = forced(reqs, cs.ORACLE_ROWS)
        rows = []
        for r in reqs:
            e = r.first_logits.float()
            rows.append(dict(
                prompt=len(r.prompt),
                eng_fp32=cs.max_err(e, f32[r.id][0]),
                orc16_fp32=cs.max_err(b16[r.id][0], f32[r.id][0]),
                orc1_fp32=cs.max_err(b1[r.id][0], f32[r.id][0]),
                eng_orc16=cs.max_err(e, b16[r.id][0]),
                orc1_orc16=cs.max_err(b1[r.id][0], b16[r.id][0]),
                eng_short_fp32=shortfall(f32[r.id], list(r.tokens)),
                orc16_short_fp32=shortfall(
                    f32[r.id], b16[r.id].argmax(-1).tolist())))
        worst = {k: max(x[k] for x in rows) for k in rows[0]
                 if k != "prompt"}
        farther = [dict(prompt=x["prompt"],
                        eng_fp32=round(x["eng_fp32"], 4),
                        orc16_fp32=round(x["orc16_fp32"], 4))
                   for x in rows
                   if x["eng_fp32"] > max(x["orc16_fp32"],
                                          x["orc1_fp32"])]
        top = sorted(rows, key=lambda x: -x["eng_orc16"])[:6]
        cs.emit(phase="noise", traffic=name, requests=len(reqs),
                new_tokens=new, reading=reading, worst=worst,
                engine_farther_from_fp32_than_both_oracles=len(farther),
                farther=farther[:8],
                top_eng_orc16=[{k: (round(v, 4) if isinstance(v, float)
                                    else v) for k, v in x.items()}
                               for x in top],
                fp32_first_logit_std=float(np.mean(
                    [float(f32[r.id][0].std()) for r in reqs])),
                seconds=time.perf_counter() - t0)
        del b16, b1, f32
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def fleet(which) -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    cs.emit(phase="device", nvidia_smi=card)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig.small()
    model = GPTLMHeadModel(cfg, device=dev, seed=cs.SEED).eval()
    burst, shared = cs.workload(cfg.vocab_size)
    sp = SamplingParams(max_tokens=64)
    warm = ServingEngine(model, slots=2, max_len=512, prefill_chunk=64,
                         block_size=16, device=dev)
    warm.generate_many([burst[0][:70]], SamplingParams(max_tokens=3))
    del warm
    run = cs.serve(cs.fleet_engine(model, dev), burst, shared, sp)
    reqs = run["reqs"]
    timings = [r.timing() for r in reqs]
    ttft = [t["ttft_ms"] for t in timings]
    tpot = [t["decode_ms"] / (len(r.tokens) - 1)
            for t, r in zip(timings, reqs)]
    perf = dict(burst_tokens_per_s=sum(len(r.tokens) for r in reqs)
                / run["t_burst"], ttft_ms_p50=cs.percentile(ttft, 50),
                ttft_ms_p99=cs.percentile(ttft, 99),
                tpot_ms_p50=cs.percentile(tpot, 50))
    cs.emit(phase="fleet_engine", card=card, **perf)
    memo: dict = {}
    cs.generate_oracle("fleet_engine_oracle", model, reqs + run["reqs2"],
                       64, dev, memo)
    del run, reqs
    gc.collect()
    gpt2 = dict(model=model, perf=perf, oracle=memo)
    colocated: dict = {}
    failed = 0
    for name in which or ("fleet", "kill", "push", "pd", "server",
                          "rollout"):
        t0 = time.perf_counter()
        try:
            if name == "fleet":
                _, colocated = cs.phase_gpt2_fleet(dev, card, gpt2)
            elif name == "pd":
                cs.phase_gpt2_fleet_pd(dev, card, gpt2, colocated)
            elif name == "rollout":
                cs.phase_gpt2_rollout(dev, card)
            else:
                getattr(cs, f"phase_gpt2_fleet_{name}")(dev, card, gpt2)
        except Exception:                           # noqa: BLE001
            traceback.print_exc()
            failed += 1
        cs.emit(phase="fleet_probe", which=name,
                seconds=time.perf_counter() - t0)
    return 1 if failed else 0


#: Python objects added to the heap for ``repl``'s second pass
REPL_BALLAST = 4_000_000


class _TimedLock:
    """A lock that logs, per acquisition, its thread, its wait and its
    hold on a shared timeline."""

    def __init__(self, lock, log):
        self._lk, self._log = lock, log

    def acquire(self, blocking=True, timeout=-1):
        t0 = time.perf_counter()
        got = self._lk.acquire(blocking, timeout)
        if got:
            self._t = (t0, time.perf_counter())
        return got

    def release(self):
        import threading
        t0, t1 = self._t
        t2 = time.perf_counter()
        self._lk.release()
        self._log.append((threading.current_thread().name, "lock",
                          t0, t1, t2))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._lk.locked()


def repl_run(model, dev, prompts, variant) -> dict:
    """One decode run of ``variant`` (see the module docstring) with its
    host timeline."""
    import chip_smoke as cs
    from hetu_tpu_torch.serving import KVReplicaStore, SamplingParams
    eng = cs.fleet_engine(model, dev)
    store = KVReplicaStore()
    log: list = []
    eng._step_lock = _TimedLock(eng._step_lock, log)

    def timed(kind, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            log.append(("repl", kind, t0, t0, time.perf_counter()))
            return out
        return run

    eng._gather_blocks = timed("gather", eng._gather_blocks)

    def pinned(gathered):
        # ``_to_host``'s copy into fresh buffers, its two parts timed
        out = timed("pin_alloc", lambda: [
            torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
            for g in gathered])()

        def copy():
            for host, g in zip(out, gathered):
                host.copy_(g, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
        timed("copy", copy)()
        return out
    if variant == "pinned":
        eng._repl_to_host = timed("to_host", pinned)
    elif variant == "gather":
        eng._repl_to_host = timed("to_host", lambda g: [])
    else:
        eng._repl_to_host = timed("to_host", eng._repl_to_host)
    sink = (lambda doc: None) if variant == "gather" else store.put
    if variant != "off":
        eng.configure_replication(timed("sink", sink), origin="probe")
    steps = []
    gc_t: dict = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_t["t0"] = time.perf_counter()
        elif "t0" in gc_t:
            t0 = gc_t.pop("t0")
            log.append(("gc", f"gc{info['generation']}", t0, t0,
                        time.perf_counter()))
    gc.callbacks.append(on_gc)
    try:
        for p in prompts:
            eng.submit(p, SamplingParams(max_tokens=cs.KILL_NEW))
        while eng.has_work():
            pf = eng.lane_iters["prefill"]
            n = len(log)
            t0 = time.perf_counter()
            eng.step()
            t1 = time.perf_counter()
            if eng.lane_iters["prefill"] == pf:
                mine = [e for e in log[n:] if e[0] == "MainThread"]
                wait = mine[0][3] - mine[0][2] if mine else 0.0
                steps.append((t0, t1, wait))
    finally:
        gc.callbacks.remove(on_gc)
        eng.configure_replication(None)
        eng.stop()
    ms = [(t1 - t0) * 1e3 for t0, t1, _ in steps]
    return dict(variant=variant, steps=steps, log=log, ms=ms,
                shipments=store.put_total)


def repl_summary(run, slow_ms) -> dict:
    import chip_smoke as cs
    ms = run["ms"]
    slow = [(t0, t1, w) for (t0, t1, w), m in zip(run["steps"], ms)
            if m > slow_ms]
    repl = [e for e in run["log"] if e[0] != "MainThread"]
    over = {}
    for t0, t1, _ in slow:
        for name, kind, a, b, c in repl:
            if a < t1 and c > t0:
                over[kind] = over.get(kind, 0) + 1
    phase_ms = {}
    for name, kind, a, b, c in repl:
        phase_ms.setdefault(kind, []).append((c - a) * 1e3)
    lock_hold = [(c - b) * 1e3 for name, kind, a, b, c in repl
                 if kind == "lock"]
    return dict(
        variant=run["variant"], ballast=run.get("ballast", 0),
        heap_objects=run.get("heap_objects"),
        steps=len(ms),
        ms_p50=cs.percentile(ms, 50), ms_p99=cs.percentile(ms, 99),
        ms_max=max(ms), shipments=run["shipments"],
        slow_over_ms=slow_ms, slow_steps=len(slow),
        slow_lock_wait_ms_max=max((w * 1e3 for _, _, w in slow),
                                  default=None),
        sink_calls=sum(1 for e in repl if e[1] == "sink"),
        slow_steps_overlapping=over,
        repl_lock_hold_ms_max=max(lock_hold) if lock_hold else None,
        repl_phase_ms={k: dict(n=len(v), p50=cs.percentile(v, 50),
                               max=max(v)) for k, v in phase_ms.items()})


def repl() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    cs.emit(phase="device", nvidia_smi=card)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig.small()
    model = GPTLMHeadModel(cfg, device=dev, seed=cs.SEED).eval()
    burst, _ = cs.workload(cfg.vocab_size)
    prompts = [p for p in burst if len(p) <= 512 - cs.KILL_NEW][:16]
    warm = ServingEngine(model, slots=2, max_len=512, prefill_chunk=64,
                         block_size=16, device=dev)
    warm.generate_many([burst[0][:70]], SamplingParams(max_tokens=3))
    del warm
    order = ["off", "pinned", "staged", "gather",
             "gather", "staged", "pinned", "off"]
    runs = []
    ballast: list = []
    for size in (0, REPL_BALLAST):
        # a heap of chip_smoke.py's size by the fleet phases: a full
        # collection then takes as long as it does there
        ballast.extend([i] for i in range(size - len(ballast)))
        for variant in order:
            runs.append(repl_run(model, dev, prompts, variant))
            runs[-1]["ballast"] = size
            runs[-1]["heap_objects"] = len(gc.get_objects())
            gc.collect()
    base = cs.percentile([m for r in runs if r["variant"] == "off"
                          for m in r["ms"]], 50)
    for turn, run in enumerate(runs):
        cs.emit(phase="repl_probe", card=card, turn=turn,
                **repl_summary(run, 3 * base))
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("port_probe: no CUDA device is available", file=sys.stderr)
        return 2
    if argv[:1] == ["kernels"] and len(argv) == 1:
        return kernels()
    if argv[:1] == ["fused"] and len(argv) == 1:
        return fused_of(HERE, "this")
    if argv[:1] == ["wide-phases"] and len(argv) == 1:
        return wide_phases()
    if argv[:1] == ["fwd-variants"] and len(argv) == 1:
        return fwd_variants()
    if argv[:1] == ["flash"] and len(argv) == 1:
        return flash_of(HERE, "this")
    if argv[:1] == ["flash-variants"] and len(argv) == 1:
        return flash_variants()
    if argv[:1] == ["int8"] and len(argv) == 1:
        return int8()
    if argv[:1] == ["pools"] and len(argv) == 1:
        return pools()
    if argv[:1] == ["oracle"] and len(argv) == 1:
        return oracle()
    if argv[:1] == ["noise"] and len(argv) == 1:
        return noise()
    if argv[:1] == ["fleet"]:
        return fleet(argv[1:])
    if argv[:1] == ["repl"] and len(argv) == 1:
        return repl()
    if argv[:1] in (["steps"], ["serve"], ["fused"], ["flash"]) \
            and len(argv) == 3:
        return in_turns(argv[0], argv[1], argv[2])
    if argv[:1] == ["fused-of"] and len(argv) == 3:
        return fused_of(argv[1], argv[2])
    if argv[:1] == ["flash-of"] and len(argv) == 3:
        return flash_of(argv[1], argv[2])
    if argv[:1] == ["steps-of"] and len(argv) == 3:
        return steps_of(argv[1], argv[2])
    if argv[:1] == ["serve-of"] and len(argv) == 3:
        return serve_of(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
