#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hetu_tpu_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, serves GPT-2 small through ``ServingEngine``, trains
it with ``build_train_step``, serves Llama-7B (all 32 layers) from the
int8 KV arena
(also from an arena sized by an HBM budget, under preemption, and with
speculative decoding), trains Llama at 7B width through ``Trainer`` and
``SFTTrainer``, with the chunked and with the fused LM head, saves and
resumes that training, trains it on ragged batches through seq-len
buckets, with split-phase accumulation and with Adafactor (every
training step a captured CUDA graph), trains (BASELINE config 4) and
serves GPT-MoE
8-expert,
serves GPT-2 drafting for itself and from a small draft model,
fine-tunes Llama-7B at full depth with LoRA, serves Llama-7B and
GPT-2 with LoRA adapters of several tenants mixed in one batch, and
serves GPT-2 through an in-process fleet (a router over replicas, a
replica killed, a rolling weight push, a prefill/decode split, the fleet
verbs and tools, the train→serve rollout loop),
serves GPT-2 and Llama-7B online: the engine's background loop behind
``ServingServer``, driven over local sockets by ``CoordinatorClient``
(with a weight swap on the live Llama server), and serves Llama-7B and
GPT-MoE with W8A8 decode (int8 FFN products in the captured decode
lane).

Run from the repository root, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- the card's name and power limit (``nvidia-smi``); compute
   capability 9.0 (Hopper) is required.
2. build   -- ``nvcc`` builds every kernel from ``hetu_tpu_torch/csrc``,
   one process per source, all at once; ``ptxas``, ``ptxas_paged`` and
   ``ptxas_fused`` report registers and spills of the tensor-core flash
   instances (the fp32 forward's 3xTF32 ones too; d 64 must not spill),
   of every instance of the paged kernel's lanes and of the
   fused CE kernels (the tensor-core instances of #5-#7, narrow and
   wide, must not spill).
3. kernel  -- each kernel against its plain version on the card, at the
   serving path's shapes (fp32 and bf16) and at edge shapes (GQA, segment
   pads, offsets that leave rows with no key, dropout 0.1, a ragged
   200-token sequence, a 64-token chunk over a 320-token history). bf16
   at head_dim 64/128 runs the tensor-core lanes of the flash forward, dQ
   and dK/dV, fp32 there the forward's 3xTF32 lane, the rest their
   CUDA-core lanes; a bf16 head_dim-96 case must take the CUDA-core
   lanes, and every fp32 forward case the lane ``ops.flash_lane`` names
   (``lane`` lines, read from a profile of that case; the 3xTF32 lane's
   reruns bit-equal). The
   paged kernel (#1) runs decode and the pack's history in its per-row
   form through its split-KV lane (each rerun bit-equal) and the history
   through ``row_slot`` and GQA 2 / R = 3 through its run-shared tile
   lane; ``lane`` lines put each timed call's device time under the
   lane's symbols, and ``profile_device_ms`` beside its time is the
   profiler's device time a call. Max
   abs error
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
   1e-4 (a near-tie, printed). The engine's two lanes (decode, packed
   prefill) are CUDA graphs captured when it is built: each must be
   captured exactly once (``captures``: ``engine.trace_counts()`` and
   the engine's own count) after construction, after the bursts and
   after the profiles, and the launches are counted through the replays.
   ``step_graph_replay`` runs each lane eagerly and as a replay from one
   arena state and one set of operands (three live slots, a pack with a
   finishing row): logits and arena must be bit-equal. Profiles of a
   mixed and a steady-decode window (device ms by class: the kernels,
   matmul, then the eager ops by kind), and ``engine_decode_step_split``:
   a steady-decode step's host time by part, without the profiler,
   beside one replay's device time.
4a. gpt2_telemetry -- ``engine``'s engine and 48 + 16 prompts served with
   telemetry off, then on with ``slo=True`` and the watchdog (1 s
   floor): tokens and first-token logits bit-equal, one capture a lane
   each, #1/#2 launches as in ``engine``; the engine's series against
   the run (requests, tokens, TTFT/TPOT counts, the kernel-path counters
   against the lane replays, prefix hit/miss tokens); ``trace.json``
   with one request track a request, parsed by the port's
   ``trace_summary``; behind ``ServingServer``: HEALTHZ ``ok``, METRICS
   parsed as Prometheus text, DUMPOBS's bundle, then a planted stall
   (the step lock held 3 s) trips the watchdog once, its dump parses,
   HEALTHZ reads degraded and a later request finishes. Step ms with
   telemetry on and off.
4b. gpt2_server -- the ``engine`` phase's model at its settings behind
   ``ServingServer(engine, 0)`` (a free local port), the loop started:
   ``engine``'s 48 burst prompts in thirds over 6 client threads
   (GENERATE, SUBMIT + RESULT, ``generate_stream``; each GENERATE and
   stream thread one request at a time), one stream socket shut after its
   first token event (the client resubscribes at its offset), then the 16
   shared-prefix prompts streamed (the first alone). Launch counters
   zeroed just before and read just after: 12 of #1 and #2 a lane
   replay, as in ``engine``; one capture a lane with the loop thread
   stepping; every request's tokens are the engine's own and equal
   ``generate`` but at a near tie (the ``engine`` phase's oracle reused);
   every stream's event offsets contiguous from 0 (``FrameTap``), its
   tokens its RESULT's; the killed stream on a second channel, no poll
   fallback; ``stop()`` joins the thread. Printed: client-side TTFT and
   TPOT (p50, p99) beside the engine's ``Request.timing()`` for the same
   requests, GENERATE's client total beside the engine's, and the wire
   burst's tokens/s beside ``engine``'s in-process burst.
4c. gpt2_fleet -- ``engine``'s model behind a ``Router`` over two replicas
   at its settings, the second built and registered while the first
   serves the first half of the burst (a capture between two of its
   iterations, ``engine.step_graph.DEVICE_GUARD``); then the whole burst
   on the settled fleet with its prefix caches flushed (tokens/s, TTFT
   and TPOT p50/p99 beside ``engine``'s); then the 16 shared-prefix
   prompts one at a time, which land on one replica and read its cache.
   Every token is the ``engine`` oracle's (reused, near ties as there),
   both replicas take part of the burst, each captured each lane once,
   each replica's #1 and #2 tallies are its lane iterations x 12, and the
   process counters are their sum plus the second replica's warm-up.
4d. gpt2_fleet_kill -- decode-KV replication on; 16 requests of 64
   tokens; the replica with the most in flight killed once one of its
   requests has 8 tokens: every request done exactly once with the
   oracle's tokens, a salvaged spill resumed by the peer; then a fresh
   pair whose victim's ``evict_request`` raises: recovery from the
   buddy's ``KVReplicaStore``. Decode step ms with replication on and off.
4e. gpt2_fleet_push -- a ``WeightPublisher`` rolling push of a seed-1
   GPT-2 small into two replicas (each its own copy of the weights) under
   a trickle of 24 requests of 16 tokens: none rejected or lost, each
   request's tokens under its own version's weights (the seed-1 oracle
   for version 1), every replica at version 1 serving the new tokens, no
   re-capture, never zero live replicas; drain and swap ms a replica and
   ``weight_push_bytes_total``.
4f. gpt2_fleet_pd -- a prefill-role and a decode-role replica: the burst
   with the oracle's tokens, one handoff a request, TTFT and TPOT beside
   ``gpt2_fleet``'s colocated burst.
4g. gpt2_fleet_server -- ``launch_serving_fleet(build_engine, 2,
   port=0)``: GENERATE and SUBMIT + RESULT through ``CoordinatorClient``
   (oracle tokens), FLEET, DRAIN, RESUME, FLEETMETRICS (each replica's
   series); KVEXPORT from one ``ServingServer`` and KVIMPORT into another,
   whose next request reads the 128-token prefix from its cache, and an
   import after a swap refused; the DUMPOBS bundle merged by
   ``tools/fleet_trace.py`` (one request's track holds its dispatch and
   its replica's phases); ``tools/fleet_top.py --once``, a row a replica.
4h. gpt2_rollout -- ``workloads.run_rollout_loop`` on GPT-2 small: 2
   rounds, 2 replicas, 6 prompts a round, 2 SFT steps a round (bf16
   compute: #2-#4's tensor-core lanes), a trickle of 3 under each push:
   no request lost, versions 1 then 2, finite losses.
5. train   -- GPT-2 small at ``bench.py main()``'s TPU configuration:
   seq 1024, fp32 params with bf16 compute, ``Strategy(remat=
   "selective", unroll=True)``, AdamW(1e-4, wd 0.01). First a step
   oracle: one fp32 step's loss and every grad with the kernels on the
   card against the same weights and batch on the CPU (plain path), at
   batch 1. Then batch 32 (the ladder's first rung): 3 warm-up and 10
   timed steps on one repeated batch; the loss must fall, and the
   counters (zeroed just before the timed steps) must read exactly 12
   launches per step of ``flash_fwd``, ``flash_bwd_dq`` and
   ``flash_bwd_dkv``. One step under full remat must read 24/12/12.
   Step ms, tokens/s, MFU against the 989 TFLOP/s bf16 dense peak, the
   batch that ran and peak memory. Every training step of the script is
   captured (``engine/train_step.py``): the first call of a batch shape
   runs the step and captures it, the others replay; each training phase
   prints its graphs' captures and pool bytes, and runs its step body
   once eagerly under ``torch.cuda.set_sync_debug_mode("error")``
   (``<phase>_sync_free``: no host sync inside a step).
   train_capture -- the captured step against its eager body: GPT-2
   small at that batch, with dropout 0 and 0.1 (attention and
   residual): 10 steps through ``Trainer.train_step`` against 10 of
   ``TrainStep.body`` on a twin from the same seed, loss, grad norm and
   every param bit-equal after each step, one capture, 120 launches of
   each flash kernel; step ms of each and their profiles' idle shares.
6. train_kernels -- the three flash kernels at the batch that ran (12
   heads, seq 1024, d 64, causal), fp32 and bf16, against their plain
   versions, then timed in bf16 as the main path runs them: the
   per-kernel profile three times (``kernel_spread``: min, median, max
   of the mean over the launches the profiler recorded, which late in
   this process may be fewer than made), the median reported, and
   checked against CUDA events around whole calls (``kernel_events``).
7. train_profile -- ``torch.profiler`` over 3 steps: device ms per step
   by class and the device's idle share; the three flash kernels' device
   time must lie under the tensor-core symbols (``lane``), as in the
   combo's profile (and the forward's at the Llama pack).
8. fused_ce kernels -- the fused LM-head CE kernels (forward, dH, dW)
   against their plain versions with h and w each fp32 or bf16 (bf16 h:
   the tensor-core lanes of all three, ``ops.fused_ce_lane``), at V =
   50257, a ragged V = 1013 and V = 50, N not a multiple of any token
   tile and N = 5, E = 768, 64 and 192, labels of -1 and V - 1 and
   random general (glse, gtgt) cotangents; every case with a bf16
   operand run twice, bit-equal; an fp32 w with bf16 h bit-identical to
   w cast to bf16 (kernel_w_cast). Then the wide lanes (E past 768, each
   case in the four dtype pairings, rerun and w cast alike): E = 832, 4,096
   and 5,120 at ragged N and V (333 x 1,013, 1,000 x 32,003, 333 x
   5,003), and E = 832 at 8,000 x 800, where the tensor-core forward's
   plan takes a cluster of C > 1 (2 on an H100) with a ragged last token
   tile and 7 vocab tiles, one CTA's last past V; the forward's cluster
   plans (library against ``ops.fused_ce.wide_fwd_plan``) beside dH's
   and dW's (wide_plan).
   Bounds: lse/tgt 1e-4; dh/dw element by element 2 ulps of the output's
   dtype plus 1e-4 (fp32 h) or 2e-4 (bf16 h) of max |reference|.
9. train_fused -- ``bench.py``'s fused-CE combo (``workloads/
   mfu_sweep.py --one {48,32}:selective:1:auto --param-dtype bf16 --ce
   fused``): ``HETU_LM_LOSS_IMPL=fused`` (set for these phases and
   restored after), bf16 params and compute, the rest as in ``train``.
   First the fp32 step oracle of ``train`` with the fused loss (launches
   exactly 1 per fused kernel and 12 per flash kernel), then batch 48
   (the ladder's first rung) with 3 warm-up and 10 timed steps: launches
   exactly 10 per fused kernel and 120 per flash kernel; then its
   profile, whose
   ``lane`` lines put #5's, #6's and #7's device time under their
   tensor-core symbols.
10. fused_ce times -- the three kernels at the combo's training shape (N
   = batch x 1024 tokens, bf16 h and w) against their plain versions,
   then timed; ``library_ms`` is the port's ``chunked_lm_loss`` (cuBLAS
   plus torch ops: no single PyTorch call computes these functions),
   forward only for the forward kernel, forward and backward for dH/dW;
   ``gemm_ms`` is one cuBLAS call for the logits product in their bodies,
   ``torch.mm(h, w.t(), out_dtype=torch.float32)``.
11. llama kernels -- kernel #1's int8 lane against its plain version at
   the Llama engine's shapes (decode q (16, 1, 32, 128) at 1024 live
   positions per slot and at ragged depths, prefill history q (256, 1,
   32, 128) per row and through ``row_slot``, the (2049, 16, 32, 128)
   int8 arena), at edge shapes (GQA 4, R = 3, offsets of -1, zero-scale
   rows, a poisoned null block) and at GPT-2's d = 64, q fp32 and bf16;
   split-KV reruns bit-equal. Bounds: fp32 out and lse 1e-5; bf16 out 1
   bf16 ulp of the reference + 1e-5, lse 1e-5. Then d = 128 cases of
   #1's fp32/bf16 lanes (decode, the history through ``row_slot``, GQA
   4 / R = 3) and of #2 at the Llama pack (1, 32, 256, 128), with the
   usual bounds, and times of the int8 lane (decode, the history through
   ``row_slot``), the bf16 lane (decode) and #2 (pack), bf16 q; the int8
   lane's library yardstick gathers, dequantizes to q's dtype and runs
   SDPA. Then #1 at the verify lane's shapes (``VERIFY_CASES``): Llama q
   (16, K+1, 32, 128) bf16 over the int8 arena at 1,024 positions, K = 4
   (the tensor-core tile lane) and K = 3 (split-KV), GPT-2 q (16, 5, 12,
   64) fp32 (the CUDA-core tile lane), and each with slots whose last
   rows lie past their tables; bounds 1e-4 / 2e-2 (out and lse), reruns
   bit-equal, the first three timed (lane, kernel, plain, library: the
   gathered rows dequantized, SDPA with each row's causal offset; bound).
11b. w8a8_gemm -- one FFN product at Llama-7B's shapes (4,096 -> 11,008
   and 11,008 -> 4,096, at 16 and 80 rows) as bf16 ``F.linear``, W8A16,
   W8A8 quantizing the weight per call, W8A8 pre-quantized (the decode
   lane's) and the int32 contraction alone (``int8_mm``): ms each, the
   int8 weight's bytes at 3.35 TB/s, and each output's largest error
   over the bf16 product's largest value, under 0.05; the two W8A8
   products bit-equal.
12. llama_engine -- ``LlamaConfig.llama_7b`` (hidden 4096, all 32
   layers: ``LLAMA_SERVE_LAYERS``,
   bf16 params and compute under ``autocast(BF16_FULL)``, random weights
   from a seed) served by ``ServingEngine(slots=16, max_len=2048,
   prefill_chunk=256, block_size=16, cache_dtype=int8)``: 48 greedy
   requests with 16-1536-token prompts and ``max_tokens=64``, then 16
   that share a 512-token system prompt (three of them also share part
   of a block: copy-on-write); the engines are built under the bf16
   policy, so their lanes are captured once, as in ``engine``. Launches
   exactly one ``paged_attention_int8`` a layer per decode-lane
   iteration and one ``paged_attention_int8`` + one ``flash_fwd`` a
   layer per prefill-lane iteration. The oracle (bf16, ``decode`` over a dense int8 cache,
   teacher-forced on the engine's tokens, ``ORACLE_ROWS`` requests a
   right-padded batch) reads every step of all 64 requests: the first-token logits must agree within ``DLOGIT_BF16``
   and the engine's token must lie within ``TIE_BF16`` of the oracle's
   best at every step; printed beside how far bf16 itself moves the
   logits (bf16 against fp32 compute). Then 16 fresh prompts are served
   once per fault planted in the int8 lane's inputs (``FAULTS``; each
   engine built inside the fault, so its captured lanes hold it), and
   the same bounds must fail each. Then two profiles, a window of
   prefill and decode mixed (#1 under both lanes) and steady decode (#1
   all under the split-KV lane), the step split, ``step_graph_replay``
   (bf16, int8 arena), and the LM head's per-call fp32 cast against a
   held fp32 copy. The GPT-2 engine is profiled the same two ways.
12b. llama_telemetry -- the llama_engine's model and settings with
   telemetry on and ``slo=True``: llama_engine's 64 requests on its
   schedule, every token and first-token logit bit-equal to its
   telemetry-off run and within the bf16 oracle's bounds; then, under
   the default rules afresh, 8 fresh short prompts and 16 held 1.5 s
   before admission: the TTFT burn-rate alert fires on the delayed wave
   only, the health document reads degraded. After every step the
   queue, occupancy, block and spill gauges equal the engine's own
   counts; launches and captures as in ``llama_engine``.
13. memory pressure -- the llama_engine's model served three more ways.
   ``llama_budget_engine``: ``ServingEngine(hbm_budget_bytes=40e9,
   max_len=2048, prefill_chunk=256, block_size=16, cache_dtype=int8)``
   sizes its arena by ``engine/memory.py``'s ledger (4 bytes a
   parameter, 10% headroom): the slot count must be the ledger's and the
   arena ``n_blocks`` x ``kv_bytes_per_block`` bytes exactly; it serves
   ``llama_workload``'s burst once (launches as in ``llama_engine``, the
   first 16 requests against the bf16 oracle) and prints the real
   footprint beside the ledger's. ``llama_preempt``: ``slots=16,
   kv_blocks=385`` (8 worst-case batch requests of 512 + 256 tokens), 16
   batch requests (priority 2) at once and, at steps 24, 104 and 184, a
   wave of 4 interactive ones (priority 0, 256 + 64): with
   ``preempt=True`` and a 4e9 B host spill arena (its bytes in the
   engine's spill store) at least one batch request is preempted,
   spilled and resumed; every spill must land in the store; every
   victim's restored blocks must be bit-equal to its host copy and to
   its blocks before the spill (all four leaves, its ``pos`` rows), its
   prefill chunks unchanged and its tokens equal to the same schedule's
   with ``preempt=False``; every request within the bf16 oracle's
   bounds, the spill arena drained, one capture a lane,
   ``step_graph_replay`` bit-equal after the resumes. Printed: the
   interactive TTFT of both runs, each step's host ms (spill steps
   beside decode-only steps), the never-preempted batch TPOT of both
   runs, spill and resume ms, and each spill's parts timed apart
   (gather, fresh pinned allocation, D2H copy, cached allocation).
   ``llama_evict_resume``: a decoding request evicted from one engine
   (``evict_request``) resumes on another (``submit(resume=)``) with no
   prefill and the undisturbed run's tokens; its spill's parts timed.
   ``llama_spec``: the llama_engine's settings with ``spec_depth=4`` and
   the n-gram draftsman (n-grams up to 3) against the same engine
   without speculation, 16 greedy requests of 512 + 128 tokens, half of
   them a 32-token pattern repeated (``spec_prompts``): each lane
   captured once, exactly one #1 launch a layer per decode (verify)
   replay, every request of both runs within the bf16 oracle's bounds; tokens a
   slot-step, acceptance rate, TPOT, tokens/s, decode-step host ms and a
   replay's device ms against spec-off. Then the acceptance sweep
   (``ReplayDrafts``: the spec-off run's tokens as drafts, flipped at 1.0,
   0.55 and 0.0): with clean drafts no draft the oracle prefers to the
   engine's token by ``SPEC_CLEAN_GAP`` is rejected; and the lane's own
   tokens replayed clean are all accepted, no token changed (the check
   that fails a verify rule which rejects too much). Then
   ``llama_spec_profile``
   (steady verify decode: #1 under the tile symbols), both engines' step
   splits, and one preemption with speculation (``llama_spec_preempt``:
   4 slots, 129 blocks, 3 batch requests, an interactive arrival that
   finds too few blocks) whose victim's tokens must equal the same
   schedule's without preemption. ``llama_spec_sampled``: the n-gram
   draftsman at T = 0.7 (per-request seeds), twice: residual resamples
   happen, the replay is bit-equal, every token lies in the vocabulary.
14. llama_tenancy -- the llama_engine's model and settings with
   ``tenancy=TenantPlane(max_adapters=4, r=16)`` (a 0.64 GB fp32
   adapter arena, exactly ``engine.memory.size_adapter_arena``) and two
   seeded adapters (``acme/fr``, ``beta/de``: every projection, r 16,
   alpha 32, B ~ N(0, 0.02)). Base-only traffic on it must be bit-equal
   to a tenancy-off engine's (tokens, first-token logits, the whole KV
   arena). The main path (counters zeroed just before, read just after;
   launches as in ``llama_engine``): ``llama_workload``'s 48 requests in
   base / acme / beta thirds, then its 16 shared-prompt requests (the
   first of each tenant alone): every request within the bf16 oracle's
   bounds, the oracle carrying the request's adapter alone as a one-page
   arena built from its host factors (``lora_arena``); each tenant's
   shared requests hit its own cached system prompt, whose first block is
   cached once a tenant; the share of steps where the adapter moves the
   oracle's choice printed (> 0); the first request of each tenant also
   within the bounds of the oracle run on the serving model wrapped in
   ``peft.LoraLinear`` with that tenant's factors (``wrap_lora``: the
   delta computed with no arena and no ``lora_apply``). Then churn (a hot-swap of acme with A
   x 1.5 under live traffic, a third adapter that evicts the LRU idle
   page, ``evict_adapter``: requests before and after the swap within
   the oracle under their versions, one capture a lane), a tenant capped
   at 4 slots (never more), two planted faults (an acme request served
   from another adapter's page, or from the base page) that must fail
   the bounds, ``llama_tenancy_profile`` (steady decode), the BGMV ops'
   device ms (``bgmv_ms``), and ``hbm_budget_bytes=40e9`` with tenancy:
   the ledger's slots after the arena's bytes.
14b. llama_server -- the llama_engine's model behind ``ServingServer``
   at ``llama_engine``'s settings, the engine built under ``BF16_FULL``
   and the server started from the main thread (the loop steps under the
   lanes' policy): the 48 burst prompts in the three client modes, every
   request within the bf16 oracle (0.5 / 1.0), #1 exactly once a layer
   a lane replay, one capture a lane; latencies as in 4b. Then
   ``llama_server_swap``: ``swap_params`` to a seed-1 init of the same
   config (bf16) refused while a request is in flight (every weight's
   checksum kept); drained, the swap (its ms and flushed prefix blocks,
   at least 1) and 8 shared-prompt requests of 16 tokens within the bf16
   oracle on the new weights, each unlike its pre-swap tokens; the swap
   back (version 2) gives the tokens of those 8, served one at a time
   before the first swap and after this one, bit for bit. One capture a
   lane throughout.
14c. llama_w8a8 -- the llama_engine's model and settings with
   ``w8a8="on"``: every layer's decode-lane FFN through its W8A8 lane
   (``torch._int_mm``) against a tree quantized once (its bytes
   printed); the prefill lane stays bf16. The 64-request workload with
   #1 and #2 as in llama_engine, one capture a lane; every request
   within 0.5 first-token |dlogit| and ``TIE_W8A8`` shortfall of the
   dense oracle teacher-forced under the same W8A8 decode (its own
   tree), the shared batch read against the bf16 oracle with no bound,
   and the oracle's own noise (two chunkings) in bf16 and W8A8; TPOT,
   tokens/s and one decode replay's device ms beside llama_engine's;
   a replay's profile must show the int8 GEMM kernels (found by
   profiling ``torch._int_mm`` alone at the lane's shapes) 32 times
   their per-layer launches. ``llama_w8a8_swap``: a swap to a seed-1
   init whose re-quantize is skipped (a stale tree) must fail the W8A8
   oracle of the new weights; the real swap re-quantizes into the same
   tensors and holds it, every request changed; the swap back restores
   the tree and the first tokens bit for bit (each swap's ms).
   ``llama_w8a8_spec``: the same with ``spec_depth=4`` on
   ``spec_prompts`` at 64 new tokens (the verify lane's 80 rows), within
   the W8A8 oracle.
15. llama_lora -- ``llama_lora_train_oracle``: one fp32 step of a
   LoRA-injected Llama-7B-width model (1 layer, random nonzero B), base
   frozen, kernels on the card against the CPU: ``train_oracle``'s
   bounds on every adapter grad, no base grad. ``llama_lora_sft``:
   ``llama_7b`` uncut (32 layers, fp32 weights from a seed) with LoRA r
   16 / alpha 32 on every projection (40 M params) through
   ``SFTTrainer.fit`` under ``masked(chain(clip_by_global_norm(1.0),
   adamw(1e-4)), lora_trainable_mask)``, bf16 compute, selective remat,
   ``SFT_PAIRS`` at seq 2048, batch 2 (4 does not fit); its eager body
   once, then 3 warm-up and 10 timed steps: the loss falls, every base param keeps
   its bits, the optimizer holds the adapters alone, 32 launches a step
   of each flash kernel; then ``merge_lora`` loaded into the plain
   module tree: its fp32 last-position logits within ``TOL[fp32]`` times
   the largest |logit| of the adapter forward's (the bf16 forwards'
   distances printed).
16. llama_engine_oracle_fp32 -- the same engine and workload at fp32,
   full width and 2 layers, all 64 requests against the same oracle:
   from an fp32 arena under the 1e-4 rule, then from the int8 arena
   under ``DLOGIT_INT8_FP32``/``TIE_INT8_FP32`` (int8 codes amplify
   last-bit differences), printed beside the oracle's own int8 noise
   (its prompt in 256-token chunks against one pass), and the planted
   faults, which those bounds must fail; each engine's lanes captured
   once, and ``step_graph_replay`` on the fp32 arena.
17. llama_train_oracle -- one fp32 step of ``LlamaConfig.llama_7b``'s
   width at 1 layer (vocab 32,000), kernels on the card against the
   plain path on the CPU, on one packed row of 256 tokens holding three
   documents (positions restart at each): the bounds of ``train_oracle``
   and exactly one launch of each flash kernel.
18. llama_train -- the repo's Llama training benchmark
   (``workloads/bench_suite.py:139-167``, config 3), its measured half:
   Llama-7B width at 2 layers, seq 2048, batch 4, ``Strategy(remat=
   "selective", unroll=True)``, ``adamw(1e-4)``, through
   ``Trainer.train`` with ``precision="bf16"`` over the first batch of
   ``build_data_loader(SyntheticLMDataset(32000, seed=0),
   seq_len=2048, batch_rows=4, pack=True)``, repeated: 3 warm-up and 10
   timed steps. The loss must fall; launches exactly 2 a step of each
   flash kernel (counters zeroed just before the timed steps). Step ms,
   tokens/s, MFU against 989 TFLOP/s, peak memory.
19. llama_train_profile -- 3 steps under ``torch.profiler``: device ms a
   step by class (``TRAIN_CLASSES``: the kernels, matmul, AdamW's
   ``_foreach_*``, casts/copies, norms, the grad norm, other reductions,
   index/scatter, fill, elementwise), the idle share, and ``lane`` lines
   that put #2-#4 under their tensor-core symbols.
20. llama_train kernels -- #2-#4 at the batch that ran ((4, 32, 2048,
   128) bf16, causal, its packed segment ids), with and without dropout
   0.1, against their plain versions (2e-2) and rerun bit-equal; then
   timed as in ``train_kernels``, with the bound from the batch's live
   (q, k) pairs and SDPA (``is_causal``: forward, backward, both) as the
   library yardstick.
21. llama_sft -- ``SFTTrainer.fit`` from ``llama_train``'s weights with
   ``resid_pdrop=0.1`` and ``chain(clip_by_global_norm(1.0), adamw(5e-4,
   weight_decay=0.01))`` (``examples/sft.py``), 10 steps over four
   (prompt, response) pairs of 128-512 / 128-1,536 tokens, repeated, at
   seq 2048, batch 4, ``shuffle=False``: the response-only loss must
   fall, launches exactly 2 a step; the grad norms before the clip.
22. llama_train_fused_oracle -- ``llama_train_oracle`` under
   ``HETU_LM_LOSS_IMPL=fused``: the LM head (fp32 h, E 4,096) on #5-#7's
   wide CUDA-core lane; the same bounds, exactly one launch of each flash
   and each fused kernel.
23. llama_train_fused -- ``llama_train`` under ``HETU_LM_LOSS_IMPL=fused``:
   the LM head through #5-#7 on the wide tensor-core lane (bf16 h, E
   4,096, V 32,000; the fp32 head weight cast once for each), 3 warm-up
   and 10 timed steps: the loss falls, exactly 10 launches of each fused
   kernel and 10 L of each flash kernel; step ms, tokens/s, MFU and peak
   memory beside ``llama_train``'s; then ``llama_train_fused_profile``
   (as ``llama_train_profile``; #5-#7 under their wide tensor-core
   symbols).
24. llama fused times -- #5-#7 at the Llama training shape (N 8,192, V
   32,000, E 4,096, bf16), against their plain versions (rerun
   bit-equal; the draw's softmax is peaky, where two fp32 orders round P
   apart, so dH and dW must be no farther than the plain versions from a
   float64 evaluation, in ``fused_grad_bound`` units), then timed as in
   10, with ``gemm_ms``, the chunked loss (forward; forward and
   backward) and the bound (2NVE, 4NVE on 989 TFLOP/s); #5's line
   carries its cluster plan.
25. llama_ckpt -- ``llama_train_fused``'s configuration: 10 steps without
   a stop, against 5 steps with ``TrainerConfig(ckpt_dir=<a temporary
   directory>, ckpt_every=5, async_ckpt=True)`` and 5 more in a new model
   and Trainer after ``resume``: steps 6-10's losses and the final
   params, moments and counts bit-equal; launches exactly 20 of each
   fused kernel and 20 L of each flash kernel; the free disk, bytes
   written, the save's blocking, write and load seconds (2 layers need
   about 8 GB; with under 12 GB free it runs at 1 layer and says so); the
   directory removed.
   llama_train_buckets -- ragged pretraining through ``Trainer(
   seq_buckets=(512, 1024, 2048))`` at Llama-7B width, 2 layers: 12
   batches of 4 rows, real lengths from a seed over 100-2,048 (every
   bucket hit), twice: 3 ``train_step`` captures, then none; every step
   bit-equal to the eager body on a twin; the bucket stats, each
   bucket's step ms, tokens/s and pool bytes (the three buckets' graphs
   share one pool), the batches padded to 2,048 through one entry, and
   the reserved bytes before, after training and after
   ``Trainer.close()`` (which must give back at least 0.9 of the pool).
   llama_train_telemetry -- the same Trainer with telemetry, the
   watchdog, SLO rules and ``peak_flops``, over the same batches twice
   with one save between: losses bit-equal to llama_train_buckets',
   captures 3 then 0, ``compile`` seconds in the first pass only, one
   ``data_bucket_compiles_total`` a bucket, the ``data_*`` token series
   equal to the bucketer's stats, the goodput MFU within 1% of this
   script's own from the same tokens/s, one checkpoint write observed,
   the artifacts parsed, and a captured step sync-free with telemetry
   on. llama_grad_accum -- four ``grad_step``s and
   one ``apply_step`` against ``num_microbatches=4`` on one batch: the
   params bit-equal (else within 1e-6 of the largest change), and
   ``init_acc(like=)`` moving no allocated byte. llama_train_adafactor --
   10 captured steps of ``adafactor(inverse_sqrt(1e-3))``, each bit-equal
   to the eager body; then an fp16-scaler step with a planted ``inf``
   under ``set_sync_debug_mode("error")``: the scale halves and no param
   moves.
26. moe_train_oracle -- one fp32 step of ``GPTConfig.moe_8e``'s width
   (768, 8 GELU experts of 3072, vocab 50257) at 1 layer with each gate
   (topk, ktop1, sam with 2 groups, balance), kernels on the card
   against the plain path on the CPU, at batch 1 x 256. The routing is
   compared first (``RoutingSpy``): tokens routed differently must lie
   within 1e-4 of a routing tie (``nn.moe.routing_margins``; counts
   printed) and leave the step's labels; then ``train_oracle``'s bounds
   and exactly one launch of each flash kernel.
27. moe_train -- BASELINE config 4 (``workloads/bench_suite.py:170-185``):
   ``moe_8e`` cut to 6 layers (280 M params), batch 8, seq 1024, fp32
   params with bf16 compute, ``Strategy(unroll=True)``, ``adamw(1e-4)``,
   through ``Trainer.train(precision="bf16")`` on one random batch
   repeated: 3 warm-up and 10 timed steps. The loss must fall; launches
   exactly 6 a step of each flash kernel. Step ms, tokens/s, MFU on the
   active params (expert tensors at k/E) against 989 TFLOP/s beside the
   Trainer's all-params figure, peak memory, one capture; then
   ``moe_train_profile`` (as ``train_profile``). moe_train_telemetry --
   the same model and batch in a Trainer of its own with telemetry on
   (3 warm-up and 10 timed steps; the step ms beside moe_train's, no
   bound): one capture, 6 launches a step of each flash kernel, a
   captured step sync-free, ``moe_aux_loss`` and
   ``moe_overflow_fraction`` one observation a layer and step, and after
   one more step ``moe_expert_tokens`` equal to a host count of layer
   0's routing (the last a train step emits: its backward runs the
   layers in reverse, as ``hetu_tpu``'s does).
28. moe_engine -- ``moe_8e`` uncut (12 layers, fp32) served by
   ``ServingEngine(slots=16, max_len=512, prefill_chunk=64,
   block_size=16)``: the GPT-2 engine's workload at half its requests
   (24, then 8 sharing a 128-token prompt), both lanes through
   ``MoEMLP.decode``. Launches of #1 and #2 as in ``engine``, each lane
   captured once, greedy tokens equal to ``generate`` (a divergence only
   at a top-2 gap under 1e-4), the teacher-forced decode logits and the
   first-token logits within 1e-4 of the plain forward (routing compared
   first, as in 26), ``step_graph_replay`` bit-equal; tokens/s and TTFT;
   ``moe_engine_profile`` and ``moe_engine_decode_profile`` (a mixed and
   a steady-decode window, as ``engine``'s: the gathers show as
   index/scatter).
28b. moe_w8a8 -- ``moe_8e`` (fp32) at moe_engine's settings from the
   int8 arena with ``w8a8="on"`` (each expert projection one int32
   product over all 8 experts): 12 + 4 requests of 32 tokens, #1 and #2
   as in moe_engine, one capture a lane, the int8 GEMM kernels in a
   replay's profile; held to the teacher-forced W8A8 decode, routing
   first (a step whose row the oracle routed within 1e-4 of a tie is
   not compared): first-token |dlogit| <= 0.05 and at least 0.7 of the
   steps the oracle's best token; one layer's ``wo`` codes rolled by
   one expert must fail them; one decode replay's device ms against the
   same engine with W8A8 off.
29. gpt2_spec -- GPT-2 small (fp32) drafting for itself
   (``draft_model=`` the target) at ``engine``'s settings with
   ``spec_depth=4``, 16 requests of 16-128 + 64 tokens: the draft step
   (``serving_draft_step``) and each lane captured exactly once; exactly
   12 #1 launches per decode and prefill replay and 48 per draft step,
   12 #2 per prefill replay; greedy tokens equal ``generate`` but at a
   near tie, acceptance above 0.8; at T = 0.7 and 1.0 (per-request
   seeds) more than one token a slot-step and the swapped arrival order
   token-identical. Each reading prints the share of slot-steps that
   drafted (the draft model has no prefill lane: a slot drafts only
   after a catch-up of about P / (K + 1) steps). Then
   ``gpt2_spec_engine_prompts``: the same engine, greedy, on the first
   16 of ``engine``'s own burst prompts (4-448 tokens), equal to
   ``generate`` but at a near tie, with its drafting share.
30. gpt2_spec_small_draft -- the same engine with ``draft_model=`` a
   2-layer GPT at GPT-2 small's width from another seed and a larger
   vocabulary (50,304): launches of #1 exactly 12 a lane replay plus 8 a
   draft step; greedy tokens equal ``generate`` but at a near tie; at T
   = 1.0 residual resamples happen, two seeded runs are bit-equal and
   every token lies in the target's vocabulary.
31. gpt2_tenancy -- GPT-2 small at ``engine``'s settings with an
   attention-only adapter (``q_proj|v_proj``, r 4, alpha 8) made with
   ``peft``: 16 mixed requests, launches as in ``engine``, one capture a
   lane; adapter requests equal ``generate`` under the ``merge_lora``
   weights, base requests under the plain ones (ties < 1e-4).
32. summary -- one ``{"kernels": [...]}`` line (each kernel with its
   lanes and its launches by path), the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

Any failure exits nonzero before the ``ok`` line. Without a CUDA device,
or without the ``hetu_tpu_torch`` package beside this file, it exits
nonzero at once.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
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
#: fp32-exact products on the tensor cores: 3xTF32 takes three TF32
#: products (495 TFLOP/s dense) for each
TF32X3_FLOPS = 495e12 / 3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SEED = 0
L2_FLUSH_BYTES = 256 << 20
#: calls in the profile window a flash case's lane and device time are
#: read from
PROFILE_ITERS = 5
#: cycles of ``torch.cuda._sleep`` a covered timing puts after the L2
#: flush (about 0.5 ms): the card is still busy when the host has enqueued
#: the timed call, so the events hold its device time alone. Uncovered, a
#: call whose host enqueue outlasts the flush reads the host's time (the
#: 3xTF32 forward: 0.0453 ms against 0.0059 on the device)
COVER_CYCLES = 1_000_000
C = 64                             # the engine's prefill chunk
#: one packed prefill chunk as the engine builds it: (slot, tokens, chunk
#: start) per request run -- a third chunk of a long prompt, a new prompt,
#: a second chunk -- then 5 pad tokens (segment -1)
PACK = ((3, 20, 128), (7, 9, 0), (0, 30, 64))
TRAIN_SEQ = 1024
# bench.py main()'s batch ladder and its fused-CE combo's (bench.py:159):
# the first rung fits (every run since the first), and a captured step is
# never retried, so the phases run it alone
LADDER = (32, 16, 8)
FUSED_LADDER = (48, 32, 16)
DROP_SEED = 1234
FUSED = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_LANES = ("tensor_core (bf16, d 64/128); tensor_core_f32 (the fp32 "
               "forward at d 64/128: 3xTF32); cuda_core (the rest)")


START = time.perf_counter()


class SmokeFailure(RuntimeError):
    pass


def emit(**obj) -> None:
    """Print one phase record, stamped with the seconds since start (``at``)."""
    obj.setdefault("at", round(time.perf_counter() - START, 1))
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

    def __call__(self, fn, iters: int = 30, warmup: int = 3,
                 cover: bool = False) -> float:
        """With ``cover``, a spin kernel of ``COVER_CYCLES`` follows each
        flush, so the host's enqueue of ``fn`` is not timed."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            if cover:
                torch.cuda._sleep(COVER_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    def profile(self, fn, iters: int = 10, counts=None, expect=()) -> dict:
        """Device ms by kernel name over ``iters`` calls of ``fn``, each
        after the L2 flush, from ``torch.profiler`` (CPU and CUDA
        activity, as the step profiles, which have read every kernel in
        every run; a CUDA-only window of a few short launches late in the
        script once recorded none); ``counts``, if given, receives the
        launches recorded by name. Late in the script a window of short
        launches has also recorded no launch of ``fn``'s kernels at all:
        a window that recorded no kernel whose name holds one of the
        ``expect`` substrings is profiled again, up to three windows in
        all (each retry printed); the caller's checks read the last."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        windows = 3
        for window in range(windows):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            got: dict[str, int] = {}
            by_name = device_kernel_ms(prof, got)[0]
            missing = [key for key in expect
                       if not any(key in n for n in got)]
            if not missing:
                break
            emit(phase="profile_retry", missing=missing, window=window + 1,
                 of=windows)
        if counts is not None:
            counts.update(got)
        return by_name

    def device_ms(self, fn, iters: int = PROFILE_ITERS,
                  expect=()) -> float:
        """Device ms a call of ``fn``, which launches each of its kernels
        once: the sum over the kernels of a profile window, but the
        flush's fill, of each one's mean over its recorded launches (a
        window has recorded as few as one launch of five, and none:
        ``expect`` as in ``profile``)."""
        counts: dict[str, int] = {}
        by_name = self.profile(fn, iters, counts, expect)
        return sum(t / counts[n] for n, t in by_name.items()
                   if "FillFunctor<unsigned char>" not in n)

    def per_kernel(self, fn, keys, iters: int = 10) -> tuple[dict, dict]:
        """Mean device ms per launch of each kernel whose name contains
        one of ``keys`` (for a function that launches several kernels),
        and the launches of each the profiler recorded. The mean is over
        the recorded launches: a profile late in a long process has
        recorded as few as 4 of 10."""
        counts: dict[str, int] = {}
        by_name = self.profile(fn, iters, counts, expect=keys)
        seen = {key: sum(c for n, c in counts.items() if key in n)
                for key in keys}
        check(all(seen.values()),
              f"profiler saw no launch of {keys}: {seen}")
        ms = {key: sum(t for n, t in by_name.items() if key in n) / seen[key]
              for key in keys}
        return ms, seen


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


# -- kernel cases ------------------------------------------------------------

def ptxas_entries(log: str) -> dict:
    """``{mangled kernel: {"registers", "spill_stores", "spill_loads",
    "stack"}}`` from an ``nvcc -Xptxas -v`` log."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def check_ptxas(built) -> dict:
    """Registers and spills of the tensor-core flash instances, the fp32
    forward's 3xTF32 ones included; the d 64 ones (the training path's and
    GPT-2's serving path's) must not spill. Then those of every
    instance of the paged kernel's lanes (``ptxas_paged``), each of which
    must be in the report, and of the fused CE kernels (``ptxas_fused``):
    the tensor-core instances of #5-#7, narrow and wide, must be there and
    must not spill; the CUDA-core ones, narrow and wide, are printed."""
    syms = [LANE_SYMBOLS[k]["tensor_core"] for k in FLASH] \
        + [LANE_SYMBOLS["flash_fwd"]["tensor_core_f32"]]
    found = {}
    for src in ("flash_fwd", "flash_bwd"):
        for name, e in ptxas_entries(built[src]["ptxas"]).items():
            for sym in syms:
                for d in (64, 128):
                    if f"{sym}ILi{d}E" in name:
                        found[f"{sym}<{d}>"] = e
    emit(phase="ptxas", kernels=found)
    check(len(found) == 2 * len(syms),
          f"ptxas report lacks a tensor-core instance: {sorted(found)}")
    for key, e in found.items():
        if key.endswith("<64>"):
            check(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
                  f"{key} spills: {e}")
    paged = {name: e for name, e in
             ptxas_entries(built["paged_attention"]["ptxas"]).items()
             if "paged_" in name}
    emit(phase="ptxas_paged", kernels=paged)
    # a mangled template name holds <length><name>I
    seen = {sym: sum(f"{len(sym)}{sym}I" in name for name in paged)
            for sym in PAGED_INSTANCES}
    check(seen == PAGED_INSTANCES, f"ptxas report of the paged lanes: "
                                   f"{seen}, expected {PAGED_INSTANCES}")
    fused = ptxas_entries(built["fused_ce"]["ptxas"])
    want = {**FUSED_TC_INSTANCES, **FUSED_WIDE_TC_INSTANCES}
    tc = {key: e for name, e in fused.items()
          for key, piece in want.items() if piece in name}
    emit(phase="ptxas_fused",
         tensor_core={k: e for k, e in tc.items() if "_wide" not in k},
         tensor_core_wide={k: e for k, e in tc.items() if "_wide" in k},
         cuda_core={n: e for n, e in fused.items()
                    if "_tc_" not in n and "_wide_" not in n},
         cuda_core_wide={n: e for n, e in fused.items()
                         if "_tc_" not in n and "_wide_" in n})
    check(sorted(tc) == sorted(want),
          f"ptxas report lacks a fused tensor-core instance: {sorted(tc)}")
    for key, e in tc.items():
        check(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
              f"{key} spills: {e}")
    found.update(tc)
    return found

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


def run_shared(tbl, owners):
    """The run-shared form of per-row tables ``tbl`` whose row i is the
    table of ``owners[i]``: one table row per owner, in order of first
    use, and each q slot's index into them (``row_slot``)."""
    first = {}
    for i, o in enumerate(owners):
        first.setdefault(o, i)
    index = {o: n for n, o in enumerate(first)}
    rows = torch.tensor(list(first.values()), device=tbl.device)
    return (tbl.index_select(0, rows).contiguous(),
            torch.tensor([index[o] for o in owners], dtype=torch.int32,
                         device=tbl.device))


def paged_call(ops, q, k, v, tbl, off, shared, **kw):
    """The paged kernel on per-row tables ``tbl``, or, with ``shared``
    (the rows' owners), on their run-shared form: ``row_slot`` into one
    table row per owner. Its plain version computes the same function
    from ``tbl`` either way."""
    if shared is None:
        return ops.paged_attention(q, k, v, tbl, off, **kw)
    tables, row_slot = run_shared(tbl, shared)
    return ops.paged_attention(q, k, v, tables, off, row_slot=row_slot, **kw)


def paged_profile(timer, name, fn, lane) -> float:
    """Check from a profile of ``fn`` (one paged call) that #1's device
    time lies under ``lane``'s symbols (a ``lane`` line), and return its
    device ms per call: the time of every #1 kernel over the launches of
    the lane's main kernel the profiler recorded (the split-KV combine
    rides with its split). Beside the CUDA events' time, which also
    counts the wrapper's host time where that is longer."""
    counts: dict[str, int] = {}
    by_name = timer.profile(fn, counts=counts, expect=("paged_",))
    ms = check_lane(name, by_name, lane, kernels=("paged_attention",))
    calls = sum(c for n, c in counts.items()
                if "paged_" in n and "combine" not in n)
    check(calls > 0, f"{name}: the profiler recorded no paged launch")
    return sum(ms["paged_attention"].values()) / calls


def check_rerun(name, got, again, kernel="paged"):
    """A second call on the same inputs must give the same bits."""
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    check(same, f"{kernel} {name}: a rerun differs")
    return same


def paged_work(q, k, tables, off, int8=False):
    """Bytes and flops the paged call needs on these inputs: every arena
    row some slot attends read once (slots that share pages share the
    read; with ``int8`` also its two fp32 scales per kv head), q read and
    out/lse written once; 4 flops per (row, key, head, column) for q.k
    and p.v."""
    S, R, hq, d = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    item = q.element_size()
    row_bytes = hkv * d * k.element_size() + (hkv * 4 if int8 else 0)
    W = tables.shape[1]
    tables, off = tables.long().cpu(), off.long().cpu()
    pos = torch.arange(W * bs)
    seen = pos[None, :] < (off[:, None] + R)               # (S, W*bs)
    rows = tables[:, pos // bs] * bs + pos % bs
    kv_rows = int(torch.unique(rows[seen]).numel())
    nbytes = (2 * kv_rows * row_bytes + 2 * q.numel() * item
              + S * hq * R * 4 + tables.numel() * 4 + S * 4)
    keys = (off[:, None] + 1 + torch.arange(R)[None, :]).clamp(0, W * bs)
    return nbytes, 4.0 * int(keys.sum()) * hq * d


def flash_case(gens, device, dtype, *, b, hq, hkv, s, d, seg, sk=None):
    """q (b, hq, s, d), k/v (b, hkv, sk or s, d), segment ids (b, s) for
    q and kv alike, or None."""
    gen = gens.device
    sk = s if sk is None else sk
    q = torch.randn(b, hq, s, d, generator=gen, device=device).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(dtype)
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
    no key must be exactly 0. ``max_abs_ref`` beside each error: the bf16
    bound is less than one ulp above |x| = 4."""
    torch.cuda.synchronize()
    tag = str(dtype).split(".")[1]
    for kernel, parts in (("flash_bwd_dq", (0,)), ("flash_bwd_dkv", (1, 2))):
        err = max(max_err(got[i], want[i]) for i in parts)
        ref = max(float(want[i].float().abs().max()) for i in parts)
        ok = err <= TOL[dtype]
        emit(phase="kernel", kernel=kernel, case=case, dtype=tag,
             shape=shape, max_abs_err=err, max_abs_ref=ref,
             bound=TOL[dtype], ok=ok)
        check(ok, f"{kernel} {case} {tag}: max abs err {err} > "
                  f"{TOL[dtype]}")
        errs[kernel][dtype] = max(errs[kernel][dtype], err)
    if dead_rows:
        check(bool((got[0][:, :, :dead_rows] == 0).all()),
              f"{name} {case}: dq of rows with no key not 0")


#: the device symbols of the lanes of #2, #3 and #4 (``ops.flash_lane``),
#: of #1 (``ops.paged_lane``: split-KV decode; the run-shared tiles,
#: ``paged_tile_tc_kernel`` on the tensor cores, ``paged_tile_kernel`` on
#: the CUDA cores) and of #5-#7 (``ops.fused_ce_lane``); no symbol of a
#: kernel is a substring of another lane's
LANE_SYMBOLS = {"flash_fwd": {"tensor_core": "flash_fwd_tc_kernel",
                              "tensor_core_f32": "flash_fwd_tf32x3_kernel",
                              "cuda_core": "flash_fwd_kernel"},
                "flash_bwd_dq": {"tensor_core": "flash_bwd_dq_tc_kernel",
                                 "cuda_core": "flash_bwd_dq_kernel"},
                "flash_bwd_dkv": {"tensor_core": "flash_bwd_dkv_tc_kernel",
                                  "cuda_core": "flash_bwd_dkv_kernel"},
                "paged_attention": {"split_kv": "paged_split_kv",
                                    "tile": "paged_tile"},
                **{k: {"tensor_core": f"{k}_tc_kernel",
                       "cuda_core": f"{k}_kernel",
                       "tensor_core_wide": f"{k}_wide_tc_kernel",
                       "cuda_core_wide": f"{k}_wide_kernel"}
                   for k in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")}}
#: the fused CE kernels' lanes (``ops.fused_ce_lane``)
FUSED_LANES = ("tensor_core (bf16 h: forward, dH and dW; dH and dW on a "
               "2-CTA cluster); cuda_core (fp32 h); past E = 768 each "
               "_wide (E in 64-column chunks; the tensor-core forward "
               "splits the vocab across a cluster of 1-8 CTAs that share "
               "a 128-token tile, wgmma fed by TMA, h multicast; the "
               "tensor-core dH and dW split E across a cluster of up to 8 "
               "CTAs that share one logits tile, E-groups past 4,096 "
               "columns; the CUDA-core ones split E into 512-column "
               "blocks on a grid axis)")
#: the tensor-core instances of #5-#7 that ``ptxas`` must report, by a
#: piece of their mangled names (a name in an anonymous namespace ends in
#: E, a template's arguments are I...E; dW's second argument is w's type)
FUSED_TC_INSTANCES = {"fused_ce_fwd_tc_kernel": "22fused_ce_fwd_tc_kernelE",
                      "fused_ce_dh_tc_kernel<2>":
                          "21fused_ce_dh_tc_kernelILi2EE",
                      "fused_ce_dw_tc_kernel<2, bf16>":
                          "21fused_ce_dw_tc_kernelILi2E13__nv_bfloat16EE",
                      "fused_ce_dw_tc_kernel<2, float>":
                          "21fused_ce_dw_tc_kernelILi2EfEE"}
#: the same of the wide tensor-core lane (dW's argument is dw's type)
FUSED_WIDE_TC_INSTANCES = {
    "fused_ce_fwd_wide_tc_kernel": "27fused_ce_fwd_wide_tc_kernelE",
    "fused_ce_dh_wide_tc_kernel": "26fused_ce_dh_wide_tc_kernelE",
    "fused_ce_dw_wide_tc_kernel<bf16>":
        "26fused_ce_dw_wide_tc_kernelI13__nv_bfloat16EE",
    "fused_ce_dw_wide_tc_kernel<float>": "26fused_ce_dw_wide_tc_kernelIfEE"}
#: instances of #1's lanes that ``ptxas`` must report: split-KV for 4
#: (q, arena) type pairs x d 64/128, its combine for 2 q types x d
#: 64/128, the tensor-core tile for bf16 q with a bf16 or int8 arena x d
#: 64/128, the CUDA-core tile for the 4 type pairs
PAGED_INSTANCES = {"paged_split_kv_kernel": 8,
                   "paged_split_kv_combine_kernel": 4,
                   "paged_tile_tc_kernel": 4, "paged_tile_kernel": 4}
PAGED_LANES = ("split_kv (decode: no row_slot, R*g <= 4, d 64/128); "
               "tile (run-shared: tensor cores for bf16 q at d 64/128, "
               "else CUDA cores)")


def check_lane(phase, by_name, lane, kernels=FLASH) -> dict:
    """The device time of each of ``kernels`` in a profile's ``by_name``
    must lie under the symbol of its ``lane`` (or of every lane of a
    tuple, each with some time) and under no other lane's. Returns the
    ms per kernel and lane."""
    lanes = (lane,) if isinstance(lane, str) else tuple(lane)
    ms = {k: {ln: sum(t for n, t in by_name.items() if sym in n)
              for ln, sym in LANE_SYMBOLS[k].items()} for k in kernels}
    ok = all(all(v[ln] > 0 for ln in lanes)
             and sum(v.values()) == sum(v[ln] for ln in lanes)
             for v in ms.values())
    emit(phase="lane", of=phase, expected=lane, device_ms=ms,
         kernel_names_seen=len(by_name), ok=ok)
    check(ok, f"{phase}: device time of {kernels} not all in the {lane} "
              f"lane: {ms}")
    return ms


def hist_rows(pack, chunk):
    """Offsets and table owners of the packed prefill's history rows: one
    row per pack token, reading its request's table up to the request's
    chunk start - 1 (-1: the chunk starts the prompt); pad rows read slot
    0's table at -1."""
    off, slot = [], []
    for s, n, start in pack:
        off += [start - 1] * n
        slot += [s] * n
    return off + [-1] * (chunk - len(off)), slot + [0] * (chunk - len(slot))


def pack_segments(pack, chunk):
    """The pack's segment ids: each request run's slot, -1 on pads."""
    seg = np.full(chunk, -1)
    at = 0
    for slot, n, _ in pack:
        seg[at:at + n] = slot
        at += n
    return seg


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

    # ---- paged attention: split-KV decode (the decode case, and the
    # history in its per-row form) and the run-shared tiles (the history
    # through row_slot, GQA 2 with R = 3) ----
    rng = np.random.default_rng(SEED)
    decode_off = rng.integers(3, 511, 16).tolist()   # 16 slots mid-decode
    hist_off, hist_slot = hist_rows(PACK, C)
    main = dict(R=1, hq=12, hkv=12, d=64, bs=16, W=32, n_blocks=513)
    # (name, case, want lse, run-shared owners or None, lane)
    cases = [
        ("decode", dict(main, offsets=decode_off), False, None, "split_kv"),
        ("prefill_history", dict(main, offsets=hist_off,
                                 row_slot=hist_slot), True, None,
         "split_kv"),
        ("prefill_history_shared", dict(main, offsets=hist_off,
                                        row_slot=hist_slot), True,
         hist_slot, "tile"),
        ("gqa2_R3_empty_rows", dict(R=3, hq=12, hkv=6, d=64, bs=16,
                                    W=8, n_blocks=41,
                                    offsets=[-1, 0, 17, 60, 124]), True,
         None, "tile"),
    ]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timed = {}
    for name, kw, want_lse, shared, lane in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, tbl, off = paged_case(gens, device, dtype, **kw)
            got = paged_call(ops, q, k, v, tbl, off, shared, return_lse=True)
            ref_o, ref_l = ops.paged_attention_reference(q, k, v, tbl, off,
                                                         return_lse=True)
            torch.cuda.synchronize()
            out, lse = got
            err = max(max_err(out, ref_o), max_err(lse, ref_l))
            dead = (off < 0)
            if bool(dead.any()):          # rows at position -1: exact
                check(bool((out[dead][:, 0] == 0).all())
                      and bool((lse[dead][:, :, 0] == ops.NEG_INF).all()),
                      f"paged {name}: empty-history rows not 0/-1e30")
            rerun = None
            if lane == "split_kv":
                rerun = check_rerun(name, got, paged_call(
                    ops, q, k, v, tbl, off, shared, return_lse=True))
            emit(phase="kernel", kernel="paged_attention", case=name,
                 lane=lane, dtype=str(dtype).split(".")[1],
                 shape=list(q.shape), max_abs_err=err, bound=TOL[dtype],
                 rerun_identical=rerun, ok=err <= TOL[dtype])
            check(err <= TOL[dtype], f"paged {name} {dtype}: max abs err "
                                     f"{err} > {TOL[dtype]}")
            errs[dtype] = max(errs[dtype], err)
            if name in ("decode", "prefill_history_shared") \
                    and dtype == torch.float32:
                dev = paged_profile(timer, name, lambda: paged_call(
                    ops, q, k, v, tbl, off, shared), lane)
                t = time_paged(timer, ops, q, k, v, tbl, off, want_lse,
                               shared=shared)
                t["profile_device_ms"] = dev
                emit(phase="kernel_time", kernel="paged_attention",
                     case=name, lane=lane, dtype="float32", **t)
                timed[name] = t
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda", lane=PAGED_LANES,
        source="hetu_tpu_torch/csrc/paged_attention.cu",
        replaces="hetu_tpu/ops/paged_pallas.py:86",
        max_abs_err=errs[torch.float32],
        max_abs_err_bf16=errs[torch.bfloat16], shape="decode",
        **timed["decode"],
        **{f"prefill_history_{k}": v
           for k, v in timed["prefill_history_shared"].items()})

    # ---- flash forward ----
    pack_seg = pack_segments(PACK, C)
    skip_seg = np.repeat(np.arange(4), 64)
    skip_seg[-10:] = -1
    skip2 = np.stack([skip_seg, skip_seg])
    seg200 = np.repeat([0, 1, 2, -1], [70, 90, 25, 15])
    # (name, shape, causal, q_offset, kv_offset, dropout rate); bf16 at d
    # 64 and 128 runs the tensor-core lanes of #2, #3 and #4, fp32 there
    # #2's 3xTF32 lane, everything else the CUDA-core lanes
    # (ops.flash_lane)
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
        # ragged 64-tiles, GQA 4:1, segments with pads
        ("ragged_gqa4_d128_seg", dict(b=1, hq=8, hkv=2, s=200, d=128,
                                      seg=seg200[None]), True, 0, 0, 0.0),
        # a 64-token chunk over a 320-token history
        ("chunk_over_history", dict(b=1, hq=4, hkv=2, s=64, sk=320, d=64,
                                    seg=None), True, 256, 0, 0.0),
        # bf16 at d 96: the CUDA-core lanes (checked from a profile)
        ("cuda_core_d96", dict(b=1, hq=4, hkv=2, s=130, d=96, seg=None),
         True, 0, 0, 0.0),
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
            lane = ops.flash_lane(dtype, q.shape[-1])
            rerun = None
            if dtype == torch.float32:
                # the fp32 lanes from a profile of this case alone; the
                # 3xTF32 lane's rerun must give the same bits
                check_lane(f"{name} fp32", timer.profile(
                    lambda: ops.flash_attention_fwd(q, k, v, seg, seg,
                                                    **args),
                    iters=PROFILE_ITERS,
                    expect=(LANE_SYMBOLS["flash_fwd"][lane],)),
                    lane, kernels=("flash_fwd",))
                if lane == "tensor_core_f32":
                    rerun = check_rerun(name, (out, lse),
                                        ops.flash_attention_fwd(
                                            q, k, v, seg, seg, **args),
                                        "flash_fwd")
            emit(phase="kernel", kernel="flash_fwd", case=name,
                 dtype=str(dtype).split(".")[1], shape=list(q.shape),
                 lane=lane, max_abs_err=err, bound=TOL[dtype],
                 rerun_identical=rerun, ok=err <= TOL[dtype])
            check(err <= TOL[dtype], f"flash {name} {dtype}: max abs err "
                                     f"{err} > {TOL[dtype]}")
            errs[dtype] = max(errs[dtype], err)
            if name == "packed_prefill" and dtype == torch.float32:
                timed = time_flash(timer, ops, q, k, v, seg, scale)
                emit(phase="kernel_time", kernel="flash_fwd", case=name,
                     dtype="float32", **timed)
    results["flash_fwd"] = dict(
        name="flash_fwd", route="cuda", lane=FLASH_LANES,
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
            if name == "cuda_core_d96" and dtype == torch.bfloat16:
                check_lane(name, timer.profile(lambda: (
                    ops.flash_attention_fwd(q, k, v, seg, seg, **args),
                    ops.flash_attention_bwd(q, k, v, seg, seg, out, lse, do,
                                            **args)), expect=("flash_",)),
                    "cuda_core")
    for kernel, line in (("flash_bwd_dq", 355), ("flash_bwd_dkv", 418)):
        results[kernel] = dict(
            name=kernel, route="cuda", lane=FLASH_LANES,
            source="hetu_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"hetu_tpu/ops/flash_pallas.py:{line}",
            max_abs_err=errs[kernel][torch.float32],
            max_abs_err_bf16=errs[kernel][torch.bfloat16])
    return results


def time_paged(timer, ops, q, k, v, tbl, off, want_lse, shared=None,
               **scales):
    """Kernel (on per-row tables ``tbl``, or their run-shared form when
    ``shared`` gives the rows' owners), plain version, library yardstick
    (``gather_block_rows`` of the per-row tables -- and for the int8 lane
    a dequantize to q's dtype -- then SDPA; never called by the port) and
    bound (every distinct live row read once)."""
    import torch.nn.functional as F
    S, R, hq, d = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    W = tbl.shape[1]
    if shared is None:
        ms = timer(lambda: ops.paged_attention(q, k, v, tbl, off,
                                               return_lse=want_lse, **scales))
    else:
        tables, row_slot = run_shared(tbl, shared)
        ms = timer(lambda: ops.paged_attention(
            q, k, v, tables, off, row_slot=row_slot, return_lse=want_lse,
            **scales))
    plain_ms = timer(lambda: ops.paged_attention_reference(
        q, k, v, tbl, off, return_lse=want_lse, **scales))
    kpos = torch.arange(W * bs, device=q.device)
    qpos = off.long()[:, None] + torch.arange(R, device=q.device)[None, :]
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]   # (S,1,R,L)
    g = hq // hkv

    def rows(x, name):
        x = ops.gather_block_rows(x, tbl)
        if scales:
            x = ops.dequantize_int8(x, ops.gather_block_rows(scales[name],
                                                             tbl), q.dtype)
        return x.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), rows(k, "k_scale"), rows(v, "v_scale"),
            attn_mask=mask, enable_gqa=g > 1)

    library_ms = timer(library)
    nbytes, flops = paged_work(q, k, tbl, off, int8=bool(scales))
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops)


def time_flash(timer, ops, q, k, v, seg, scale):
    """#2 at a pack: kernel, plain version and library yardstick (SDPA
    with the same bool mask; never called by the port) by covered CUDA
    events (``Timer`` ``cover``: at these sizes the wrapper's host enqueue
    can outlast the flush), each beside the bound; the kernel's and the
    library's device ms a call from profiles."""
    import torch.nn.functional as F
    mask = flash_mask(seg, q.shape[2], k.shape[2], True, 0, 0, q.device)

    def kernel():
        return ops.flash_attention_fwd(q, k, v, seg, seg, causal=True,
                                       scale=scale)

    def library():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale,
            enable_gqa=q.shape[1] != k.shape[1])

    ms = timer(kernel, cover=True)
    plain_ms = timer(lambda: ops.flash_attention_fwd_reference(
        q, k, v, seg, seg, causal=True, scale=scale), cover=True)
    library_ms = timer(library, cover=True)
    nbytes, flops = flash_work(q, k, seg, True)
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    extra = {}
    if q.dtype == torch.float32:
        # the same bound with the products at 3xTF32's rate, the least
        # time in which the card does fp32-exact products
        extra["bound_3xtf32_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                       flops / TF32X3_FLOPS) * 1e3
    dev = timer.device_ms(kernel, expect=("flash_fwd",))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, **extra, bytes=nbytes,
                flops=flops, profile_device_ms=dev,
                library_device_ms=timer.device_ms(library))


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


def serve(eng, burst, shared, sp):
    """The burst, then the shared-prompt batch (its first request caches
    the system prompt's blocks before the other 15 arrive). Returns the
    requests and the wall times of each part."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, sp) for p in burst]
    steps = eng.run_until_drained()
    torch.cuda.synchronize()
    t_burst = time.perf_counter() - t0
    it_burst = dict(eng.lane_iters)
    t1 = time.perf_counter()
    reqs2 = [eng.submit(shared[0], sp)]
    while reqs2[0].first_token_s is None:
        eng.step()
    reqs2 += [eng.submit(p, sp) for p in shared[1:]]
    eng.run_until_drained()
    torch.cuda.synchronize()
    return dict(reqs=reqs, reqs2=reqs2, steps=steps, t_burst=t_burst,
                it_burst=it_burst, t_shared=time.perf_counter() - t1)


def check_launches(phase, counts, iters, layers, paged="paged_attention"):
    """One launch per layer of ``paged`` (the arena's lane of kernel #1:
    ``paged_attention`` or ``paged_attention_int8``) per decode- and
    prefill-lane iteration, of ``flash_fwd`` per prefill-lane iteration,
    and none of #1's other lane."""
    other = ({"paged_attention", "paged_attention_int8"} - {paged}).pop()
    want = {paged: layers * (iters["decode"] + iters["prefill"]),
            "flash_fwd": layers * iters["prefill"], other: 0}
    emit(phase=phase, counts=counts, lane_iters=iters, expected=want)
    for name, n in want.items():
        check(name == other or counts.get(name, 0) > 0,
              f"{name} never launched on the main path")
        check(counts.get(name, 0) == n,
              f"{phase}: {name}: {counts.get(name, 0)} launches, expected "
              f"{n} ({layers} layers x lane iterations {iters})")


#: ``engine.trace_counts()`` key of each lane's captured step body
TRACE_KEYS = {"decode": "serving_decode", "prefill": "serving_prefill"}


def capture_stats(eng) -> dict:
    """Each lane's capture: seconds, the graph pool's bytes (device memory
    reserved while capturing) and the kernels one replay launches."""
    return {lane: dict(captures=g.captures, seconds=g.capture_seconds,
                       pool_bytes=g.pool_bytes, launches_per_replay=g.launches)
            for lane, g in eng.lanes.items()}


def check_captures(phase, eng, before=None):
    """Each lane of ``eng`` was captured exactly once: request churn
    never re-captures (the card's twin of the JAX engine's re-trace
    audit, ``tests/test_serving.py``). With ``before`` (the counts just
    before ``eng`` was built, no other engine built since), the process
    counters must show those two captures and no other."""
    from hetu_tpu_torch.engine import trace_counts
    own = {lane: g.captures for lane, g in eng.lanes.items()}
    line = dict(phase="captures", of=phase, engine=own)
    ok = own == {"decode": 1, "prefill": 1}
    if before is not None:
        now = trace_counts()
        line["since_built"] = {lane: now.get(k, 0) - before.get(k, 0)
                               for lane, k in TRACE_KEYS.items()}
        ok = ok and line["since_built"] == own
    emit(**line, ok=ok)
    check(ok, f"{phase}: a lane was re-captured: {line}")


def phase_step_graph_replay(eng, config):
    """One replay of each lane against ``run_eager`` of the same body
    from one arena state and one set of operands: three slots decoding
    and a pack whose second chunk finishes its prompt. The kernels, their
    order and the data are the same, so the logits and the whole arena
    must be bit-equal; a difference is a stale or mis-wired buffer. Run
    under the policy the engine was built with (no re-capture)."""
    from hetu_tpu_torch.serving import SamplingParams
    C = eng.prefill_chunk
    sp = SamplingParams(max_tokens=8)
    # fresh prompts: no prefix-cache hit shortens them
    rng = np.random.default_rng(SEED + 11)
    vocab = eng.model.cfg.vocab_size
    reqs = [eng.submit(rng.integers(0, vocab, C // 4).tolist(), sp)
            for _ in range(3)]
    while any(r.first_token_s is None for r in reqs):
        eng.step()
    reqs.append(eng.submit(rng.integers(0, vocab, C + C // 2).tolist(), sp))
    eng.step()                                    # its first chunk
    caches = eng.pool.caches
    with eng._lock, torch.no_grad():
        active, pf = eng._stage_locked()
        check(active.size == 3 and len(pf["fin"]) == 1,
              f"step_graph_replay {config}: staged {active.size} live "
              f"slots and {len(pf['fin'])} finishing rows, not 3 and 1")
        snap = [c.clone() for c in caches]
        eager = [eng.lanes[ln].run_eager()[0] for ln in ("decode", "prefill")]
        arena_eager = [c.clone() for c in caches]
        for c, x in zip(caches, snap):
            c.copy_(x)
        del snap
        replay = [eng.lanes[ln].replay()[0].clone()
                  for ln in ("decode", "prefill")]
        torch.cuda.synchronize()
        logits_equal = {ln: bool(torch.equal(a, b)) for ln, a, b in
                        zip(("decode", "prefill"), eager, replay)}
        arena_equal = all(torch.equal(a, b)
                          for a, b in zip(arena_eager, caches))
        diff = {ln: max_err(a, b) for ln, a, b in
                zip(("decode", "prefill"), eager, replay)}
        del arena_eager
    eng.run_until_drained()
    emit(phase="step_graph_replay", config=config, live_slots=int(active.size),
         pack_tokens=pf["used"], finishing_rows=len(pf["fin"]),
         logits_equal=logits_equal, logits_max_abs_diff=diff,
         arena_equal=arena_equal,
         arena_bytes=sum(c.numel() * c.element_size() for c in caches))
    check(all(r.status == "done" for r in reqs),
          f"step_graph_replay {config}: requests unfinished")
    check(all(logits_equal.values()) and arena_equal,
          f"step_graph_replay {config}: replay differs from eager "
          f"(logits {logits_equal}, arena equal {arena_equal})")


def phase_engine(device, card):
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.small()
    t0 = time.perf_counter()
    model = GPTLMHeadModel(cfg, device=device, seed=SEED).eval()
    burst, shared = workload(cfg.vocab_size)
    sp = SamplingParams(max_tokens=64)

    # warm the allocator and cuBLAS on a throwaway engine, so the timed
    # run measures serving, not first-call set-up
    warm = ServingEngine(model, slots=2, max_len=512, prefill_chunk=64,
                         block_size=16, device=device)
    warm.generate_many([burst[0][:70]], SamplingParams(max_tokens=3))
    del warm
    torch.cuda.synchronize()
    before = trace_counts()
    t1 = time.perf_counter()
    eng = ServingEngine(model, slots=16, max_len=512, prefill_chunk=64,
                        block_size=16, seed=SEED, device=device)
    emit(phase="engine_setup", config="GPTConfig.small", dtype="float32",
         layers=cfg.num_layers, hidden=cfg.hidden_size,
         heads=cfg.num_heads, vocab=cfg.vocab_size, slots=16, max_len=512,
         prefill_chunk=64, block_size=16, kv_blocks=eng.pool.n_blocks,
         arena_bytes=eng.pool.nbytes(), lanes=capture_stats(eng),
         engine_seconds=time.perf_counter() - t1,
         seconds=time.perf_counter() - t0)
    check_captures("engine_setup", eng, before)

    # ---- the main path: counters zeroed just before, read just after --
    reset_launch_counts()
    run = serve(eng, burst, shared, sp)
    counts = launch_counts()
    iters = dict(eng.lane_iters)
    # ------------------------------------------------------------------
    check_captures("engine", eng, before)
    check_launches("engine_launches", counts, iters, cfg.num_layers)
    reqs, reqs2 = run["reqs"], run["reqs2"]
    t_burst, steps, t_shared = run["t_burst"], run["steps"], run["t_shared"]
    it_burst = run["it_burst"]

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

    memo: dict = {}
    generate_oracle("engine_oracle", model, reqs + reqs2, 64, device, memo)
    phase_profile(eng, burst[:16], sp, flash_lane="tensor_core_f32")
    # 96 tokens each, so few requests end inside the window; prompts
    # that leave them room in max_len
    decode_prompts = [p for p in burst if len(p) <= 512 - 96][:16]
    phase_profile(eng, decode_prompts, SamplingParams(max_tokens=96),
                  phase="engine_decode_profile", steady_decode=True)
    phase_step_split(eng, decode_prompts, SamplingParams(max_tokens=96),
                     "engine_decode_step_split")
    phase_step_graph_replay(eng, "GPTConfig.small fp32")
    check_captures("engine_after_profiles", eng, before)
    # ``gpt2_server`` serves the same model and prompts next
    return counts, dict(model=model, perf=perf, oracle=memo)


#: prompts whose decode steps the oracle batches
ORACLE_GROUP = 16


@torch.no_grad()
def oracle_generate(model, prompts, new, device, memo=None, tag="oracle"):
    """Greedy one-shot generation (``generate``'s loop over a dense cache,
    plain attention: no kernel) of ``new`` tokens for each prompt. Each
    prompt prefills alone, into its own row of a shared dense cache (an
    MoE prefill gathers each token's experts: a batch of them would not
    fit); then ``ORACLE_GROUP`` rows of similar length decode together,
    each at its own length under its own causal offset, as ragged
    ``generate(prompt_lens=)`` does. Returns ``{prompt tuple: (tokens,
    top-2 gaps)}`` for every prompt; ``memo`` (a dict) supplies and
    receives them."""
    from hetu_tpu_torch.models import decode, init_kv_caches
    from hetu_tpu_torch.nn.moe import refuse_batch_coupled
    refuse_batch_coupled(model)
    dev = model.device
    memo = {} if memo is None else memo
    todo = sorted({tuple(p) for p in prompts} - memo.keys(), key=len)
    for i in range(0, len(todo), ORACLE_GROUP):
        part = todo[i:i + ORACLE_GROUP]
        caches = init_kv_caches(model, len(part), len(part[-1]) + new)
        rows = []
        for r, p in enumerate(part):
            rows.append(decode(model, torch.tensor([p], device=dev),
                               torch.arange(len(p), device=dev)[None],
                               tuple(c[:, r:r + 1] for c in caches))[0, -1])
        plens = torch.tensor([len(p) for p in part], device=dev)
        mask = torch.ones(len(part), dtype=torch.bool, device=dev)
        seen = [torch.stack(rows)]
        for t in range(new - 1):
            seen.append(decode(model, seen[-1].argmax(-1)[:, None],
                               (plens + t)[:, None], caches,
                               slot_mask=mask)[:, -1])
        logits = torch.stack(seen, dim=1)
        check(bool(torch.isfinite(logits).all()),
              f"{tag}: non-finite oracle logits")
        top2 = torch.topk(logits, 2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1]).cpu()
        toks = logits.argmax(-1).tolist()
        for r, p in enumerate(part):
            memo[p] = (toks[r], gaps[r])
        del caches, seen, logits, top2
    return memo


def generate_oracle(phase, model, reqs, new, device, memo=None):
    """Each request's greedy tokens against one-shot ``generate``
    (``oracle_generate``): equal, or diverging only at a step where the
    oracle's top-2 logit gap is below 1e-4 (a near-tie, printed).
    ``memo`` (a dict) keeps each prompt's oracle tokens and top-2 gaps,
    so a later phase on the same model and prompts reads them instead of
    generating again."""
    t0 = time.perf_counter()
    vocab = model.cfg.vocab_size
    memo = {} if memo is None else memo
    prompts = [tuple(r.prompt.tolist()) for r in reqs]
    hits = sum(p in memo for p in prompts)
    oracle_generate(model, prompts, new, device, memo, tag=phase)
    for r in reqs:
        check(all(0 <= t < vocab for t in r.tokens),
              f"request {r.id}: bad token list")
    near_ties = oracle_divergences(
        phase, [(r.id, p, list(r.tokens), memo)
                for r, p in zip(reqs, prompts)], new)
    emit(phase=phase, requests=len(reqs),
         identical=len(reqs) - len(near_ties),
         near_ties=near_ties, oracle_reused=hits,
         seconds=time.perf_counter() - t0)


def oracle_divergences(phase, rows, new) -> list:
    """``rows``: (request id, prompt, tokens, oracle memo). Each request's
    tokens equal the first ``new`` of its prompt's oracle tokens, but at
    a step where the oracle's top-2 gap is below 1e-4: those near ties
    are returned."""
    near = []
    for rid, prompt, got, memo in rows:
        want, gaps = memo[tuple(prompt)]
        check(len(got) == new, f"{phase}: request {rid}: {len(got)} "
                               f"tokens, expected {new}")
        if got == want[:new]:
            continue
        t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        gap = float(gaps[t])
        near.append(dict(request=rid, step=t, gap=gap))
        check(gap < 1e-4, f"{phase}: request {rid} diverges from generate "
                          f"at step {t} where the oracle's top-2 gap is "
                          f"{gap}")
    return near


def device_kernel_ms(prof, counts=None) -> tuple[dict, int]:
    """Device ms by kernel name, and the number of kernels, in a
    ``torch.profiler`` trace (``counts``, if given, receives the number
    by name). ``record_function`` ranges mirrored on the device timeline
    (``Optimizer.step#...``) are skipped: they span kernels that are
    counted on their own."""
    from torch.autograd import DeviceType
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
    return by_name, n_kernels


#: a serving profile's classes: (piece of a kernel's name, class), the
#: first match wins. Past the kernels and cuBLAS (its split-K reduce and
#: scaling kernels included), the eager ops by their
#: ATen kernels: sampling (argmax; ArgMaxOps before amax's MaxOps),
#: norms (LayerNorm and RMSNorm are plain torch: mean, square, rsqrt),
#: RoPE's concatenation, GELU/SiLU, the int8 quantize (amax, round,
#: clamp, abs), index/scatter (embedding, index_copy_ arena writes,
#: index_select, the tables' gather, RoPE's table lookup), casts and
#: copies, fills, and the elementwise arithmetic the norms, RoPE, SwiGLU,
#: the LSE combine and the quantize share
KERNEL_CLASSES = (("paged_split_kv", "paged_attention"),
                  ("paged_tile", "paged_attention"),
                  ("flash_fwd", "flash_fwd"),
                  ("gemm", "matmul"), ("xmma", "matmul"),
                  ("cutlass", "matmul"), ("cublasLt", "matmul"),
                  ("scal_kernel", "matmul"),
                  ("ArgMax", "argmax/sampling"),
                  ("argmax", "argmax/sampling"),
                  ("softmax", "argmax/sampling"),
                  ("MeanOps", "norms"), ("rsqrt", "norms"),
                  ("pow_tensor_scalar", "norms"),
                  ("layer_norm", "norms"),
                  ("CatArrayBatchedCopy", "rope"),
                  ("gelu", "activations"), ("Gelu", "activations"),
                  ("silu", "activations"), ("Silu", "activations"),
                  ("MaxOps", "int8 quantize"), ("round", "int8 quantize"),
                  ("clamp", "int8 quantize"), ("abs_kernel", "int8 quantize"),
                  ("index", "index/scatter"), ("gather", "index/scatter"),
                  ("scatter", "index/scatter"),
                  ("copy_kernel", "casts/copies"),
                  ("Memcpy", "casts/copies"),
                  ("FillFunctor", "fill"), ("Memset", "fill"),
                  ("Functor", "elementwise arithmetic"),
                  ("where_kernel", "elementwise arithmetic"),
                  ("exp_kernel", "elementwise arithmetic"),
                  ("maximum", "elementwise arithmetic"),
                  ("minimum", "elementwise arithmetic"))


def phase_profile(eng, prompts, sp, n_steps: int = 20,
                  phase: str = "engine_profile", classes=KERNEL_CLASSES,
                  steady_decode: bool = False, decode_lane: str = "split_kv",
                  flash_lane=None):
    """Where an engine iteration's time goes: ``torch.profiler`` over
    ``n_steps`` steady iterations with 16 requests in flight (decode and
    packed prefill mixed; with ``steady_decode``, after every prompt has
    been prefilled: the decode lane alone). Device busy time is the sum
    of kernel durations (one stream: kernels do not overlap); the rest of
    the wall time the card waits on the host. The profiler's own host
    cost inflates the wall time, so ``ms_per_step`` here is an upper
    bound. Kernel #1's device time must lie under ``decode_lane``'s
    symbol where decode-lane iterations ran (split-KV; the tile lane for
    a verify lane of R*g > 4 rows) and under the run-shared tile symbols
    where prefill-lane iterations ran (``lane``), and nowhere else; with
    ``flash_lane``, #2's (the packed prefill's) under that lane's
    symbol."""
    from torch.profiler import ProfilerActivity, profile

    sps = sp if isinstance(sp, (list, tuple)) else [sp] * len(prompts)
    reqs = [eng.submit(p, s) for p, s in zip(prompts, sps)]
    check(not any(r.status == "rejected" for r in reqs),
          f"{phase}: a profiled request was rejected")
    if steady_decode:
        while any(r.first_token_s is None for r in reqs):
            eng.step()
    else:
        for _ in range(4):                   # admissions, first chunks
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
        cls = next((c for key, c in classes if key in name), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms / n_steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    top_other = sorted(((n, ms) for n, ms in by_name.items()
                        if not any(key in n for key, _ in classes)),
                       key=lambda kv: -kv[1])[:6]
    if steady_decode:
        check(lanes["prefill"] == 0 and lanes["decode"] == n_steps,
              f"{phase}: the window was not steady decode: {lanes}")
    else:
        check(lanes["prefill"] > 0 and lanes["decode"] > 0,
              f"{phase}: the window did not mix the lanes: {lanes}")
    paged = check_lane(phase, by_name, tuple(
        ln for ln, it in ((decode_lane, lanes["decode"]),
                          ("tile", lanes["prefill"])) if it),
        kernels=("paged_attention",))["paged_attention"]
    flash = {}
    if flash_lane is not None:
        flash = check_lane(phase, by_name, flash_lane,
                           kernels=("flash_fwd",))["flash_fwd"]
    emit(phase=phase, steps=n_steps, lane_iterations=lanes,
         paged_lane_ms_per_step={ln: ms / n_steps for ln, ms in paged.items()},
         flash_lane_ms_per_step={ln: ms / n_steps for ln, ms in flash.items()},
         ms_per_step=wall_ms / n_steps,
         device_kernels_per_step=n_kernels / n_steps,
         device_busy_ms_per_step=busy_ms / n_steps if busy_ms else None,
         device_idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
         device_ms_per_step_by_class=by_class,
         top_kernels_ms_per_step=[[n[:80], ms / n_steps] for n, ms in top],
         top_other_ms_per_step=[[n[:120], ms / n_steps]
                                for n, ms in top_other])


def phase_step_split(eng, prompts, sp, phase: str, n_steps: int = 20):
    """Where a steady-decode iteration's wall time goes, with no profiler
    on: the host's staging (admission, copy-on-write, the operand
    uploads), the decode lane's replay call (the graph launch), sampling
    (the verify rule: the argmax's ``.cpu()`` that waits for the replay
    to finish, any draws; a model draftsman's step is part of staging)
    and the rest (per-token
    bookkeeping); beside it, one replay of the decode lane on the device
    by CUDA events (its kernels and the gaps between them). The bare
    replays re-run the last staged step, which re-writes the same arena
    rows with the same values."""
    import hetu_tpu_torch.serving.engine as engine_mod
    reqs = [eng.submit(p, sp) for p in prompts]
    while any(r.first_token_s is None for r in reqs):
        eng.step()
    acc = {"stage": 0.0, "replay_call": 0.0, "sample_and_sync": 0.0}

    def timed(fn, key):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[key] += time.perf_counter() - t
        return run

    lane, verify = eng.lanes["decode"], engine_mod.speculative_verify
    eng._stage_locked = timed(eng._stage_locked, "stage")
    lane.replay = timed(lane.replay, "replay_call")
    engine_mod.speculative_verify = timed(verify, "sample_and_sync")
    try:
        torch.cuda.synchronize()
        before = dict(eng.lane_iters)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        wall = time.perf_counter() - t0
    finally:
        del eng._stage_locked, lane.replay
        engine_mod.speculative_verify = verify
    lanes = {k: eng.lane_iters[k] - before[k] for k in before}
    check(lanes == {"decode": n_steps, "prefill": 0},
          f"{phase}: the window was not steady decode: {lanes}")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(10)]
    for start, end in events:
        start.record()
        lane.replay()
        end.record()
    torch.cuda.synchronize()
    replay_ms = sorted(s.elapsed_time(e) for s, e in events)
    eng.run_until_drained()
    check(all(r.status == "done" for r in reqs), f"{phase}: requests did "
                                                 f"not finish")
    host = {k: v / n_steps * 1e3 for k, v in acc.items()}
    host["rest"] = wall / n_steps * 1e3 - sum(host.values())
    split = dict(phase=phase, steps=n_steps, ms_per_step=wall / n_steps
                 * 1e3, host_ms_per_step=host,
                 replay_device_ms_median=replay_ms[5],
                 replay_device_ms_min=replay_ms[0])
    emit(**split)
    return split


# -- training ----------------------------------------------------------------

def train_batch(vocab: int, b: int, device, seed: int = SEED,
                seq: int = TRAIN_SEQ) -> dict:
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, seq + 1)))
    return {"input_ids": ids[:, :-1].to(device),
            "labels": ids[:, 1:].to(device)}


def launches_of(counts, names=FLASH) -> dict:
    return {k: counts.get(k, 0) for k in names}


def release() -> None:
    """Collect, and hand the allocator's free blocks back to the card.
    The step cache needs no clearing: a Trainer releases the entries it
    built (their graphs and pools) when it closes or is collected."""
    gc.collect()
    torch.cuda.empty_cache()


def graph_info(step) -> dict:
    """A captured step's graphs (``build_train_step``'s step, its
    ``TrainStep``): captures and the bytes of their pools."""
    return dict(captures=step.entry.captures, graphs=len(step.entry.graphs),
                pool_bytes=step.entry.pool_bytes)


def trainer_graphs(trainer) -> dict:
    """``{bucket (0: the base entry): {captures, pool_bytes}}`` of a
    trainer's train-step entries."""
    return {str(b): dict(captures=c, pool_bytes=pb)
            for b, (c, pb) in trainer.captures().items()}


def sync_free(phase: str, fn):
    """``fn()``, one eager run of a step body (what its graph captures),
    under ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside
    it raises. Emits ``<phase>_sync_free``; returns ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    out = fn()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit(phase=phase + "_sync_free", sync_debug_mode="error", ok=True)
    return out


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


def hold_step(gpu, cpu, batch, device):
    """One fp32 loss and backward of ``gpu`` with the kernels on the card
    (selective remat) against ``cpu`` on the CPU (plain path, no remat),
    same weights, on ``batch`` (CPU tensors); the launch counters are
    zeroed just before the card's step and read just after. Returns the
    reading; bounds: |loss difference| <= 1e-4; each grad's max abs
    difference <= 1e-3 of its own max |grad| plus 1e-5 of the largest
    grad of the model (sums run in other orders; a grad that is zero in
    exact arithmetic, such as the key bias's, is summation noise on both
    sides). Only trained params (``requires_grad``) are compared; a
    frozen param that got a grad anyway is counted
    (``frozen_with_grad``)."""
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    x, y = batch["input_ids"], batch["labels"]
    rest = {k: v for k, v in batch.items() if k not in ("input_ids",
                                                        "labels")}
    reset_launch_counts()
    loss_gpu = gpu.loss(x.to(device), y.to(device), remat="selective",
                        **{k: v.to(device) for k, v in rest.items()})
    loss_gpu.backward()
    torch.cuda.synchronize()
    counts = launches_of(launch_counts(), FLASH + FUSED)
    loss_cpu = cpu.loss(x, y, **rest)
    loss_cpu.backward()
    loss_gpu, loss_cpu = float(loss_gpu.detach()), float(loss_cpu.detach())
    want = {n: p for n, p in cpu.named_parameters() if p.requires_grad}
    gmax = max(float(p.grad.abs().max()) for p in want.values())
    worst, worst_name = 0.0, None
    frozen = sum(p.grad is not None for m in (gpu, cpu)
                 for p in m.parameters() if not p.requires_grad)
    for name, p in gpu.named_parameters():
        if name not in want:
            continue
        ref = want[name].grad
        err = float((p.grad.cpu() - ref).abs().max())
        bound = 1e-3 * float(ref.abs().max()) + 1e-5 * gmax
        if err / bound > worst:
            worst, worst_name = err / bound, name
    return dict(loss_gpu=loss_gpu, loss_cpu=loss_cpu,
                loss_abs_diff=abs(loss_gpu - loss_cpu),
                worst_grad_err_over_bound=worst, worst_grad=worst_name,
                largest_grad=gmax, compared_grads=len(want),
                frozen_with_grad=frozen, launches=counts)


def check_step_held(phase, reading, want_launches) -> None:
    check(reading["loss_abs_diff"] <= 1e-4,
          f"{phase}: loss differs by {reading['loss_abs_diff']}")
    check(reading["worst_grad_err_over_bound"] <= 1.0,
          f"{phase}: grad {reading['worst_grad']} off by "
          f"{reading['worst_grad_err_over_bound']} x its bound")
    check(reading["frozen_with_grad"] == 0,
          f"{phase}: {reading['frozen_with_grad']} frozen params got a grad")
    check(reading["launches"] == want_launches,
          f"{phase}: launches {reading['launches']}, expected "
          f"{want_launches}")


def cpu_twin(model):
    """A copy of ``model`` on the CPU, its weights taken from ``model``
    (no seeded init on the host)."""
    import copy
    return copy.deepcopy(model).to("cpu")


def train_oracle(cfg, device, fused: bool = False):
    """One fp32 step, kernels on the card against the plain path on the
    CPU (``hold_step``), at batch 1; ``fused``: under
    ``HETU_LM_LOSS_IMPL=fused`` (the caller sets it), with one launch of
    each fused CE kernel expected."""
    from hetu_tpu_torch.models import GPTLMHeadModel
    t0 = time.perf_counter()
    gpu = GPTLMHeadModel(cfg, device=device, seed=SEED + 1)
    cpu = cpu_twin(gpu)
    batch = train_batch(cfg.vocab_size, 1, "cpu", seed=SEED + 1)
    reading = hold_step(gpu, cpu, batch, device)
    phase = "train_fused_oracle" if fused else "train_oracle"
    emit(phase=phase, dtype="float32", batch=1, seq=TRAIN_SEQ, **reading,
         seconds=time.perf_counter() - t0)
    L = cfg.num_layers
    check_step_held(phase, reading, {**{k: L for k in FLASH},
                                     **{k: int(fused) for k in FUSED}})


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
        # the step's static outputs: the next replay overwrites them
        metrics.append({k: v.clone() for k, v in m.items()})
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
    release()

    model = GPTLMHeadModel(cfg, device=device, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    opt = optim.adamw(1e-4, weight_decay=0.01)
    with autocast(BF16_COMPUTE):          # the plan keeps the policy
        plan = make_plan(model, opt, Strategy(remat="selective",
                                              unroll=True), device=device)
        plan_full = make_plan(model, opt, Strategy(remat="full"),
                              device=device)
    b = LADDER[0]
    run = train_rung(model, opt, plan, b, device)
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
         launches=got, expected=want, graphs=graph_info(run["step"]))
    check(all(np.isfinite(run["losses"])), "non-finite training loss")
    check(run["losses"][-1] < run["losses"][0],
          f"loss did not fall: {run['losses']}")
    check(got == want, f"train launches {got}, expected {want} "
                       f"(12 per kernel per step, 10 steps)")
    check(graph_info(run["step"])["captures"] == 1,
          f"train: {graph_info(run['step'])} captures, expected 1")
    run["state"], _ = sync_free("train", lambda: run["step"].body(
        run["state"], run["batch"]))

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


#: a training profile's classes: (piece of a kernel's name, class), the
#: first match wins: the kernels, cuBLAS, then the eager ops by their ATen
#: kernels -- AdamW's multi-tensor ``_foreach_*`` updates, casts and
#: copies, the norms' statistics (mean, square, rsqrt), the grad norm,
#: other reductions (sums in the backward, the CE's log-sum-exp),
#: index/scatter (embedding and its backward, the CE's target gather,
#: RoPE's table lookup), fills, and the elementwise arithmetic (norms,
#: RoPE, activations, dropout, residual adds and their backward)
TRAIN_CLASSES = (("flash_fwd", "flash_fwd"),
                 ("flash_bwd_dq", "flash_bwd_dq"),
                 ("flash_bwd_dkv", "flash_bwd_dkv"),
                 ("fused_ce_fwd", "fused_ce_fwd"),
                 ("fused_ce_dh", "fused_ce_dh"),
                 ("fused_ce_dw", "fused_ce_dw"),
                 ("gemm", "matmul"), ("xmma", "matmul"),
                 ("cutlass", "matmul"), ("nvjet", "matmul"),
                 ("sm90_", "matmul"),
                 ("multi_tensor_apply", "adamw _foreach"),
                 ("copy_kernel", "casts/copies"), ("Memcpy", "casts/copies"),
                 ("CatArrayBatchedCopy", "casts/copies"),
                 ("MeanOps", "norms"), ("rsqrt", "norms"),
                 ("pow_tensor_scalar", "norms"),
                 ("NormTwoOps", "grad norm"),
                 ("reduce_kernel", "other reductions"),
                 ("index", "index/scatter"), ("gather", "index/scatter"),
                 ("scatter", "index/scatter"),
                 ("embedding", "index/scatter"),
                 ("adix", "index/scatter"),
                 ("FillFunctor", "fill"), ("Memset", "fill"),
                 ("elementwise_kernel", "elementwise"))


def phase_train_profile(run, n_steps: int = 3, phase: str = "train_profile",
                        fused_lane: str = "tensor_core"):
    """Where a training step's time goes: ``torch.profiler`` over
    ``n_steps`` steps at the batch that ran. Device busy is the sum of
    kernel times (one stream); the rest of the wall time the card waits
    on the host. The profiler's host cost inflates the wall time. Under
    the fused loss #5-#7 must lie under ``fused_lane``'s symbols."""
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
    lanes = check_lane(phase, by_name, "tensor_core")
    fused = {}
    if os.environ.get("HETU_LM_LOSS_IMPL") == "fused":
        # bf16 h: #5-#7 on the tensor cores (the wide lane past E = 768)
        fused = check_lane(phase, by_name, fused_lane, kernels=FUSED)
    emit(phase=phase, steps=n_steps, batch=run["batch_size"],
         ms_per_step=wall_ms / n_steps,
         device_kernels_per_step=n_kernels / n_steps,
         device_busy_ms_per_step=busy_ms / n_steps,
         device_idle_share=1.0 - busy_ms / wall_ms,
         device_ms_per_step_by_class=by_class,
         flash_lane_ms_per_step={k: {ln: ms / n_steps for ln, ms in v.items()}
                                 for k, v in lanes.items()},
         fused_lane_ms_per_step={k: {ln: ms / n_steps for ln, ms in v.items()}
                                 for k, v in fused.items()},
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
        release()
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
    # the per-kernel profile three times: its spread, and the median
    reps, recorded = [], []
    for _ in range(3):
        f_ms, f_n = timer.per_kernel(fwd, ["flash_fwd_tc_kernel"])
        b_ms, b_n = timer.per_kernel(bwd, ["flash_bwd_dq_tc_kernel",
                                           "flash_bwd_dkv_tc_kernel"])
        reps.append({**f_ms, **b_ms})
        recorded.append({**f_n, **b_n})
    card = nvidia_smi()
    spread = {key: sorted(r[key] for r in reps) for key in reps[0]}
    for key, ms in spread.items():
        emit(phase="kernel_spread", kernel=key, case="train",
             dtype="bfloat16", card=card, ms_min=ms[0], ms_median=ms[1],
             ms_max=ms[2], runs=[r[key] for r in reps],
             launches_recorded=[n[key] for n in recorded], launches=10)
    # CUDA events around whole calls, which no lost profiler record can
    # shorten: the forward is one kernel, the backward (delta given) dq
    # then dk/dv
    delta = (out.float() * do.float()).sum(-1)
    emit(phase="kernel_events", case="train", dtype="bfloat16", card=card,
         fwd_ms=timer(fwd), bwd_ms=timer(lambda: ops.flash_attention_bwd(
             q, k, v, None, None, out, lse, do, delta=delta, **args)),
         profile_fwd_ms=spread["flash_fwd_tc_kernel"][1],
         profile_bwd_ms=spread["flash_bwd_dq_tc_kernel"][1]
         + spread["flash_bwd_dkv_tc_kernel"][1])
    del delta
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
            ("flash_fwd", "flash_fwd_tc_kernel", plain_fwd, lib_fwd, nbytes,
             flops),
            ("flash_bwd_dq", "flash_bwd_dq_tc_kernel", plain_bwd, lib_bwd,
             dq_b, dq_f),
            ("flash_bwd_dkv", "flash_bwd_dkv_tc_kernel", plain_bwd, lib_bwd,
             dkv_b, dkv_f)):
        bound_ms, bound_by = bound(nb, fl, q.dtype)
        t = dict(ms=spread[key][1], ms_spread=spread[key], plain_ms=plain,
                 library_ms=lib, bound_ms=bound_ms, bound_by=bound_by,
                 bytes=nb, flops=fl)
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


def check_fused(case, h, w, got, want, errs, exact=None) -> None:
    """Hold (lse, tgt, dh, dw) against the plain versions' (lse/tgt within
    ``FUSED_TOL_LSE``, dh/dw element by element within
    :func:`fused_grad_bound`) and record the kernels' absolute errors.
    With ``exact`` (``{"fused_ce_dh": ..., "fused_ce_dw": ...}``, from
    :func:`exact_fused_grad`), dh and dw are held to that float64
    evaluation instead: each element's distance from it, in
    :func:`fused_grad_bound` units, within the larger of 1 and the plain
    version's own worst distance."""
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
            if exact is not None:
                # the bound in ulps of the output's dtype, as against r
                xb = fused_grad_bound(exact[kernel], h.dtype)
                x = exact[kernel].float()
                kx, px = ((a.float() - x).abs() / xb for a in (g, r))
                extra.update(worst_vs_plain=worst,
                             over_vs_plain=int(((g.float() - r.float())
                                                .abs() > bnd).sum()),
                             worst_vs_float64=float(kx.max()),
                             over_vs_float64=int((kx > 1).sum()),
                             plain_worst_vs_float64=float(px.max()),
                             plain_over_vs_float64=int((px > 1).sum()))
                worst = float(kx.max()) / max(1.0, float(px.max()))
        ok = worst <= 1.0
        emit(phase="kernel", kernel=kernel, case=case, h_dtype=tags[0],
             w_dtype=tags[1], shape=[h.shape[0], w.shape[0], h.shape[1]],
             max_abs_err=err, worst_err_over_bound=worst, ok=ok, **extra)
        check(ok, f"{kernel} {case} h {tags[0]} w {tags[1]}: max abs err "
                  f"{err}, {worst} of its bound")
        key = "max_abs_err" if h.dtype == out_dtype == torch.float32 \
            else "max_abs_err_bf16"
        errs[kernel][key] = max(errs[kernel][key], err)


def exact_fused_grad(h, w, lab, lse, glse, gtgt, which: str,
                     block: int = 4096) -> torch.Tensor:
    """dh (``which == "dh"``) or dw as the plain versions compute them,
    but in float64: the logits of h and w cast to h's dtype, P = glse
    exp(s - lse) + gtgt onehot rounded to h's dtype (from float64 logits),
    the products summed in float64; out in h's or w's dtype. Under a
    peaky softmax two fp32 evaluations of the logits round a large P
    entry apart, which moves a whole row of dh (a column of dw) by more
    than 2 ulps of its small elements; this is the yardstick both are
    measured against there."""
    h64 = h.double()
    out = torch.zeros(h.shape if which == "dh" else w.shape,
                      dtype=torch.float64, device=h.device)
    for v0 in range(0, w.shape[0], block):
        wb = w[v0:v0 + block].to(h.dtype).double()
        hit = lab.long()[:, None] == (v0 + torch.arange(
            wb.shape[0], device=h.device))[None, :]
        p = glse.double()[:, None] * torch.exp(h64 @ wb.t()
                                               - lse.double()[:, None]) \
            + torch.where(hit, gtgt.double()[:, None], 0.0)
        p = p.to(h.dtype).double()
        if which == "dh":
            out += p @ wb
        else:
            out[v0:v0 + block] = p.t() @ h64
    return out.to(h.dtype if which == "dh" else w.dtype)


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


#: the wide lanes' cases: (case, N, V, E), ragged N and V; the last is
#: the tensor-core forward's cluster case: 63 token tiles, the last of 64
#: rows, take a cluster of C > 1, and V = 800 is 7 vocab tiles of 128
#: (the last ragged), so at C = 2 one CTA's last tile lies past V
WIDE_CASES = (("wide_832", 333, 1013, 832),
              ("wide_4096", 1000, 32003, 4096),
              ("wide_5120", 333, 5003, 5120),
              ("wide_8192", 333, 5003, 8192),
              ("wide_fwd_cluster", 8000, 800, 832))


def phase_fused_kernels(device, ops):
    """Kernels #5-#7 against their plain versions: one draw of h and w,
    each taken in fp32 and in bf16; the GPT-2 vocab, a ragged one and 50
    (fewer than one dW cluster's 64 rows, the last 14 past V); token
    counts that are not a multiple of any token tile, and 5 tokens,
    fewer than one; E = 768 (GPT-2's), 64 (one 64-wide chunk: the dH and
    dW clusters' rank 1 owns none and pushes zero partials) and 192
    (three chunks, split 2 / 1); a label of V - 1 (the last, ragged
    tile's last column); every case with a bf16 operand run again,
    bit-equal (no atomics: the cluster's CTAs sum their partial logits
    in rank order); then the w cast of the bf16-h lane
    (:func:`check_w_cast`). Then the wide lanes (``WIDE_CASES``): E =
    832 (the first width past 768: a 2-CTA cluster of 7 and 6 chunks),
    4,096 (Llama-7B's: 8 CTAs of 8 chunks), 5,120 (Llama-13B's) and 8,192
    (Llama-2-70B's; both past 4,096 columns: two E-groups each computing
    the same logits), ragged N and V; and ``wide_fwd_cluster``, whose
    forward runs on a cluster of C > 1 CTAs (one with a tile past V).
    The wide tensor-core summaries record the plans as the library
    reports them (:func:`wide_plans`): dH's and dW's at each width, the
    forward's at each case's (N, V) and at the Llama shape. Returns the
    summary entries (without times and launches)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    errs = {k: {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0} for k in FUSED}
    for case, n, vocab, e in (("vocab_50257", 333, 50257, 768),
                              ("ragged_vocab_1013", 1000, 1013, 768),
                              ("tokens_5", 5, 50257, 768),
                              ("width_64", 333, 1013, 64),
                              ("width_192", 1000, 50257, 192),
                              ("vocab_50", 333, 50, 768),
                              *WIDE_CASES):
        h32, w32, lab, glse, gtgt = fused_inputs(
            gen, device, n, vocab, torch.float32, torch.float32, e)
        lab[min(3, n - 1)] = vocab - 1
        for h_dtype in (torch.float32, torch.bfloat16):
            h = h32.to(h_dtype)
            for w_dtype in (torch.float32, torch.bfloat16):
                w = w32.to(w_dtype)
                got, want = run_fused(ops, h, w, lab, glse, gtgt)
                check_fused(case, h, w, got, want, errs)
                check(bool((got[1][lab == -1] == 0).all()),
                      f"fused_ce_fwd {case}: tgt of label -1 not 0")
                if torch.bfloat16 in (h_dtype, w_dtype):
                    again = (*ops.fused_ce_fwd(h, w, lab),
                             ops.fused_ce_dh(h, w, lab, want[0], glse, gtgt),
                             ops.fused_ce_dw(h, w, lab, want[0], glse, gtgt))
                    torch.cuda.synchronize()
                    same = check_rerun(case, got, again, kernel="fused_ce")
                    emit(phase="kernel_rerun", kernel="fused_ce", case=case,
                         h_dtype=str(h_dtype).split(".")[1],
                         w_dtype=str(w_dtype).split(".")[1], identical=same)
        check_w_cast(ops, case, h, w32, lab, glse, gtgt)
    results = {}
    for kernel, line in zip(FUSED, (53, 112, 134)):
        results[kernel] = dict(
            name=kernel, route="cuda",
            lane=FUSED_LANES,
            source="hetu_tpu_torch/csrc/fused_ce.cu",
            replaces=f"hetu_tpu/ops/fused_ce_pallas.py:{line}",
            **errs[kernel])
    plans = wide_plans(sorted({e for *_, e in WIDE_CASES}),
                       [(n, v) for _, n, v, _ in WIDE_CASES]
                       + [LLAMA_FUSED_SHAPE[:2]])
    check(plans["fused_ce_fwd"]["8000x800"]["cluster"] > 1,
          f"wide_fwd_cluster: the forward's plan "
          f"{plans['fused_ce_fwd']['8000x800']} takes no cluster")
    for kernel, plan in plans.items():
        results[kernel]["tensor_core_wide_plan"] = plan
    return results


def wide_plans(widths, fwd_shapes) -> dict:
    """The wide tensor-core plans as the built library reports them,
    held to the rules the port states. dH and dW at each width
    (``ops.fused_ce.wide_info``: cluster size, E chunks of the logits a
    CTA sums, E-groups, which is how many times the logits are computed,
    and ``cudaOccupancyMaxActiveClusters``; ``ops.fused_ce.wide_plan``);
    the forward at each (N, V) of ``fwd_shapes``
    (``ops.fused_ce.wide_fwd_info``: cluster size, the CTAs the card
    holds at once in clusters of each size, CTAs launched and those of
    the first wave; ``ops.fused_ce.wide_fwd_plan`` on the card's
    slots)."""
    from hetu_tpu_torch.ops.fused_ce import (
        wide_fwd_info, wide_fwd_plan, wide_info, wide_plan,
    )
    out = {"fused_ce_fwd": {}}
    for n, vocab in fwd_shapes:
        info = wide_fwd_info(n, vocab)
        want = wide_fwd_plan(n, vocab, info["slots"])
        check(info["cluster"] == want and info["cluster"] > 0,
              f"fused_ce_fwd wide plan at N = {n}, V = {vocab}: {info}, "
              f"rule {want}")
        out["fused_ce_fwd"][f"{n}x{vocab}"] = info
    emit(phase="wide_plan", kernel="fused_ce_fwd", plans=out["fused_ce_fwd"])
    for kernel in ("fused_ce_dh", "fused_ce_dw"):
        out[kernel] = {}
        for e in widths:
            info = wide_info(e, kernel[-2:])
            want = dict(zip(("cluster", "slice_chunks", "groups"),
                            wide_plan(e)))
            check({k: info[k] for k in want} == want and
                  info["max_active_clusters"] > 0,
                  f"{kernel} wide plan at E = {e}: {info}, rule {want}")
            out[kernel][str(e)] = dict(info, recompute=info["groups"])
        emit(phase="wide_plan", kernel=kernel, plans=out[kernel])
    return out


def phase_train_fused(device, card):
    """The fused-CE combo: the fused fp32 oracle, then the bf16-param
    step at batch 48, then its profile; ``HETU_LM_LOSS_IMPL=fused``
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
        release()
        model = GPTLMHeadModel(cfg, device=device, seed=SEED)
        n_params = sum(p.numel() for p in model.parameters())
        opt = optim.adamw(1e-4, weight_decay=0.01)
        with autocast(policy):
            plan = make_plan(model, opt, Strategy(remat="selective",
                                                  unroll=True), device=device)
        b = FUSED_LADDER[0]
        run = train_rung(model, opt, plan, b, device)
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
             launches=got, expected=want, graphs=graph_info(run["step"]))
        run["state"], _ = sync_free("train_fused", lambda: run["step"].body(
            run["state"], run["batch"]))
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
    then timed with the plain versions, the port's chunked loss and one
    cuBLAS call for their logits product (``gemm_ms``) beside them."""
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
    release()

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
    # the 2NVE logits product every fused kernel computes in its body, as
    # one cuBLAS call (it also writes the (N, V) fp32 logits)
    gemm_ms = timer(lambda: torch.mm(h, w.t(), out_dtype=torch.float32),
                    iters=3, warmup=1)
    gc.collect()
    release()
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
                 gemm_ms=gemm_ms, bound_ms=bound_ms, bound_by=bound_by,
                 bytes=nbytes, flops=flops)
        emit(phase="kernel_time", kernel=kernel, case="train",
             dtype="bfloat16", shape=[n, vocab, e], **t)
        results[kernel].update(t, shape=f"train_bf16_N{n}")
    emit(phase="kernel_note", note="library_ms of the fused CE kernels is "
         "the port's chunked_lm_loss (cuBLAS bf16 head matmuls plus torch "
         "ops): its forward for fused_ce_fwd, forward and backward for "
         "fused_ce_dh and fused_ce_dw (no single PyTorch call computes "
         "these functions); gemm_ms is one cuBLAS call, torch.mm(h, w.t(), "
         "out_dtype=float32), for the 2NVE logits product in each kernel's "
         "body, writing the (N, V) fp32 logits that the kernels never "
         "write")


# -- Llama-7B served from the int8 KV arena ----------------------------------

#: the Llama engine (ServingEngine(slots=16, max_len=2048,
#: prefill_chunk=256, block_size=16, cache_dtype=int8))
LLAMA_SLOTS, LLAMA_MAX_LEN, LLAMA_CHUNK, LLAMA_BLOCK = 16, 2048, 256, 16
#: the served Llama's depth: 7B, all 32 layers. The phases that serve it
#: (llama_engine through llama_w8a8_spec) and their oracles cost time in
#: proportion to the depth; the teacher-forced oracle batches
#: ``ORACLE_ROWS`` requests a call to keep the script within its limit
LLAMA_SERVE_LAYERS = 32
#: one packed prefill chunk of the Llama engine: (slot, tokens, chunk start)
#: per request run -- a sixth chunk of a long prompt, a new prompt, a
#: second chunk -- then 16 pad tokens
LLAMA_PACK = ((3, 100, 1280), (7, 60, 0), (0, 80, 256))
#: the int8 lane against its plain version: fp32 out and lse (both
#: dequantize and sum in fp32; only the order differs) and the bf16-q lse
INT8_TOL = 1e-5
#: bf16-q out: at most 1 bf16 ulp of the reference value (the final
#: rounding of two fp32 sums taken in different orders) plus this, for
#: values near 0
INT8_BF16_ABS = 1e-5
#: The Llama oracles hold every greedy token of the engine to the dense
#: oracle teacher-forced on the engine's own tokens (``oracle``). A
#: step's SHORTFALL is the oracle's best logit minus its logit of the
#: engine's token: 0 where they agree, the oracle's top-2 gap where the
#: engine took the runner-up. A run passes when its largest first-token
#: |dlogit| is within the DLOGIT bound and its largest shortfall is
#: below the TIE bound. fp32 from an fp32 arena: the GPT-2 engine's
#: near-tie rule, 1e-4, at every step.
TIE_FP32 = 1e-4
#: fp32 from the int8 arena (2 layers) and bf16 from it at full depth
#: (where the engine and the oracle run other cuBLAS kernels, dequantize
#: the history in fp32 and in bf16, and 32 random-weight layers amplify
#: bf16 rounding): each bound lies between the sound run's reading and the smallest
#: reading of a planted fault (``FAULTS``). This script read, on an
#: NVIDIA H100 80GB HBM3 at 700 W: fp32 sound |dlogit| 0.0065 and
#: shortfall 0.0038, faults 2.60 and 2.33 at the least; bf16 sound 0.432
#: and 0.438, faults 6.07 and 5.95 at the least (bf16 at 32 layers; the
#: served model now has 16, whose rounding noise is smaller)
DLOGIT_INT8_FP32 = 0.01
TIE_INT8_FP32 = 0.02
DLOGIT_BF16 = 0.5
TIE_BF16 = 1.0
#: faults planted in the int8 lane's inputs on the engine path (the
#: kernel and the model are untouched) to show that each oracle fails a
#: wrong lane: the k/v scales of the next kv head, and the last block
#: of every query's history dropped
FAULTS = ("scales_of_next_kv_head", "last_history_block_dropped")


def int8_arena(k, v, ops, zero_rows: int = 0, poison: bool = False):
    """Quantize a fp arena into (codes, scales) per (row, kv head), as the
    engine writes it. ``zero_rows``: every ``zero_rows``-th arena row gets
    scale 0 (a never-written row: it must dequantize to exactly 0).
    ``poison``: the null block 0 (only pad lanes map it) gets extreme
    codes and scales, which must stay masked."""
    kq, ks = ops.quantize_int8(k)
    vq, vs = ops.quantize_int8(v)
    if zero_rows:
        for s in (ks, vs):
            s.view(-1, s.shape[2])[::zero_rows] = 0.0
    if poison:
        kq[0], vq[0] = 127, -127
        ks[0], vs[0] = 1e3, 1e3
    return kq, ks, vq, vs


def check_int8(name, q, out, lse, ref_o, ref_l, lane=None):
    """Hold the int8 lane to its plain version: fp32 q within INT8_TOL,
    bf16 q within 1 ulp + INT8_BF16_ABS (out) and INT8_TOL (lse)."""
    torch.cuda.synchronize()
    lse_err = max_err(lse, ref_l)
    if q.dtype == torch.float32:
        err = max(max_err(out, ref_o), lse_err)
        ratio = err / INT8_TOL
        bound_txt = INT8_TOL
    else:
        lim = ulp(ref_o, torch.bfloat16) + INT8_BF16_ABS
        err = max_err(out, ref_o)
        ratio = max(float(((out.float() - ref_o.float()).abs() / lim).max()),
                    lse_err / INT8_TOL)
        bound_txt = "1 bf16 ulp + 1e-5 (out), 1e-5 (lse)"
    tag = str(q.dtype).split(".")[1]
    emit(phase="kernel", kernel="paged_attention_int8", case=name, lane=lane,
         dtype=tag, shape=list(q.shape), max_abs_err=err, lse_err=lse_err,
         bound=bound_txt, worst_share_of_bound=ratio, ok=ratio <= 1.0)
    check(ratio <= 1.0, f"paged int8 {name} {tag}: {ratio} of its bound "
                        f"(max abs err {err}, lse {lse_err})")
    return err


def phase_llama_kernels(device, timer, ops, results):
    """Kernel #1's int8 lane against its plain version at the Llama
    engine's shapes (decode q (16, 1, 32, 128), prefill history q (256,
    1, 32, 128), the (2049, 16, 32, 128) int8 arena) and at edge shapes
    (GQA, R = 3, offsets of -1, zero-scale rows, a poisoned null block),
    q fp32 and bf16; then the d = 128 cases of the fp/bf16 lanes of #1
    and of the flash forward #2 at the packed prefill's shape. Times:
    the int8 lane at the decode timing case (16 slots x 1024 live
    positions) and the prefill history, the bf16 lane at the same decode
    case, the flash forward at the pack in bf16 and in fp32 (case
    ``llama_pack_fp32``, the 3xTF32 lane). Adds the int8 entry to
    ``results`` and the d = 128 times to #1's and #2's."""
    gens = Generators(device, SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    W = LLAMA_MAX_LEN // LLAMA_BLOCK
    n_blocks = 1 + LLAMA_SLOTS * W
    main = dict(R=1, hq=32, hkv=32, d=128, bs=LLAMA_BLOCK, W=W,
                n_blocks=n_blocks)
    hist_off, hist_slot = hist_rows(LLAMA_PACK, LLAMA_CHUNK)
    gpt2 = dict(R=1, hq=12, hkv=12, d=64, bs=16, W=32, n_blocks=513)
    g_off, g_slot = hist_rows(PACK, C)
    history = dict(main, offsets=hist_off, row_slot=hist_slot)
    # (name, case, want lse, arena faults, run-shared owners or None,
    # lane); the last two: the int8 lane at GPT-2's d = 64
    cases = [
        ("decode_1024", dict(main, offsets=[1023] * LLAMA_SLOTS), False,
         dict(), None, "split_kv"),
        ("decode_ragged", dict(main, offsets=rng.integers(
            3, LLAMA_MAX_LEN - 1, LLAMA_SLOTS).tolist()), False,
         dict(zero_rows=97, poison=True), None, "split_kv"),
        ("prefill_history", history, True, dict(), None, "split_kv"),
        ("prefill_history_shared", history, True, dict(), hist_slot,
         "tile"),
        ("gqa4_R3_empty_rows", dict(R=3, hq=32, hkv=8, d=128, bs=16, W=8,
                                    n_blocks=41,
                                    offsets=[-1, 0, 17, 60, 124]), True,
         dict(zero_rows=5, poison=True), None, "tile"),
        ("d64_decode", dict(gpt2, offsets=rng.integers(
            3, 511, 16).tolist()), False, dict(zero_rows=97, poison=True),
         None, "split_kv"),
        ("d64_prefill_history_shared", dict(gpt2, offsets=g_off,
                                            row_slot=g_slot), True, dict(),
         g_slot, "tile"),
    ]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timed = {}
    for name, kw, want_lse, arena_kw, shared, lane in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, tbl, off = paged_case(gens, device, torch.float32, **kw)
            q = q.to(dtype)
            kq, ks, vq, vs = int8_arena(k, v, ops, **arena_kw)
            del k, v
            sc = dict(k_scale=ks, v_scale=vs)
            got = paged_call(ops, q, kq, vq, tbl, off, shared,
                             return_lse=True, **sc)
            ref_o, ref_l = ops.paged_attention_reference(
                q, kq, vq, tbl, off, return_lse=True, **sc)
            out, lse = got
            errs[dtype] = max(errs[dtype], check_int8(
                name, q, out, lse, ref_o, ref_l, lane=lane))
            dead = off < 0
            if bool(dead.any()):
                check(bool((out[dead][:, 0] == 0).all())
                      and bool((lse[dead][:, :, 0] == ops.NEG_INF).all()),
                      f"paged int8 {name}: empty-history rows not 0/-1e30")
            if lane == "split_kv":
                emit(phase="kernel_rerun", kernel="paged_attention_int8",
                     case=name, dtype=str(dtype).split(".")[1],
                     identical=check_rerun(name, got, paged_call(
                         ops, q, kq, vq, tbl, off, shared, return_lse=True,
                         **sc)))
            del got, out, lse, ref_o, ref_l
            if dtype == torch.bfloat16 and name in ("decode_1024",
                                                     "prefill_history_shared"):
                dev = paged_profile(timer, name, lambda: paged_call(
                    ops, q, kq, vq, tbl, off, shared, **sc), lane)
                t = time_paged(timer, ops, q, kq, vq, tbl, off, want_lse,
                               shared=shared, k_scale=ks, v_scale=vs)
                t["profile_device_ms"] = dev
                emit(phase="kernel_time", kernel="paged_attention_int8",
                     case=name, lane=lane, dtype="bfloat16",
                     shape=list(q.shape), **t)
                timed[name] = t
            del q, kq, vq, ks, vs
            gc.collect()
            release()
    results["paged_attention_int8"] = dict(
        name="paged_attention_int8", route="cuda",
        source="hetu_tpu_torch/csrc/paged_attention.cu",
        replaces="hetu_tpu/ops/paged_pallas.py:86",
        lane="int8 (:123-127); " + PAGED_LANES,
        max_abs_err=errs[torch.float32],
        max_abs_err_bf16=errs[torch.bfloat16], shape="decode_1024 bf16",
        **timed["decode_1024"],
        **{f"prefill_history_{k}": v
           for k, v in timed["prefill_history_shared"].items()})

    # ---- the fp/bf16 lanes of #1 at d = 128 ----
    for dtype in (torch.float32, torch.bfloat16):
        for name, kw, shared, lane in (
                ("decode_1024_d128", dict(main, offsets=[1023] * LLAMA_SLOTS),
                 None, "split_kv"),
                ("prefill_history_shared_d128", history, hist_slot, "tile"),
                ("gqa4_R3_d128", cases[4][1], None, "tile")):
            q, k, v, tbl, off = paged_case(gens, device, dtype, **kw)
            got = paged_call(ops, q, k, v, tbl, off, shared, return_lse=True)
            ref_o, ref_l = ops.paged_attention_reference(q, k, v, tbl, off,
                                                         return_lse=True)
            torch.cuda.synchronize()
            out, lse = got
            err = max(max_err(out, ref_o), max_err(lse, ref_l))
            rerun = None
            if lane == "split_kv":
                rerun = check_rerun(name, got, paged_call(
                    ops, q, k, v, tbl, off, shared, return_lse=True))
            tag = str(dtype).split(".")[1]
            emit(phase="kernel", kernel="paged_attention", case=name,
                 lane=lane, dtype=tag, shape=list(q.shape), max_abs_err=err,
                 bound=TOL[dtype], rerun_identical=rerun,
                 ok=err <= TOL[dtype])
            check(err <= TOL[dtype], f"paged {name} {tag}: max abs err "
                                     f"{err} > {TOL[dtype]}")
            if dtype == torch.bfloat16 and name == "decode_1024_d128":
                dev = paged_profile(timer, name, lambda: paged_call(
                    ops, q, k, v, tbl, off, shared), lane)
                t = time_paged(timer, ops, q, k, v, tbl, off, False)
                t["profile_device_ms"] = dev
                emit(phase="kernel_time", kernel="paged_attention",
                     case=name, lane=lane, dtype="bfloat16",
                     shape=list(q.shape), **t)
                results["paged_attention"].update(
                    {f"d128_decode_bf16_{k}": v for k, v in t.items()})
            del q, k, v, got, out, lse, ref_o, ref_l
    gc.collect()
    release()

    # ---- the flash forward (#2) at the Llama pack, d = 128 ----
    pack_seg = pack_segments(LLAMA_PACK, LLAMA_CHUNK)
    for dtype in (torch.float32, torch.bfloat16):
        for name, kw in (
                ("llama_packed_prefill", dict(b=1, hq=32, hkv=32,
                                              s=LLAMA_CHUNK, d=128,
                                              seg=pack_seg)),
                ("gqa4_pads_d128", dict(b=1, hq=32, hkv=8, s=LLAMA_CHUNK,
                                        d=128, seg=pack_seg))):
            q, k, v, seg = flash_case(gens, device, dtype, **kw)
            scale = q.shape[-1] ** -0.5
            out, lse = ops.flash_attention_fwd(q, k, v, seg, seg,
                                               causal=True, scale=scale)
            ref_o, ref_l = ops.flash_attention_fwd_reference(
                q, k, v, seg, seg, causal=True, scale=scale)
            torch.cuda.synchronize()
            err = max(max_err(out, ref_o), max_err(lse, ref_l))
            tag = str(dtype).split(".")[1]
            rerun = None
            if dtype == torch.float32:      # the 3xTF32 lane: same bits
                rerun = check_rerun(name, (out, lse), ops.flash_attention_fwd(
                    q, k, v, seg, seg, causal=True, scale=scale), "flash_fwd")
            emit(phase="kernel", kernel="flash_fwd", case=name, dtype=tag,
                 shape=list(q.shape), lane=ops.flash_lane(dtype, 128),
                 max_abs_err=err, bound=TOL[dtype], rerun_identical=rerun,
                 ok=err <= TOL[dtype])
            check(err <= TOL[dtype], f"flash {name} {tag}: max abs err "
                                     f"{err} > {TOL[dtype]}")
            if name == "llama_packed_prefill":
                # the pack in bf16 and, as llama_pack_fp32, in fp32 (the
                # fp32 Llama engine's chunk): each lane from a profile,
                # then timed
                lane = ops.flash_lane(dtype, 128)
                case = name if dtype == torch.bfloat16 else "llama_pack_fp32"
                check_lane(case, timer.profile(
                    lambda: ops.flash_attention_fwd(
                        q, k, v, seg, seg, causal=True, scale=scale),
                    iters=PROFILE_ITERS,
                    expect=(LANE_SYMBOLS["flash_fwd"][lane],)),
                    lane, kernels=("flash_fwd",))
                t = time_flash(timer, ops, q, k, v, seg, scale)
                emit(phase="kernel_time", kernel="flash_fwd", case=case,
                     lane=lane, dtype=tag, shape=list(q.shape), **t)
                results["flash_fwd"].update(
                    {f"d128_prefill_{tag}_{k}": v for k, v in t.items()})


#: kernel #1 at the verify lane's shapes: (name, model, draft depth K,
#: q dtype, int8 arena, offsets, lane). 16 slots of K + 1 rows at 1,024
#: live positions; the past-the-table cases put slots where ``q_offset +
#: K >= W * bs`` (their last rows attend the whole table: the kernel
#: clamps its key count to ``W * bs``)
VERIFY_CASES = (
    ("verify_k4_int8", "llama", 4, torch.bfloat16, True, "1023", "tile_tc"),
    ("verify_k3_int8", "llama", 3, torch.bfloat16, True, "1023", "split_kv"),
    ("verify_k4_gpt2_fp32", "gpt2", 4, torch.float32, False, "ragged",
     "tile"),
    ("verify_k4_int8_past_table", "llama", 4, torch.bfloat16, True, "edge",
     "tile_tc"),
    ("verify_k3_int8_past_table", "llama", 3, torch.bfloat16, True, "edge",
     "split_kv"),
    ("verify_k4_gpt2_fp32_past_table", "gpt2", 4, torch.float32, False,
     "edge", "tile"),
)


def phase_verify_kernels(device, timer, ops, results):
    """Kernel #1 at the verify lane's shapes (``VERIFY_CASES``): Llama q
    (16, K+1, 32, 128) bf16 over the (2049, 16, 32, 128) int8 arena at K
    = 4 (R*g = 5: the tensor-core tile lane) and K = 3 (R*g = 4: split-KV),
    GPT-2 q (16, 5, 12, 64) fp32 over its fp32 arena (the CUDA-core tile
    lane), and each with slots past the end of their tables. Each case
    against its plain version (1e-4 fp32, 2e-2 bf16, out and lse) and
    rerun bit-equal; the lane is ``ops.paged_lane``'s and, for the three
    timed cases, the profile's (``lane`` lines). Times: kernel, plain,
    the library yardstick (``gather_block_rows`` + dequantize + SDPA with
    each row's causal offset) and the bound; added to #1's entries."""
    gens = Generators(device, SEED + 21)
    rng = np.random.default_rng(SEED + 21)
    shapes = {"llama": dict(hq=32, hkv=32, d=128, bs=LLAMA_BLOCK,
                            W=LLAMA_MAX_LEN // LLAMA_BLOCK,
                            n_blocks=1 + LLAMA_SLOTS
                            * (LLAMA_MAX_LEN // LLAMA_BLOCK)),
              "gpt2": dict(hq=12, hkv=12, d=64, bs=16, W=32, n_blocks=513)}
    for name, model, K, dtype, int8, where, lane in VERIFY_CASES:
        kw = shapes[model]
        top = kw["W"] * kw["bs"]
        if where == "1023":
            offsets = [1023] * 16
        elif where == "ragged":
            offsets = rng.integers(3, top - K - 1, 16).tolist()
        else:
            # four slots whose last rows lie past the table, the rest
            # ragged
            offsets = [top - K, top - 2, top - 1, top - K - 1] \
                + rng.integers(3, top - K - 1, 12).tolist()
        R = K + 1
        check(ops.paged_lane(dtype, kw["d"], R * kw["hq"] // kw["hkv"],
                             False) == lane,
              f"{name}: ops.paged_lane does not pick the {lane} lane")
        q, k, v, tbl, off = paged_case(gens, device, torch.float32, R=R,
                                       offsets=offsets, **kw)
        q = q.to(dtype)
        sc = {}
        if int8:
            kq, ks, vq, vs = int8_arena(k, v, ops)
            k, v, sc = kq, vq, dict(k_scale=ks, v_scale=vs)
        else:
            k, v = k.to(dtype), v.to(dtype)
        got = ops.paged_attention(q, k, v, tbl, off, return_lse=True, **sc)
        ref_o, ref_l = ops.paged_attention_reference(q, k, v, tbl, off,
                                                     return_lse=True, **sc)
        again = ops.paged_attention(q, k, v, tbl, off, return_lse=True, **sc)
        torch.cuda.synchronize()
        out, lse = got
        err = max(max_err(out, ref_o), max_err(lse, ref_l))
        rerun = check_rerun(name, got, again)
        kernel = "paged_attention_int8" if int8 else "paged_attention"
        emit(phase="kernel", kernel=kernel, case=name, lane=lane,
             dtype=str(dtype).split(".")[1], shape=list(q.shape),
             offsets_past_table=sum(o + K >= top for o in offsets),
             max_abs_err=err, lse_err=max_err(lse, ref_l),
             bound=TOL[dtype], rerun_identical=rerun, ok=err <= TOL[dtype])
        check(err <= TOL[dtype], f"paged {name}: max abs err {err} > "
                                 f"{TOL[dtype]}")
        del got, again, out, lse, ref_o, ref_l
        if where != "edge":
            dev = paged_profile(timer, name, lambda: ops.paged_attention(
                q, k, v, tbl, off, **sc), "split_kv" if lane == "split_kv"
                else "tile")
            t = time_paged(timer, ops, q, k, v, tbl, off, False, **sc)
            t["profile_device_ms"] = dev
            emit(phase="kernel_time", kernel=kernel, case=name, lane=lane,
                 dtype=str(dtype).split(".")[1], shape=list(q.shape), **t)
            results[kernel].update({f"{name}_{key}": val
                                    for key, val in t.items()})
        results[kernel][f"{name}_max_abs_err"] = err
        del q, k, v, sc
        gc.collect()
        release()


def llama_workload(vocab: int, seed: int = SEED):
    """48 prompts of 16-1536 tokens, then 16 that share a 512-token
    system prompt. Three of the 16 (a follow-up turn) also repeat the
    first 1-15 tokens of one of the first request's later blocks, so
    their prefix hit ends inside a block: the engine maps it through a
    copy-on-write of that block."""
    rng = np.random.default_rng(seed)
    burst = [rng.integers(0, vocab, int(n)).tolist()
             for n in rng.integers(16, 1537, 48)]
    system = rng.integers(0, vocab, 512).tolist()
    lens = rng.integers(16, 257, 16)
    lens[0] = max(int(lens[0]), 64)        # 4+ whole blocks past the system
    shared = [system + rng.integers(0, vocab, int(lens[0])).tolist()]
    for i in range(1, 16):
        keep = 512
        if i in (4, 8, 12):
            keep += 16 * (i // 4 - 1) + int(rng.integers(1, 16))
        shared.append(shared[0][:keep]
                      + rng.integers(0, vocab, int(lens[i])).tolist())
    return burst, shared


#: requests a teacher-forced oracle call batches (one right-padded row
#: each)
ORACLE_ROWS = 16


@torch.no_grad()
def forced_logits_rows(model, prompts, tokens, cache_dtype,
                       chunk=LLAMA_CHUNK, lora=None, w8a8=None):
    """The dense oracle teacher-forced on each row's ``tokens``, all rows
    in one right-padded batch: row r holds its prompt and every token of
    ``tokens[r]`` but the last, then pad tokens; ``decode`` runs ``chunk``
    positions at a time over a dense cache of ``cache_dtype`` (plain
    attention, no kernel). Every row starts at position 0, so a chunk
    writes each row's cache at the same positions, and a row's real
    positions attend only to positions at or below their own: its padded
    tail is never read. ``lora`` (an adapter arena, ``lora_arena``)
    decodes every token under its page 1; ``w8a8`` (one ``prequantize``
    tree a layer, ``w8a8_trees``) runs every layer's FFN on its W8A8 lane
    for the generated tokens and keeps the prompt's fp, as the engine's
    decode and prefill lanes do: the chunks then run fp up to the
    longest prompt's end (a row past its own end writes cache cells the
    next pass overwrites before any real position reads them), then
    W8A8 over each row's generated tokens, every row from its own
    prompt's end (``decode``'s per-row positions, ``slot_mask``).
    Returns, a row, the fp32 logits the oracle chooses each of
    ``tokens[r]`` from, ``(len(tokens[r]), V)``; row 0 of each follows
    the prompt alone."""
    from hetu_tpu_torch.models import decode, init_kv_caches
    dev = model.device
    seqs = [list(p) + list(t[:-1]) for p, t in zip(prompts, tokens)]
    ends = [len(p) for p in prompts]
    gen = [len(s) - e for s, e in zip(seqs, ends)]
    B, T = len(seqs), max(len(s) for s in seqs)
    if w8a8 is not None:         # room for every row's window
        T = max(e + max(gen) for e in ends)
    ids = torch.zeros((B, T), dtype=torch.long)
    for r, s in enumerate(seqs):
        ids[r, :len(s)] = torch.tensor(s)
    ids = ids.to(dev)
    caches = init_kv_caches(model, B, T, cache_dtype)
    pages = (lambda pos: None) if lora is None \
        else (lambda pos: {"ids": torch.ones_like(pos), "pages": lora})
    rows: list = [[] for _ in range(B)]
    # every row from position 0: the whole sequence (the prompts, for
    # W8A8), in fp
    fp_end = T if w8a8 is None else max(ends)
    for lo in range(0, fp_end, chunk):
        hi = min(lo + chunk, fp_end)
        pos = torch.arange(lo, hi, device=dev)[None].repeat(B, 1)
        logits = decode(model, ids[:, lo:hi], pos, caches, lora=pages(pos))
        for r in range(B):
            a = max(lo, ends[r] - 1)
            b = min(hi, len(seqs[r]) if w8a8 is None else ends[r])
            if a < b:
                rows[r].append(logits[r, a - lo:b - lo])
    if w8a8 is not None:
        start = torch.tensor(ends, device=dev)[:, None]
        quant = dict(w8a8_mask=(True,) * len(w8a8), w8a8_wq=w8a8)
        for lo in range(0, max(gen), chunk):
            hi = min(lo + chunk, max(gen))
            pos = start + torch.arange(lo, hi, device=dev)[None]
            logits = decode(model, torch.gather(ids, 1, pos), pos, caches,
                            slot_mask=torch.ones(B, dtype=torch.bool,
                                                 device=dev),
                            lora=pages(pos), **quant)
            for r in range(B):
                if lo < gen[r]:
                    rows[r].append(logits[r, :min(hi, gen[r]) - lo])
    return [torch.cat(x) for x in rows]


def forced_logits(model, prompt, tokens, cache_dtype, chunk=LLAMA_CHUNK,
                  lora=None, w8a8=None):
    """``forced_logits_rows`` of one request: ``(len(tokens), V)``."""
    return forced_logits_rows(model, [prompt], [tokens], cache_dtype,
                              chunk=chunk, lora=lora, w8a8=w8a8)[0]


def oracle(model, reqs, new_tokens, vocab, cache_dtype=torch.int8,
           keep=None, lora_for=None, w8a8=None):
    """Each request's greedy tokens against ``forced_logits_rows`` on
    them, ``ORACLE_ROWS`` requests a batch (under the adapter arena
    ``lora_for(request)`` gives, None for base, each batch one arena;
    with ``w8a8`` trees, the W8A8 decode).
    Returns the largest first-token |dlogit| (the engine's recorded
    logits against the oracle's row 0), the largest shortfall over every
    step (see TIE_FP32) and where it fell, the share of steps at which
    the engine's token is the oracle's best, how many requests agree
    at every step, and the oracle's seconds. ``keep``, a dict, receives
    each request's forced logits by request id."""
    t0 = time.perf_counter()
    for r in reqs:
        got = list(r.tokens)
        check(len(got) == new_tokens and all(0 <= t < vocab for t in got),
              f"request {r.id}: bad token list")
        check(r.first_logits is not None
              and bool(torch.isfinite(r.first_logits).all()),
              f"request {r.id}: no finite first-token logits recorded")
    groups: dict = {}
    for r in reqs:
        arena = lora_for(r) if lora_for else None
        groups.setdefault(id(arena), (arena, []))[1].append(r)
    forced = {}
    for arena, members in groups.values():
        for i in range(0, len(members), ORACLE_ROWS):
            batch = members[i:i + ORACLE_ROWS]
            out = forced_logits_rows(
                model, [r.prompt.tolist() for r in batch],
                [list(r.tokens) for r in batch], cache_dtype, lora=arena,
                w8a8=w8a8)
            forced.update((r.id, lg) for r, lg in zip(batch, out))
    dlogit, worst, where, agree, identical = 0.0, 0.0, None, 0, 0
    for r in reqs:
        got, logits = list(r.tokens), forced[r.id]
        check(bool(torch.isfinite(logits).all()),
              f"request {r.id}: non-finite oracle logits")
        if keep is not None:
            keep[r.id] = logits
        dlogit = max(dlogit, max_err(r.first_logits, logits[0]))
        idx = torch.tensor(got, device=logits.device)[:, None]
        short = logits.max(dim=-1).values - logits.gather(1, idx)[:, 0]
        step = int(short.argmax())
        if float(short[step]) > worst:
            worst, where = float(short[step]), dict(request=r.id, step=step)
        agree += int((short == 0).sum())
        identical += bool((short == 0).all())
    return dict(requests=len(reqs), identical=identical,
                agree_share=agree / (new_tokens * len(reqs)),
                first_token_max_abs_dlogit=dlogit, max_shortfall=worst,
                max_shortfall_at=where,
                oracle_seconds=time.perf_counter() - t0)


def held(reading, dlogit_bound, tie_bound) -> bool:
    return (reading["first_token_max_abs_dlogit"] <= dlogit_bound
            and reading["max_shortfall"] < tie_bound)


def check_held(name, reading, dlogit_bound, tie_bound):
    check(held(reading, dlogit_bound, tie_bound),
          f"{name}: first-token |dlogit| "
          f"{reading['first_token_max_abs_dlogit']} (bound {dlogit_bound}),"
          f" largest shortfall {reading['max_shortfall']} at "
          f"{reading['max_shortfall_at']} (bound {tie_bound})")


@contextlib.contextmanager
def planted(fault):
    """Plant ``fault`` (one of FAULTS) in every call of the int8 lane the
    model makes; the fp lanes pass untouched."""
    import hetu_tpu_torch.nn.parallel as par
    real = par.paged_attention

    def faulty(q, k, v, tables, offsets, *, k_scale=None, v_scale=None,
               **kw):
        if k_scale is not None and fault == "scales_of_next_kv_head":
            k_scale, v_scale = k_scale.roll(1, 2), v_scale.roll(1, 2)
        elif k_scale is not None:
            offsets = offsets - LLAMA_BLOCK
        return real(q, k, v, tables, offsets, k_scale=k_scale,
                    v_scale=v_scale, **kw)

    par.paged_attention = faulty
    try:
        yield
    finally:
        par.paged_attention = real


def fault_readings(model, engine_kw, bounds, phase, cache_dtype):
    """Serve 16 fresh multi-chunk prompts (257-1536 tokens, 16 new
    tokens each) once per planted fault and read each run against
    ``oracle``. Returns, per fault, whether the bounds that the sound
    run must pass fail it."""
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine
    rng = np.random.default_rng(SEED + 5)
    vocab, new = model.cfg.vocab_size, 16
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(LLAMA_CHUNK + 1,
                                     LLAMA_MAX_LEN * 3 // 4 + 1, 16)]
    caught = {}
    for fault in FAULTS:
        t0 = time.perf_counter()
        with planted(fault):
            # built inside: the fault is in the captured lanes
            eng = ServingEngine(model, **engine_kw)
            reqs = [eng.submit(p, SamplingParams(max_tokens=new))
                    for p in prompts]
            eng.run_until_drained()
        check(all(r.status == "done" for r in reqs),
              f"{phase} {fault}: requests unfinished")
        got = oracle(model, reqs, new, vocab, cache_dtype)
        caught[fault] = not held(got, *bounds)
        emit(phase=phase, fault=fault, **got, dlogit_bound=bounds[0],
             tie_bound=bounds[1], caught=caught[fault],
             seconds=time.perf_counter() - t0)
        del eng, reqs
        gc.collect()
        release()
    return caught


def bf16_noise(model, reqs, device):
    """How far bf16 itself moves this model's first-token logits: batch-1
    ``generate`` under ``BF16_FULL`` against the same bf16 weights
    computed in fp32 (``FP32`` casts them exactly), both from a dense
    int8 cache. Returns the largest |dlogit| and the mean std of the
    fp32 first-token logits over ``reqs``."""
    from hetu_tpu_torch.core import BF16_FULL, FP32, autocast
    from hetu_tpu_torch.models import generate
    worst, stds = 0.0, []
    for r in reqs:
        got = {}
        for name, policy in (("bf16", BF16_FULL), ("fp32", FP32)):
            with autocast(policy):
                _, lg = generate(model, [r.prompt.tolist()],
                                 max_new_tokens=1, device=device,
                                 return_logits=True, cache_dtype=torch.int8)
            got[name] = lg[0, 0]
        worst = max(worst, max_err(got["bf16"], got["fp32"]))
        stds.append(float(got["fp32"].std()))
    return worst, float(np.mean(stds))


def phase_llama_engine(device, card, timer):
    """Llama-7B (bf16 params and compute, random weights from a seed)
    served from the int8 KV arena; the launch counters are zeroed just
    before the main path and read just after. Then its oracle, its
    profile and the LM head's cast. Returns the counts and the model
    (the memory-pressure phases serve it next)."""
    import dataclasses

    import torch.nn.functional as F
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.models import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama_7b(),
                              num_layers=LLAMA_SERVE_LAYERS)
    t0 = time.perf_counter()
    model = LlamaLMHeadModel(cfg, device=device, dtype=torch.bfloat16,
                             seed=SEED).eval()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine_kw = dict(slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
                     prefill_chunk=LLAMA_CHUNK, block_size=LLAMA_BLOCK,
                     cache_dtype=torch.int8, seed=SEED, device=device,
                     record_first_logits=True)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    burst, shared = llama_workload(cfg.vocab_size)
    new = 64
    sp = SamplingParams(max_tokens=new)

    # the engines are built where they serve: their lanes are captured
    # under the bf16 policy
    with autocast(BF16_FULL):
        warm = ServingEngine(model, slots=2, max_len=LLAMA_MAX_LEN,
                             prefill_chunk=LLAMA_CHUNK,
                             block_size=LLAMA_BLOCK, cache_dtype=torch.int8,
                             device=device)
        warm.generate_many([burst[0][:300]], SamplingParams(max_tokens=3))
        del warm
        torch.cuda.synchronize()
        before = trace_counts()
        t1 = time.perf_counter()
        eng = ServingEngine(model, **engine_kw)
        emit(phase="llama_engine_setup", config="LlamaConfig.llama_7b",
             dtype="bfloat16", cache_dtype="int8", layers=cfg.num_layers,
             hidden=cfg.hidden_size, heads=cfg.num_heads,
             kv_heads=cfg.num_kv_heads or cfg.num_heads,
             intermediate=cfg.intermediate_size, vocab=cfg.vocab_size,
             slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
             prefill_chunk=LLAMA_CHUNK, block_size=LLAMA_BLOCK,
             kv_blocks=eng.pool.n_blocks, arena_bytes=eng.pool.nbytes(),
             weight_bytes=weight_bytes, init_seconds=t_init,
             lanes=capture_stats(eng),
             engine_seconds=time.perf_counter() - t1,
             seconds=time.perf_counter() - t0)
        check(eng.pool.quantized, "the Llama engine's arena is not int8")
        check_captures("llama_engine_setup", eng, before)
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: counters zeroed just before, read after ----
        reset_launch_counts()
        run = serve(eng, burst, shared, sp)
        counts = launch_counts()
        iters = dict(eng.lane_iters)
        # ---------------------------------------------------------------
    check_captures("llama_engine", eng, before)
    check_launches("llama_engine_launches", counts, iters, cfg.num_layers,
                   paged="paged_attention_int8")
    reqs, reqs2 = run["reqs"], run["reqs2"]
    bad = [r for r in reqs + reqs2 if r.status != "done"]
    check(not bad, f"{len(bad)} requests did not finish")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    timings = [r.timing() for r in reqs]
    ttft = [t["ttft_ms"] for t in timings]
    tpot = [t["decode_ms"] / (len(r.tokens) - 1)
            for t, r in zip(timings, reqs) if len(r.tokens) > 1]
    hits = sum(r.cached_tokens for r in reqs2)
    perf = dict(phase="llama_engine", card=card,
         burst_requests=len(reqs),
         burst_prompt_tokens=sum(len(p) for p in burst),
         burst_generated_tokens=gen_tokens,
         burst_seconds=run["t_burst"],
         burst_tokens_per_s=gen_tokens / run["t_burst"],
         burst_steps=run["steps"],
         burst_ms_per_step=run["t_burst"] / run["steps"] * 1e3,
         burst_lane_iterations=run["it_burst"],
         ttft_samples=len(ttft), tpot_samples=len(tpot),
         ttft_ms_p50=percentile(ttft, 50), ttft_ms_p99=percentile(ttft, 99),
         tpot_ms_p50=percentile(tpot, 50), tpot_ms_p99=percentile(tpot, 99),
         shared_requests=len(reqs2), shared_prefix_hit_tokens=hits,
         shared_cow_hits=sum(1 for r in reqs2
                             if r.cached_tokens % LLAMA_BLOCK),
         shared_seconds=run["t_shared"],
         shared_tokens_per_s=sum(len(r.tokens) for r in reqs2)
         / run["t_shared"],
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit(**perf)
    check(hits >= 15 * 512, f"shared-prompt batch hit only {hits} cached "
                            f"tokens")

    # ---- the oracle: the dense int8 oracle teacher-forced on every
    # request, bf16; then the same oracle against planted faults ----
    t0 = time.perf_counter()
    bounds = (DLOGIT_BF16, TIE_BF16)
    with autocast(BF16_FULL):
        sound = oracle(model, reqs + reqs2, new, cfg.vocab_size)
    longest = sorted(reqs, key=lambda r: len(r.prompt))[-4:]
    noise, std = bf16_noise(model, longest, device)
    emit(phase="llama_engine_oracle", dtype="bfloat16", **sound,
         dlogit_bound=DLOGIT_BF16, tie_bound=TIE_BF16,
         bf16_vs_fp32_compute_max_abs_dlogit=noise, first_logit_std=std,
         seconds=time.perf_counter() - t0)
    with autocast(BF16_FULL):
        caught = fault_readings(model, engine_kw, bounds,
                                "llama_engine_oracle_fault", torch.int8)
    check_held("bf16 engine against the oracle", sound, *bounds)
    for fault, seen in caught.items():
        check(seen, f"the bf16 oracle passes a planted fault of the int8 "
                    f"lane ({fault})")

    with autocast(BF16_FULL):
        # 96 tokens each, so no request ends inside the window; first a
        # window of prefill and decode mixed (prompts the prefix cache
        # does not hold), then steady decode
        fresh, _ = llama_workload(cfg.vocab_size, seed=SEED + 7)
        phase_profile(eng, fresh[:LLAMA_SLOTS],
                      SamplingParams(max_tokens=96),
                      phase="llama_engine_mixed_profile",
                      classes=LLAMA_CLASSES, flash_lane="tensor_core")
        phase_profile(eng, burst[:LLAMA_SLOTS],
                      SamplingParams(max_tokens=96),
                      phase="llama_engine_profile", classes=LLAMA_CLASSES,
                      steady_decode=True)
        split = phase_step_split(eng, burst[:LLAMA_SLOTS],
                                 SamplingParams(max_tokens=96),
                                 "llama_engine_step_split")
        phase_step_graph_replay(eng, "LlamaConfig.llama_7b bf16, int8 arena")
    check_captures("llama_engine_after_profiles", eng)

    # ---- the LM head: fp32 logits from a per-call cast of the bf16
    # weight (JAX's numerics, what the model runs) against a held fp32
    # copy, at the decode lane's shape ----
    h = torch.randn(LLAMA_SLOTS, cfg.hidden_size, device=device,
                    dtype=torch.bfloat16)
    w = model.head_weight()
    w32 = w.float()
    cast_ms = timer(lambda: F.linear(h.float(), w.float()))
    held_ms = timer(lambda: F.linear(h.float(), w32))
    same = torch.equal(F.linear(h.float(), w.float()),
                       F.linear(h.float(), w32))
    emit(phase="llama_lm_head", shape=[LLAMA_SLOTS, cfg.hidden_size,
                                       cfg.vocab_size],
         per_call_cast_ms=cast_ms, held_fp32_copy_ms=held_ms,
         held_copy_bytes=w32.numel() * 4, identical=same)
    check(same, "the held fp32 head copy changes the logits")
    del w32, h, eng
    gc.collect()
    release()
    # read by llama_w8a8, beside its own (not printed again)
    perf["replay_device_ms_median"] = split["replay_device_ms_median"]
    # read by llama_telemetry: the telemetry-off run's requests
    perf["requests"] = reqs + reqs2
    return counts, model, perf


# ---- serving under memory pressure (Llama-7B, int8 arena) ----------------

#: the sizing cell: the arena sized from an HBM budget by the byte ledger
#: (``engine/memory.py``: 4 bytes a parameter, 10% headroom)
BUDGET_BYTES = 40e9
#: the preemption cell: 16 slots over 385 blocks (the null block and 8
#: worst-case batch requests of 512 + 256 tokens, 48 blocks each); 16
#: batch requests (priority 2) at once, then a wave of 4 interactive ones
#: (priority 0) at each step of ``PREEMPT_WAVES``, finding no free block.
#: Every wave arrives while only the first 8 batch requests decode (they
#: prefill in the same packs with and without preemption)
PREEMPT_KW = dict(slots=16, kv_blocks=385, max_len=LLAMA_MAX_LEN,
                  prefill_chunk=LLAMA_CHUNK, block_size=LLAMA_BLOCK,
                  cache_dtype=torch.int8, seed=SEED,
                  record_first_logits=True)
PREEMPT_BATCH = (16, 512, 256)           # requests, prompt, max_tokens
PREEMPT_URGENT = (4, 256, 64)            # a wave
PREEMPT_WAVES = (24, 104, 184)
SPILL_HOST_BYTES = 4e9
#: the evict-and-resume request: prompt, max_tokens, tokens before the
#: eviction
EVICT_REQUEST = (700, 48, 16)


def llama_memory_footprint(eng, weight_bytes) -> dict:
    """The card's real footprint beside the ledger's price of it."""
    from hetu_tpu_torch.engine import memory
    cfg, pool = eng.model.cfg, eng.pool
    return dict(
        weight_bytes=weight_bytes, arena_bytes=pool.nbytes(),
        graph_pool_bytes={k: g.pool_bytes for k, g in eng.lanes.items()},
        allocated_bytes=torch.cuda.memory_allocated(),
        reserved_bytes=torch.cuda.memory_reserved(),
        ledger_weight_bytes=memory.model_params(cfg) * 4.0,
        ledger_arena_bytes=pool.n_blocks * memory.kv_bytes_per_block(
            cfg, block_size=pool.block_size, cache_dtype="int8"))


def phase_llama_budget_engine(device, card, model):
    """``ServingEngine(hbm_budget_bytes=40e9)`` on Llama-7B (bf16, int8
    arena): the slot count must be ``engine.memory.size_kv_pool``'s and
    the arena's bytes ``n_blocks`` blocks of ``kv_bytes_per_block`` to
    the byte; then ``llama_workload``'s burst once, launches counted as
    in ``llama_engine``, the first 16 requests held to the bf16 oracle,
    and the real footprint (weights, arena, graph pools, peak over the
    burst) beside the ledger's."""
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.engine import memory, trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    cfg = model.cfg
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    burst, _ = llama_workload(cfg.vocab_size)
    new = 64
    t0 = time.perf_counter()
    with autocast(BF16_FULL):
        before = trace_counts()
        eng = ServingEngine(model, hbm_budget_bytes=BUDGET_BYTES,
                            max_len=LLAMA_MAX_LEN, prefill_chunk=LLAMA_CHUNK,
                            block_size=LLAMA_BLOCK, cache_dtype=torch.int8,
                            seed=SEED, device=device,
                            record_first_logits=True)
        check_captures("llama_budget_engine_setup", eng, before)
        torch.cuda.synchronize()
        built = llama_memory_footprint(eng, weight_bytes)
        memory.reset_memory_stats(device)

        # ---- the main path: counters zeroed just before, read after ----
        reset_launch_counts()
        t1 = time.perf_counter()
        reqs = [eng.submit(p, SamplingParams(max_tokens=new))
                for p in burst]
        steps = eng.run_until_drained()
        torch.cuda.synchronize()
        t_burst = time.perf_counter() - t1
        counts = launch_counts()
        iters = dict(eng.lane_iters)
        # ---------------------------------------------------------------
        peak = memory.device_peak_bytes(device)
        reading = oracle(model, reqs[:16], new, cfg.vocab_size)
    check_captures("llama_budget_engine", eng, before)
    check_launches("llama_budget_engine_launches", counts, iters,
                   cfg.num_layers, paged="paged_attention_int8")
    want_slots = memory.size_kv_pool(cfg, hbm_budget_bytes=BUDGET_BYTES,
                                     max_len=LLAMA_MAX_LEN,
                                     cache_dtype="int8")
    pool = eng.pool
    per_block = memory.kv_bytes_per_block(cfg, block_size=LLAMA_BLOCK,
                                          cache_dtype="int8")
    gen = sum(len(r.tokens) for r in reqs)
    ttft = [r.timing()["ttft_ms"] for r in reqs]
    emit(phase="llama_budget_engine", card=card,
         config="LlamaConfig.llama_7b", hbm_budget_bytes=BUDGET_BYTES,
         slots=pool.slots, ledger_slots=want_slots, kv_blocks=pool.n_blocks,
         kv_bytes_per_block=per_block, **built,
         burst_peak_allocated_bytes=peak,
         burst_requests=len(reqs), burst_generated_tokens=gen,
         burst_seconds=t_burst, burst_tokens_per_s=gen / t_burst,
         burst_steps=steps, ttft_ms_p50=percentile(ttft, 50),
         ttft_ms_p99=percentile(ttft, 99), lane_iterations=iters,
         oracle=reading, dlogit_bound=DLOGIT_BF16, tie_bound=TIE_BF16,
         seconds=time.perf_counter() - t0)
    check(pool.slots == want_slots,
          f"budget engine: {pool.slots} slots, the ledger sizes "
          f"{want_slots}")
    check(pool.n_blocks == 1 + pool.slots * pool.table_width,
          f"budget engine: {pool.n_blocks} blocks for {pool.slots} slots")
    check(pool.nbytes() == pool.n_blocks * per_block,
          f"budget engine: arena {pool.nbytes()} B, the ledger prices "
          f"{pool.n_blocks * per_block} B")
    check(all(r.status == "done" for r in reqs),
          "budget engine: requests unfinished")
    check_held("budget engine against the oracle", reading, DLOGIT_BF16,
               TIE_BF16)
    del eng, reqs
    gc.collect()
    release()
    return counts


def spill_parts(caches, ids, nb: int, held: list) -> dict:
    """A spill's parts timed apart, each to a sync, on the blocks the
    engine just spilled (the engine's ``_spill_blocks`` runs them as one):
    the gather; fresh pinned host buffers; the device-to-host copy into
    them; and pinned buffers again after a free (the allocator's cache).
    Every buffer it times is kept in ``held``, so no later call is handed
    one back from the cache."""
    dev = caches[0].device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = torch.as_tensor(ids[:nb], dtype=torch.int64).to(dev)
    gathered = [c.index_select(1, idx) for c in caches]
    torch.cuda.synchronize()
    t1 = time.perf_counter()

    def pinned():
        return [torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                for g in gathered]

    host = pinned()
    t2 = time.perf_counter()
    for h, g in zip(host, gathered):
        h.copy_(g, non_blocking=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    held.append(host)
    spare = pinned()
    del spare
    t4 = time.perf_counter()
    held.append(pinned())
    t5 = time.perf_counter()
    return dict(blocks=nb, bytes=sum(h.numel() * h.element_size()
                                     for h in host),
                gather_ms=(t1 - t0) * 1e3, alloc_fresh_ms=(t2 - t1) * 1e3,
                d2h_ms=(t3 - t2) * 1e3, alloc_cached_ms=(t5 - t4) * 1e3)


class SpillAudit:
    """Wraps an engine's spill and resume so every victim's blocks can be
    compared: before the spill (read with advanced indexing, not the
    engine's ``index_select``, just after the engine's spill and before
    anything writes the freed blocks), the host copy, and the fresh
    blocks after the resume (all four leaves, the first ``pos`` rows).
    Keeps each victim's prefill-chunk count at its spill, whether the
    host copy landed in the engine's spill store, and the spill's parts
    timed apart (``spill_parts``). The audit's own host time is summed
    in ``overhead_s``, for the step times to leave out."""

    def __init__(self, eng):
        self.eng = eng
        self.before, self.chunks, self.resumes = {}, {}, []
        self.stored, self.parts, self.held = [], [], []
        self.overhead_s = 0.0
        spill, exec_spill, resume = (eng._spill_blocks, eng._exec_spill,
                                     eng._exec_resume)

        def audited_spill(ids, nb, **kw):
            self._ids = (np.array(ids), nb)
            return spill(ids, nb, **kw)

        def audited_exec_spill(slot):
            req = eng._slot_req[slot]
            exec_spill(slot)
            t0 = time.perf_counter()
            ids, nb = self._ids
            caches = eng.pool.caches
            idx = torch.as_tensor(ids[:nb], dtype=torch.int64,
                                  device=caches[0].device)
            self.before[req.id] = [c[:, idx].clone() for c in caches]
            self.chunks[req.id] = req.timing()["prefill_chunks"]
            self.stored.append(eng.spill_store is not None
                               and eng.spill_store.owns(req.spill.data))
            self.parts.append(spill_parts(caches, ids, nb, self.held))
            self.overhead_s += time.perf_counter() - t0

        def audited_resume(job):
            req, slot = job["req"], job["slot"]
            entry = req.spill
            resume(job)
            t0 = time.perf_counter()
            nb, rows = entry.n_blocks, entry.pos
            idx = torch.as_tensor(eng._bt[slot, :nb], dtype=torch.int64,
                                  device=eng.pool.caches[0].device)
            host = snap = True
            for c, src, old in zip(eng.pool.caches, entry.data,
                                   self.before.pop(req.id)):
                now = c[:, idx].flatten(1, 2)[:, :rows]
                host &= bool(torch.equal(now.cpu(),
                                         src.flatten(1, 2)[:, :rows]))
                snap &= bool(torch.equal(now, old.flatten(1, 2)[:, :rows]))
            self.resumes.append(dict(request=req.id, blocks=nb, rows=rows,
                                     equal_host_copy=host,
                                     equal_before_spill=snap))
            self.overhead_s += time.perf_counter() - t0

        eng._spill_blocks = audited_spill
        eng._exec_spill = audited_exec_spill
        eng._exec_resume = audited_resume


def preempt_prompts(vocab):
    rng = np.random.default_rng(SEED + 13)
    n, plen, _ = PREEMPT_BATCH
    batch = [rng.integers(0, vocab, plen).tolist() for _ in range(n)]
    n, plen, _ = PREEMPT_URGENT
    urgent = [rng.integers(0, vocab, plen).tolist()
              for _ in range(n * len(PREEMPT_WAVES))]
    return batch, urgent


def run_preempt_cell(model, device, preempt: bool):
    """The preemption cell's schedule on a fresh engine, stepped one
    iteration at a time: each step's host ms (the audit's time left out)
    and what it ran (a spill, a resume, a prefill pack). The launch
    counters are zeroed just before the schedule and read just after."""
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine
    batch, urgent = preempt_prompts(model.cfg.vocab_size)
    before = trace_counts()
    t0 = time.perf_counter()
    eng = ServingEngine(model, preempt=preempt, device=device,
                        spill_host_budget_bytes=SPILL_HOST_BYTES,
                        **PREEMPT_KW)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    audit = SpillAudit(eng) if preempt else None
    reset_launch_counts()
    t0 = time.perf_counter()
    lo = [eng.submit(p, SamplingParams(max_tokens=PREEMPT_BATCH[2],
                                       priority=2)) for p in batch]
    hi, steps, waves, per = [], [], list(PREEMPT_WAVES), PREEMPT_URGENT[0]
    while eng.has_work():
        check(len(steps) < 10_000, "llama_preempt: the engine never drained")
        if waves and len(steps) == waves[0]:
            waves.pop(0)
            hi += [eng.submit(p, SamplingParams(
                max_tokens=PREEMPT_URGENT[2], priority=0))
                for p in urgent[len(hi):len(hi) + per]]
        mark = (eng.scheduler.preemptions_total, eng.lane_iters["prefill"],
                len(audit.resumes) if audit else 0,
                audit.overhead_s if audit else 0.0)
        t1 = time.perf_counter()
        eng.step()
        dt = time.perf_counter() - t1
        if audit:
            dt -= audit.overhead_s - mark[3]
        steps.append(dict(
            ms=dt * 1e3, spill=eng.scheduler.preemptions_total > mark[0],
            prefill=eng.lane_iters["prefill"] > mark[1],
            resume=bool(audit) and len(audit.resumes) > mark[2]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(not waves, "llama_preempt: the engine drained before the last "
                     "interactive wave")
    return dict(eng=eng, lo=lo, hi=hi, audit=audit, before=before,
                counts=launch_counts(), iters=dict(eng.lane_iters),
                steps=steps, seconds=seconds, build_s=build_s)


def step_ms(run, **kind) -> list:
    """The host ms of the run's steps that ran what ``kind`` says, e.g.
    ``spill=True``; ``decode_only`` = no spill, resume or prefill pack."""
    if kind.pop("decode_only", False):
        kind = dict(spill=False, resume=False, prefill=False)
    return [s["ms"] for s in run["steps"]
            if all(s[k] == v for k, v in kind.items())]


def spread(xs) -> dict:
    return dict(n=len(xs), p50=percentile(xs, 50), p99=percentile(xs, 99),
                min=float(min(xs)), max=float(max(xs))) if xs else dict(n=0)


def phase_llama_preempt(device, card, model):
    """The preemption cell twice, with ``preempt=True`` (spill to a 4e9 B
    host arena, its bytes in the engine's spill store) and
    ``preempt=False``: at least one preemption; every request done, the
    spill arena drained; each victim's resumed blocks bit-equal to its
    host copy and to its blocks before the spill, its prefill chunks
    unchanged by the resume, its tokens equal to the ``preempt=False``
    run's; every request within the bf16 oracle's bounds; one capture a
    lane and a bit-equal replay after the resumes. Prints the
    interactive requests' TTFT in both runs (the three waves' twelve
    requests), the host ms of the steps that spilled beside the
    decode-only steps' (the stall every other decoding slot sees), the
    TPOT of the batch requests never preempted, and each spill's parts
    timed apart."""
    from hetu_tpu_torch.core import BF16_FULL, autocast

    cfg = model.cfg
    t0 = time.perf_counter()
    runs = {}
    with autocast(BF16_FULL):
        # the preempt=False engine first: the other's build then differs
        # from it by the spill store's pinned allocation alone
        for preempt in (False, True):
            run = runs[preempt] = run_preempt_cell(model, device, preempt)
            eng = run["eng"]
            reqs = run["lo"] + run["hi"]
            check(all(r.status == "done" for r in reqs),
                  f"llama_preempt preempt={preempt}: requests unfinished")
            check(not eng.has_work() and eng.spill_arena.blocks_held == 0
                  and len(eng.spill_arena) == 0,
                  f"llama_preempt preempt={preempt}: the spill arena holds "
                  f"{eng.spill_arena.blocks_held} blocks after the drain")
            check_captures(f"llama_preempt_{preempt}", eng, run["before"])
            check_launches(f"llama_preempt_launches_{preempt}",
                           run["counts"], run["iters"], cfg.num_layers,
                           paged="paged_attention_int8")
            if preempt:
                lo_reading = oracle(model, run["lo"], PREEMPT_BATCH[2],
                                    cfg.vocab_size)
                hi_reading = oracle(model, run["hi"], PREEMPT_URGENT[2],
                                    cfg.vocab_size)
                phase_step_graph_replay(
                    eng, "LlamaConfig.llama_7b bf16, int8 arena, after "
                         "preemptions")
                check_captures("llama_preempt_after_replay", eng)
            else:
                del run["eng"], eng
                gc.collect()
                release()
    on, off = runs[True], runs[False]
    eng, audit = on["eng"], on["audit"]
    victims = [r for r in on["lo"] if r.preemptions]
    spills = [dur * 1e3 for r in victims for p, _, dur in r.events
              if p == "preempted"]
    resumes = [dur * 1e3 for r in victims for p, _, dur in r.events
               if p == "resumed"]

    def ttft(run):
        return [r.timing()["ttft_ms"] for r in run["hi"]]

    def tpot(run):
        """ms a token of the batch requests the preempt=True run never
        preempted (the same requests in both runs)."""
        out = []
        for r, v in zip(run["lo"], on["lo"]):
            t = r.timing()
            if not v.preemptions and len(r.tokens) > 1:
                out.append(t["decode_ms"] / (len(r.tokens) - 1))
        return out

    same = {r.id: r.tokens == o.tokens for r, o in zip(on["lo"], off["lo"])}
    chunks = {r.id: (audit.chunks[r.id], r.timing()["prefill_chunks"],
                     o.timing()["prefill_chunks"])
              for r, o in zip(on["lo"], off["lo"]) if r.preemptions}
    emit(phase="llama_preempt", card=card, config="LlamaConfig.llama_7b",
         **{k: v for k, v in PREEMPT_KW.items() if k != "cache_dtype"},
         batch=PREEMPT_BATCH, urgent=PREEMPT_URGENT,
         urgent_waves_at_steps=PREEMPT_WAVES,
         spill_host_budget_bytes=SPILL_HOST_BYTES,
         spill_arena_max_blocks=eng.spill_arena.max_blocks,
         spill_store_blocks=eng.spill_store.max_blocks,
         spill_store_bytes=eng.spill_store.nbytes(),
         build_s_preempt=on["build_s"], build_s_unpreempted=off["build_s"],
         arena_bytes=eng.pool.nbytes(),
         preemptions=eng.scheduler.preemptions_total,
         victims=[r.id for r in victims],
         preemptions_by_victim={r.id: r.preemptions for r in victims},
         spilled_blocks=eng.spill_arena.spilled_total,
         resumed_blocks=eng.spill_arena.resumed_total,
         spilled_bytes=sum(r.spilled_blocks for r in victims)
         * eng.pool.nbytes() // eng.pool.n_blocks,
         spill_ms=spills, spills_in_store=audit.stored,
         spill_parts=audit.parts, resume_ms=resumes, resumes=audit.resumes,
         # each victim's prefill chunks: at its last spill, at its end,
         # and in the preempt=False run
         victim_prefill_chunks=chunks,
         victim_tokens_equal_unpreempted={k: same[k] for k in chunks},
         interactive_ttft_ms=spread(ttft(on)),
         unpreempted_interactive_ttft_ms=spread(ttft(off)),
         interactive_ttft_ms_each=ttft(on),
         unpreempted_interactive_ttft_ms_each=ttft(off),
         batch_tpot_ms=spread(tpot(on)),
         unpreempted_batch_tpot_ms=spread(tpot(off)),
         spill_step_ms=step_ms(on, spill=True),
         resume_step_ms=step_ms(on, resume=True, spill=False),
         pack_step_ms=spread(step_ms(on, prefill=True, spill=False,
                                     resume=False)),
         decode_step_ms=spread(step_ms(on, decode_only=True)),
         unpreempted_decode_step_ms=spread(step_ms(off, decode_only=True)),
         seconds_preempt=on["seconds"], seconds_unpreempted=off["seconds"],
         steps_preempt=len(on["steps"]), steps_unpreempted=len(off["steps"]),
         oracle_batch=lo_reading, oracle_interactive=hi_reading,
         dlogit_bound=DLOGIT_BF16, tie_bound=TIE_BF16,
         seconds=time.perf_counter() - t0)
    check(eng.scheduler.preemptions_total >= 1 and victims,
          "llama_preempt: no request was preempted")
    check(all(audit.stored),
          f"llama_preempt: a spill missed the spill store: {audit.stored}")
    check(all(r.resumed_blocks == r.spilled_blocks >= 1 for r in victims)
          and eng.spill_arena.resumed_total
          == eng.spill_arena.spilled_total,
          "llama_preempt: resumed blocks differ from spilled blocks")
    check(len(audit.resumes) == eng.scheduler.preemptions_total
          and all(a["equal_host_copy"] and a["equal_before_spill"]
                  for a in audit.resumes),
          f"llama_preempt: restored blocks differ: {audit.resumes}")
    check(all(a == b == c for a, b, c in chunks.values()),
          f"llama_preempt: a resume changed prefill chunks: {chunks}")
    check(all(same[k] for k in chunks),
          "llama_preempt: a victim's tokens differ from the preempt=False "
          "run's")
    check_held("llama_preempt batch requests against the oracle",
               lo_reading, DLOGIT_BF16, TIE_BF16)
    check_held("llama_preempt interactive requests against the oracle",
               hi_reading, DLOGIT_BF16, TIE_BF16)
    counts = on["counts"]
    del runs, on, off, eng, audit
    gc.collect()
    release()
    return counts


def phase_llama_evict_resume(device, card, model):
    """A request decoding on engine A is taken out with ``evict_request``
    and resumed on engine B with ``submit(..., resume=entry)``: no
    prefill on B, and its tokens equal the same request served
    undisturbed (on B, afterwards). Both engines are built before the
    launch counters are zeroed. The eviction's spill (fresh host
    buffers: the entry leaves the engine) is then timed in its parts."""
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 17)
    plen, new, before = EVICT_REQUEST
    prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
    sp = SamplingParams(max_tokens=new)
    kw = dict(slots=4, max_len=LLAMA_MAX_LEN, prefill_chunk=LLAMA_CHUNK,
              block_size=LLAMA_BLOCK, cache_dtype=torch.int8, seed=SEED,
              device=device)
    t0 = time.perf_counter()
    with autocast(BF16_FULL):
        a = ServingEngine(model, **kw)
        b = ServingEngine(model, **kw)
        torch.cuda.synchronize()
        spilled = []
        spill = a._spill_blocks

        def recorded_spill(ids, nb, **kw):
            spilled.append((np.array(ids), nb))
            return spill(ids, nb, **kw)

        a._spill_blocks = recorded_spill

        # ---- the main path: counters zeroed just before, read after ----
        reset_launch_counts()
        req = a.submit(prompt, sp)
        while len(req.tokens) < before:
            check(a.step(), f"llama_evict_resume: the request stalled "
                            f"({req.status}, {req.error})")
        t1 = time.perf_counter()
        entry = a.evict_request(req)
        t_evict = time.perf_counter() - t1
        moved = b.submit(prompt, sp, resume=entry)
        b.run_until_drained()
        torch.cuda.synchronize()
        counts = launch_counts()
        iters = {k: a.lane_iters[k] + b.lane_iters[k]
                 for k in a.lane_iters}
        # ---------------------------------------------------------------
        held = []
        parts = [spill_parts(a.pool.caches, ids, nb, held)
                 for ids, nb in spilled]
        del held
        undisturbed = b.submit(prompt, sp)
        b.run_until_drained()
    check_captures("llama_evict_resume_a", a)
    check_captures("llama_evict_resume_b", b)
    check_launches("llama_evict_resume_launches", counts, iters,
                   cfg.num_layers, paged="paged_attention_int8")
    emit(phase="llama_evict_resume", card=card, slots=4, prompt=len(prompt),
         max_tokens=sp.max_tokens, evicted_after_tokens=len(entry.tokens),
         entry_blocks=entry.n_blocks, entry_pos=entry.pos,
         entry_bytes=entry.nbytes(), evict_ms=t_evict * 1e3,
         evict_spill_parts=parts,
         resume_ms=[d * 1e3 for p, _, d in moved.events if p == "resumed"],
         moved_prefill_chunks=moved.timing()["prefill_chunks"],
         undisturbed_prefill_chunks=undisturbed.timing()["prefill_chunks"],
         tokens_equal=moved.tokens == undisturbed.tokens,
         lane_iterations=iters, seconds=time.perf_counter() - t0)
    check(req.status == "evicted" and entry is not None
          and entry.n_blocks == -(-entry.pos // LLAMA_BLOCK),
          "llama_evict_resume: no spill entry for the decoding request")
    check(len(spilled) == 1 and spilled[0][1] == entry.n_blocks,
          f"llama_evict_resume: {len(spilled)} spills for one eviction")
    check(moved.status == "done" and undisturbed.status == "done",
          "llama_evict_resume: requests unfinished")
    check(moved.timing()["prefill_chunks"] == 0
          and moved.resumed_blocks == entry.n_blocks,
          "llama_evict_resume: the resumed request ran prefill")
    check(moved.tokens == undisturbed.tokens,
          "llama_evict_resume: resumed tokens differ from the undisturbed "
          "run's")
    del a, b
    gc.collect()
    release()
    return counts


# ---- speculative decoding (Llama-7B n-gram; GPT-2 self-drafting) --------

#: the verify lane's draft depth (``bench.py``'s ``spec_depth = 4``)
SPEC_DEPTH = 4
#: 16 greedy requests of 512 prompt tokens and 128 new ones: the even ones
#: a 32-token pattern repeated to 512 (``tests/test_spec_qos.py``'s
#: ``_corpus`` at full scale: the n-gram draftsman's traffic), the odd
#: ones random
SPEC_REQUESTS = (16, 512, 128)
SPEC_PATTERN = 32
#: the acceptance sweep: drafts replayed from the spec-off run's tokens,
#: each flipped with these probabilities (``bench.py:340-383``)
SPEC_CORRUPT = (1.0, 0.55, 0.0)
#: with clean drafts, no rejected draft may beat the engine's token under
#: the oracle by this much: about three times the largest such gap read
#: on an H100 (0.078), so a rule that rejects an agreeing draft the
#: oracle clearly prefers fails here; a rule that rejects near-ties too
#: fails the own-token replay
SPEC_CLEAN_GAP = 0.25
#: preemption with speculation: 4 slots over 129 blocks (the null block
#: and one worst-case request: the least an arena may hold), three
#: repetitive batch requests of 512 + 128 tokens (priority 2, 40 blocks
#: each) and, at the given step, one interactive request (priority 0, 256
#: + 64 tokens: 20 blocks) that finds 8 free blocks
SPEC_PREEMPT_KW = dict(slots=4, kv_blocks=129)
SPEC_PREEMPT_BATCH = 3
SPEC_URGENT = (256, 64, 8)
#: GPT-2 small drafting for itself: 16 requests of 16-128 prompt tokens
#: (a slot drafts only after a catch-up of about P / (K + 1) steps, so
#: these let every request draft within its 64 new tokens; the engine's
#: own prompts run after them, greedy, for the share of slot-steps that
#: drafted there) and 64 new tokens, greedy, then at each temperature
#: twice in swapped arrival orders with per-request seeds
GPT2_SPEC = (16, 16, 128, 64)
SPEC_TEMPS = (0.7, 1.0)


def spec_prompts(vocab):
    rng = np.random.default_rng(SEED + 19)
    n, plen, _ = SPEC_REQUESTS
    out = []
    for i in range(n):
        if i % 2 == 0:
            pat = rng.integers(0, vocab, SPEC_PATTERN).tolist()
            out.append((pat * -(-plen // SPEC_PATTERN))[:plen])
        else:
            out.append(rng.integers(0, vocab, plen).tolist())
    return out


class ReplayDrafts:
    """A host draftsman that drafts, for each request (known by its
    prompt), the tokens a reference run emitted next, each flipped with
    probability ``frac`` as ``bench.py``'s ``_CorruptDrafts`` does (a
    flipped token is accepted only by coincidence). ``proposed`` records
    each proposal: (prompt, tokens emitted so far, drafts)."""

    host_only = True
    surfaces_q = True

    def __init__(self, reference: dict, plen: int, vocab: int,
                 frac: float):
        self.ref, self.plen, self.vocab, self.frac = (reference, plen,
                                                      vocab, frac)
        self.rng = np.random.default_rng(SEED + 29)
        self.hist = {}
        self.proposed = []

    def reset(self, slot, tokens):
        self.hist[slot] = list(tokens)

    def extend(self, slot, tokens):
        self.hist[slot] += list(tokens)

    def propose(self, slot, k):
        h = self.hist[slot]
        ref = self.ref[tuple(h[:self.plen])]
        n = len(h) - self.plen
        out = [1 + (t + 1) % (self.vocab - 1)
               if self.rng.random() < self.frac else t
               for t in ref[n:n + k]]
        self.proposed.append((tuple(h[:self.plen]), n, out))
        return out


def rejected_drafts(draftsman, reqs):
    """Each draft the verify lane rejected: (request, its token index,
    the draft, the token the engine committed there), from the
    draftsman's record and the requests' tokens."""
    by_prompt = {tuple(r.prompt.tolist()): r for r in reqs}
    out = []
    for key, n, drafts in draftsman.proposed:
        r = by_prompt[key]
        a = 0
        while a < len(drafts) and r.tokens[n + a] == drafts[a]:
            a += 1
        if a < len(drafts):
            out.append((r, n + a, drafts[a], r.tokens[n + a]))
    return out


def serve_stepped(eng, prompts, sps):
    """Submit every prompt and step to drain; returns the requests, each
    step's host ms (a step ends in the ``.cpu()`` that waits for its
    lanes) with whether it ran a prefill pack and how many slots drafted
    in it, and the wall seconds."""
    if not isinstance(sps, (list, tuple)):
        sps = [sps] * len(prompts)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
    steps = []
    while eng.has_work():
        check(len(steps) < 20_000, "the engine never drained")
        pf, dec = eng.lane_iters["prefill"], eng.lane_iters["decode"]
        t1 = time.perf_counter()
        eng.step()
        ms = (time.perf_counter() - t1) * 1e3
        drafting = int((eng._spec["len"] > 0).sum()) \
            if eng.lane_iters["decode"] > dec else 0
        steps.append(dict(ms=ms, prefill=eng.lane_iters["prefill"] > pf,
                          drafting=drafting))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.status == "done" for r in reqs), "requests unfinished")
    return reqs, steps, wall


def replay_device_ms(eng, n: int = 10) -> float:
    """Median device ms of one decode-lane replay (CUDA events; the
    replay re-runs the last staged step, re-writing the same rows)."""
    lane = eng.lanes["decode"]
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in pairs:
        start.record()
        lane.replay()
        end.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in pairs)[n // 2]


def spec_reading(eng, reqs, steps, wall, stats0) -> dict:
    """Throughput, TPOT, decode-only step ms, the speculation ledgers (as
    deltas from ``stats0``) and the share of slot-steps that drafted, of
    one served batch."""
    timings = [r.timing() for r in reqs]
    tpot = [t["decode_ms"] / (len(r.tokens) - 1)
            for t, r in zip(timings, reqs) if len(r.tokens) > 1]
    st = {k: eng.spec_stats[k] - stats0[k] for k in stats0}
    gen = sum(len(r.tokens) for r in reqs)
    return dict(generated_tokens=gen, seconds=wall, tokens_per_s=gen / wall,
                tpot_ms=spread(tpot), steps=len(steps),
                decode_step_ms=spread([s["ms"] for s in steps
                                       if not s["prefill"]]),
                pack_step_ms=spread([s["ms"] for s in steps
                                     if s["prefill"]]),
                **st, tokens_per_slot_step=1.0 + st["accepted"]
                / max(st["slot_steps"], 1),
                drafting_share=sum(s["drafting"] for s in steps)
                / max(st["slot_steps"], 1),
                acceptance_rate=st["accepted"] / max(st["drafted"], 1))


def run_spec_preempt(model, device, preempt: bool):
    """Three repetitive batch requests hold all but 8 blocks of a
    speculating engine; an interactive request needing 20 arrives at
    step ``SPEC_URGENT[2]``. With ``preempt`` the least-progressed batch
    request is spilled and resumed."""
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine
    prompts = spec_prompts(model.cfg.vocab_size)
    rng = np.random.default_rng(SEED + 31)
    plen, new, at = SPEC_URGENT
    eng = ServingEngine(model, preempt=preempt, device=device,
                        max_len=LLAMA_MAX_LEN, prefill_chunk=LLAMA_CHUNK,
                        block_size=LLAMA_BLOCK, cache_dtype=torch.int8,
                        seed=SEED, spec_depth=SPEC_DEPTH,
                        **SPEC_PREEMPT_KW)
    lo = [eng.submit(p, SamplingParams(max_tokens=SPEC_REQUESTS[2],
                                       priority=2))
          for p in prompts[0:2 * SPEC_PREEMPT_BATCH:2]]
    hi, n = None, 0
    while eng.has_work():
        check(n < 5_000, "llama_spec_preempt: the engine never drained")
        if n == at:
            hi = eng.submit(rng.integers(0, model.cfg.vocab_size,
                                         plen).tolist(),
                            SamplingParams(max_tokens=new, priority=0))
        eng.step()
        n += 1
    check(hi is not None and all(r.status == "done" for r in lo + [hi]),
          "llama_spec_preempt: requests unfinished")
    return eng, lo, hi


def phase_llama_spec(device, card, model):
    """Speculative decoding at Llama-7B width (bf16, int8 arena): the
    llama_engine's settings with ``spec_depth=4`` and the n-gram
    draftsman against the same engine without speculation, on
    ``spec_prompts`` (16 greedy requests, 512 + 128 tokens). Each engine's
    lanes captured once, exactly one #1 launch a layer per decode
    (verify) replay and #1 + #2 per prefill replay (counters zeroed just before
    each run and read just after); every request of both runs within the
    bf16 oracle's bounds; printed: tokens a slot-step (``1 + accepted /
    slot_steps``), the acceptance rate, TPOT, tokens/s, the decode-only
    steps' host ms and one decode replay's device ms, against spec-off.
    Then the acceptance sweep (drafts replayed from the spec-off run,
    corrupted at ``SPEC_CORRUPT``): with clean drafts no draft the oracle
    prefers to the engine's token by ``SPEC_CLEAN_GAP`` is rejected and
    the run holds the oracle; and the lane's own tokens (the corrupt-1.0
    run, each from row 0) replayed clean are all accepted, every token
    unchanged (row i of a verify computes what row 0 would): this is the
    check that catches a verify rule that rejects too much, since spec-off
    tokens differ from the lane's own at bf16 near-ties. Then a
    profile of steady verify decode, both engines' step splits, and one
    preemption with speculation against the same schedule without
    preemption (the victim's tokens bit-equal). Returns the speculating
    run's launch counts."""
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    cfg = model.cfg
    vocab = cfg.vocab_size
    t0 = time.perf_counter()
    prompts = spec_prompts(vocab)
    n, plen, new = SPEC_REQUESTS
    sp = SamplingParams(max_tokens=new)
    kw = dict(slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
              prefill_chunk=LLAMA_CHUNK, block_size=LLAMA_BLOCK,
              cache_dtype=torch.int8, seed=SEED, device=device,
              record_first_logits=True)
    runs = {}
    with autocast(BF16_FULL):
        for name, extra in (("spec_off", {}),
                            ("spec", dict(spec_depth=SPEC_DEPTH))):
            before = trace_counts()
            eng = ServingEngine(model, **kw, **extra)
            torch.cuda.synchronize()
            stats0 = dict(eng.spec_stats)
            # ---- the main path: counters zeroed just before, read after --
            reset_launch_counts()
            reqs, steps, wall = serve_stepped(eng, prompts, sp)
            counts = launch_counts()
            iters = dict(eng.lane_iters)
            # -------------------------------------------------------------
            check_captures(f"llama_{name}", eng, before)
            check_launches(f"llama_{name}_launches", counts, iters,
                           cfg.num_layers, paged="paged_attention_int8")
            reading = spec_reading(eng, reqs, steps, wall, stats0)
            reading["replay_device_ms"] = replay_device_ms(eng)
            reading["oracle"] = oracle(model, reqs, new, vocab)
            runs[name] = dict(eng=eng, reqs=reqs, counts=counts,
                              reading=reading)
        off, on = runs["spec_off"], runs["spec"]
        ref = {tuple(r.prompt.tolist()): list(r.tokens) for r in off["reqs"]}
        same = sum(list(r.tokens) == ref[tuple(r.prompt.tolist())]
                   for r in on["reqs"])
        emit(phase="llama_spec", card=card, config="LlamaConfig.llama_7b",
             dtype="bfloat16", cache_dtype="int8", spec_depth=SPEC_DEPTH,
             draft="ngram (n <= 3)", requests=n, prompt=plen,
             max_tokens=new, pattern=SPEC_PATTERN,
             verify_lane=eng.lanes["decode"].launches,
             spec=on["reading"], spec_off=off["reading"],
             requests_equal_to_spec_off=same,
             tpot_p50_speedup=off["reading"]["tpot_ms"]["p50"]
             / on["reading"]["tpot_ms"]["p50"],
             tokens_per_s_speedup=on["reading"]["tokens_per_s"]
             / off["reading"]["tokens_per_s"],
             dlogit_bound=DLOGIT_BF16, tie_bound=TIE_BF16)
        for name in ("spec_off", "spec"):
            check_held(f"llama_{name} against the oracle",
                       runs[name]["reading"]["oracle"], DLOGIT_BF16,
                       TIE_BF16)

        # ---- the acceptance sweep: the spec-off run's tokens replayed as
        # drafts, corrupted; then the lane's own tokens replayed clean ----
        eng, ngram = on["eng"], on["eng"]._draftsman
        own = None
        for source, frac in [("spec_off", f) for f in SPEC_CORRUPT] \
                + [("own", 0.0)]:
            table = ref if source == "spec_off" else own
            eng._draftsman = drafts = ReplayDrafts(table, plen, vocab, frac)
            stats0 = dict(eng.spec_stats)
            reqs, steps, wall = serve_stepped(eng, prompts, sp)
            if frac == 1.0:
                # (all but coincidences) every token from the lane's row 0
                own = {tuple(r.prompt.tolist()): list(r.tokens)
                       for r in reqs}
            line = dict(phase="llama_spec_sweep", drafts_from=source,
                        corrupt_frac=frac,
                        **spec_reading(eng, reqs, steps, wall, stats0),
                        requests_equal_to_drafts_source=sum(
                            list(r.tokens) == table[tuple(r.prompt.tolist())]
                            for r in reqs))
            if source == "spec_off" and frac == 0.0:
                logits = {}
                line["oracle"] = oracle(model, reqs, new, vocab, keep=logits)
                rej = rejected_drafts(drafts, reqs)
                gaps = [float(logits[r.id][t, d] - logits[r.id][t, g])
                        for r, t, d, g in rej]
                line.update(
                    rejected=len(rej),
                    rejected_oracle_best=sum(
                        int(logits[r.id][t].argmax()) == d
                        for r, t, d, _ in rej),
                    rejected_max_oracle_gap=max(gaps, default=0.0))
                del logits
            emit(**line)
            if source == "spec_off" and frac == 0.0:
                # a draft the oracle clearly prefers to the engine's
                # token is never rejected
                check(line["rejected_max_oracle_gap"] < SPEC_CLEAN_GAP,
                      f"llama_spec_sweep: a clean draft the oracle prefers "
                      f"by {line['rejected_max_oracle_gap']} was rejected")
                check_held("llama_spec_sweep clean drafts against the "
                           "oracle", line["oracle"], DLOGIT_BF16, TIE_BF16)
            if source == "own":
                check(line["accepted"] == line["drafted"]
                      and line["requests_equal_to_drafts_source"] == n,
                      f"llama_spec_sweep: the lane's own tokens as drafts: "
                      f"{line['accepted']} of {line['drafted']} accepted, "
                      f"{line['requests_equal_to_drafts_source']} of {n} "
                      f"requests unchanged")
        eng._draftsman = ngram
        check_captures("llama_spec_after_sweep", eng)

        # ---- sampled speculation with n-gram drafts, replayed ----
        ssp = [SamplingParams(max_tokens=64, temperature=0.7, seed=2000 + i)
               for i in range(n)]
        sampled = []
        for _ in range(2):
            stats0 = dict(eng.spec_stats)
            rs, st, w = serve_stepped(eng, prompts, ssp)
            sampled.append((rs, spec_reading(eng, rs, st, w, stats0)))
        (a, reading_s), (b, _) = sampled
        same_s = [r.tokens for r in a] == [r.tokens for r in b]
        in_vocab = all(0 <= t < vocab for r in a + b for t in r.tokens)
        emit(phase="llama_spec_sampled", temperature=0.7,
             draft="ngram (n <= 3)", max_tokens=64, **reading_s,
             replay_bit_equal=same_s, tokens_in_vocab=in_vocab)
        check(same_s, "llama_spec_sampled: the seeded replay differs")
        check(in_vocab, "llama_spec_sampled: a token past the vocabulary")
        check(reading_s["drafted"] > 0 and reading_s["resampled"] > 0,
              f"llama_spec_sampled: drafted {reading_s['drafted']}, "
              f"resampled {reading_s['resampled']}")
        del sampled, a, b
        check_captures("llama_spec_after_sampled", eng)

        # ---- where a verify step's time goes, beside spec-off's ----
        phase_profile(eng, prompts, SamplingParams(max_tokens=96),
                      phase="llama_spec_profile", classes=LLAMA_CLASSES,
                      steady_decode=True, decode_lane="tile")
        for name in ("spec", "spec_off"):
            phase_step_split(runs[name]["eng"], prompts,
                             SamplingParams(max_tokens=96),
                             f"llama_{name}_step_split")
        check_captures("llama_spec_after_profiles", eng)
    counts = on["counts"]
    del runs, on, off, eng, ngram
    gc.collect()
    release()

    # ---- one preemption with speculation ----
    t1 = time.perf_counter()
    with autocast(BF16_FULL):
        pre = {p: run_spec_preempt(model, device, p) for p in (False, True)}
    eng, lo, hi = pre[True]
    victims = [i for i, r in enumerate(lo) if r.preemptions]
    emit(phase="llama_spec_preempt", card=card, **SPEC_PREEMPT_KW,
         urgent=SPEC_URGENT, preemptions=eng.scheduler.preemptions_total,
         victims=[lo[i].id for i in victims],
         victim_prefill_chunks=[lo[i].timing()["prefill_chunks"]
                                for i in victims],
         victim_drafted_accepted=[(lo[i].drafted, lo[i].accepted)
                                  for i in victims],
         victim_tokens_equal_unpreempted=[
             lo[i].tokens == pre[False][1][i].tokens for i in victims],
         urgent_tokens_equal_unpreempted=hi.tokens == pre[False][2].tokens,
         urgent_ttft_ms=hi.timing()["ttft_ms"],
         unpreempted_urgent_ttft_ms=pre[False][2].timing()["ttft_ms"],
         seconds=time.perf_counter() - t1)
    check(victims and all(lo[i].resumed_blocks == lo[i].spilled_blocks >= 1
                          for i in victims),
          "llama_spec_preempt: no request was preempted and resumed")
    check(all(lo[i].timing()["prefill_chunks"] == plen // LLAMA_CHUNK
              for i in victims),
          "llama_spec_preempt: a resume ran prefill")
    check(all(lo[i].tokens == pre[False][1][i].tokens for i in victims),
          "llama_spec_preempt: a victim's tokens differ from the "
          "undisturbed speculating run's")
    for p, (e, _, _) in pre.items():
        check_captures(f"llama_spec_preempt_{p}", e)
    del pre, eng, lo, hi
    gc.collect()
    release()
    emit(phase="llama_spec_seconds", seconds=time.perf_counter() - t0)
    return counts


def phase_gpt2_spec(device, card):
    """GPT-2 small (fp32) drafting for itself (``draft_model=`` the
    target, as ``bench.py:421-423`` and ``tests/test_spec_qos.py``'s
    ``test_model_draftsman_greedy_parity``) at ``engine``'s settings with
    ``spec_depth=4``. The draft step and each lane captured exactly once;
    launches (counters zeroed just before the greedy run and read just
    after) exactly 12 #1 per decode (verify) and prefill replay plus 12 x
    K per draft step (the catch-up and K - 1 single-row decodes), 12 #2
    per prefill replay. Greedy tokens equal ``generate`` but at a near
    tie, acceptance above 0.8; at each temperature of ``SPEC_TEMPS``
    (per-request seeds) more than one token a slot-step, and a run in the
    swapped arrival order token-identical. Returns the greedy run's
    launch counts."""
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    t0 = time.perf_counter()
    cfg = GPTConfig.small()
    model = GPTLMHeadModel(cfg, device=device, seed=SEED).eval()
    n, lo_len, hi_len, new = GPT2_SPEC
    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(0, cfg.vocab_size, int(k)).tolist()
               for k in rng.integers(lo_len, hi_len + 1, n)]
    before = trace_counts()
    eng = ServingEngine(model, slots=16, max_len=512, prefill_chunk=64,
                        block_size=16, seed=SEED, device=device,
                        spec_depth=SPEC_DEPTH, draft_model=model)
    draft = eng._draftsman

    def captured():
        now = trace_counts()
        return {k: now.get(k, 0) - before.get(k, 0)
                for k in ("serving_decode", "serving_prefill",
                          "serving_draft_step")}

    once = {"serving_decode": 1, "serving_prefill": 1,
            "serving_draft_step": 1}
    check(captured() == once and draft.graph.captures == 1,
          f"gpt2_spec: captures after the build {captured()}")
    stats0 = dict(eng.spec_stats)
    # ---- the main path: counters zeroed just before, read after ----
    reset_launch_counts()
    steps0 = draft.steps
    reqs, steps, wall = serve_stepped(eng, prompts,
                                      SamplingParams(max_tokens=new))
    counts = launch_counts()
    iters = dict(eng.lane_iters)
    draft_steps = draft.steps - steps0
    # ---------------------------------------------------------------
    L = cfg.num_layers
    want = {"paged_attention": L * (iters["decode"] + iters["prefill"])
            + L * SPEC_DEPTH * draft_steps,
            "flash_fwd": L * iters["prefill"], "paged_attention_int8": 0}
    greedy = spec_reading(eng, reqs, steps, wall, stats0)
    emit(phase="gpt2_spec_launches", counts=counts, lane_iters=iters,
         draft_steps=draft_steps, expected=want)
    check(all(counts.get(k, 0) == v for k, v in want.items()),
          f"gpt2_spec: launches {counts}, expected {want}")
    generate_oracle("gpt2_spec_oracle", model, reqs, new, device)
    sampled = {}
    for temp in SPEC_TEMPS:
        sps = [SamplingParams(max_tokens=new, temperature=temp,
                              seed=1000 + i) for i in range(n)]
        stats0 = dict(eng.spec_stats)
        reqs, steps, wall = serve_stepped(eng, prompts, sps)
        reading = spec_reading(eng, reqs, steps, wall, stats0)
        swapped, _, _ = serve_stepped(eng, prompts[::-1], sps[::-1])
        reading["swapped_order_identical"] = [
            r.tokens for r in reqs] == [r.tokens for r in swapped[::-1]]
        sampled[temp] = reading
    emit(phase="gpt2_spec", card=card, config="GPTConfig.small",
         dtype="float32", spec_depth=SPEC_DEPTH, draft="model (itself)",
         draft_arena_blocks=draft.caches[0].shape[1],
         draft_table_width=draft.table_width, requests=n,
         prompt_tokens=[lo_len, hi_len], max_tokens=new, greedy=greedy,
         sampled={str(t): r for t, r in sampled.items()},
         captures=captured(), seconds=time.perf_counter() - t0)
    check(greedy["acceptance_rate"] > 0.8,
          f"gpt2_spec: greedy acceptance {greedy['acceptance_rate']}")
    for temp, r in sampled.items():
        check(r["tokens_per_slot_step"] > 1.0 and r["sampled_accepted"] > 0,
              f"gpt2_spec T={temp}: {r['tokens_per_slot_step']} tokens a "
              f"slot-step")
        check(r["swapped_order_identical"],
              f"gpt2_spec T={temp}: swapped arrival order changed tokens")

    # the engine's own prompts: most slots still catch up when they end
    long_prompts = workload(cfg.vocab_size)[0][:n]
    stats0 = dict(eng.spec_stats)
    reqs, steps, wall = serve_stepped(eng, long_prompts,
                                      SamplingParams(max_tokens=new))
    reading = spec_reading(eng, reqs, steps, wall, stats0)
    emit(phase="gpt2_spec_engine_prompts", requests=n,
         prompt_tokens=[min(map(len, long_prompts)),
                        max(map(len, long_prompts))],
         max_tokens=new, greedy=reading)
    generate_oracle("gpt2_spec_engine_prompts_oracle", model, reqs, new,
                    device)
    check(captured() == once, f"gpt2_spec: re-captured: {captured()}")
    del eng, draft, model
    gc.collect()
    release()
    return counts


def phase_llama_oracle_fp32(device):
    """The same engine and workload at fp32 and full width with 2 layers,
    every request against ``oracle``: first from an fp32 arena under the
    1e-4 rule, then from the int8 arena under DLOGIT_INT8_FP32 /
    TIE_INT8_FP32, with the planted faults read against the same bounds.
    Rounding in the int8 lane's inputs is amplified: fp32 k/v that differ
    in the last bits (the engine's packs and the oracle run other matmul
    shapes) flip codes by one step. That noise, measured without the
    engine, is printed beside: the oracle's first-token logits with the
    prompt in 256-token chunks against ``generate``'s one pass."""
    import dataclasses
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.models import LlamaConfig, LlamaLMHeadModel, generate
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    cfg = dataclasses.replace(LlamaConfig.llama_7b(), num_layers=2)
    model = LlamaLMHeadModel(cfg, device=device, seed=SEED).eval()
    burst, shared = llama_workload(cfg.vocab_size)
    new = 64
    for cache_dtype in (torch.float32, torch.int8):
        int8 = cache_dtype == torch.int8
        tag = str(cache_dtype).split(".")[1]
        t0 = time.perf_counter()
        engine_kw = dict(slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
                         prefill_chunk=LLAMA_CHUNK, block_size=LLAMA_BLOCK,
                         cache_dtype=cache_dtype, seed=SEED, device=device,
                         record_first_logits=True)
        before = trace_counts()
        eng = ServingEngine(model, **engine_kw)
        emit(phase="llama_fp32_engine_setup", cache_dtype=tag,
             layers=cfg.num_layers, lanes=capture_stats(eng))
        reset_launch_counts()
        run = serve(eng, burst, shared, SamplingParams(max_tokens=new))
        check_launches(f"llama_fp32_{tag}_launches", launch_counts(),
                       dict(eng.lane_iters), cfg.num_layers,
                       paged="paged_attention_int8" if int8
                       else "paged_attention")
        check_captures(f"llama_fp32_{tag}", eng, before)
        if not int8:
            phase_step_graph_replay(eng, "LlamaConfig.llama_7b width, 2 "
                                         "layers, fp32, fp32 arena")
        reqs = run["reqs"] + run["reqs2"]
        check(all(r.status == "done" for r in reqs),
              f"fp32 requests unfinished ({tag} arena)")
        del eng, run
        sound = oracle(model, reqs, new, cfg.vocab_size, cache_dtype)
        bounds = (DLOGIT_INT8_FP32, TIE_INT8_FP32) if int8 \
            else (TIE_FP32, TIE_FP32)
        line = dict(phase="llama_engine_oracle_fp32", dtype="float32",
                    cache_dtype=tag, layers=cfg.num_layers, **sound,
                    dlogit_bound=bounds[0], tie_bound=bounds[1])
        caught = {}
        if int8:
            multi = [r for r in reqs if len(r.prompt) > LLAMA_CHUNK][:8]
            line["oracle_chunked_vs_one_pass_max_abs_dlogit"] = max(
                max_err(forced_logits(model, r.prompt.tolist(), [0],
                                      torch.int8)[0],
                        generate(model, [r.prompt.tolist()],
                                 max_new_tokens=1, device=device,
                                 return_logits=True,
                                 cache_dtype=torch.int8)[1][0, 0])
                for r in multi)
        emit(**line, seconds=time.perf_counter() - t0)
        if int8:
            caught = fault_readings(model, engine_kw, bounds,
                                    "llama_engine_oracle_fp32_fault",
                                    torch.int8)
        check_held(f"fp32 engine ({tag} arena) against the oracle", sound,
                   *bounds)
        for fault, seen in caught.items():
            check(seen, f"the fp32 oracle passes a planted fault of the "
                        f"int8 lane ({fault})")
        del reqs
        gc.collect()
        release()
    del model
    gc.collect()
    release()


# -- Llama training ----------------------------------------------------------

#: the repo's Llama training benchmark (``workloads/bench_suite.py:139-167``,
#: config 3), its measured half: Llama-7B width, 2 layers, seq 2048,
#: batch 4, selective remat, AdamW(1e-4)
LLAMA_TRAIN_LAYERS = 2
LLAMA_TRAIN_SEQ = 2048
LLAMA_TRAIN_BATCH = 4
#: the SFT phase's (prompt, response) lengths (``examples/sft.py``'s flow
#: at Llama's seq): prompts 128-512, responses 128-1536 tokens
SFT_PAIRS = ((512, 1536), (128, 128), (300, 900), (200, 1400))


def llama_train_cfg(**kw):
    import dataclasses
    from hetu_tpu_torch.models import LlamaConfig
    kw = dict(dict(num_layers=LLAMA_TRAIN_LAYERS,
                   max_positions=LLAMA_TRAIN_SEQ), **kw)
    return dataclasses.replace(LlamaConfig.llama_7b(), **kw)


def llama_train_batch() -> dict:
    """The first batch of ``build_data_loader(SyntheticLMDataset(32000,
    seed=0), seq_len=2048, batch_rows=4, pack=True)`` (numpy arrays)."""
    from hetu_tpu_torch.data import SyntheticLMDataset, build_data_loader
    return next(build_data_loader(SyntheticLMDataset(32000, seed=0),
                                  seq_len=LLAMA_TRAIN_SEQ,
                                  batch_rows=LLAMA_TRAIN_BATCH, pack=True))


def phase_llama_train_oracle(device, fused: bool = False):
    """One fp32 step of Llama-7B's width (1 layer, vocab 32,000) with the
    kernels on the card against the plain path on the CPU
    (``hold_step``): one packed row of 256 tokens holding three
    documents and a pad tail, positions restarting at each. Launches:
    exactly one of each flash kernel. ``fused``
    (``llama_train_fused_oracle``): under ``HETU_LM_LOSS_IMPL=fused``,
    the LM head on the wide CUDA-core lane (fp32 h, E 4,096), and one
    launch of each fused kernel too."""
    from hetu_tpu_torch.data import pack_sequences, to_tensors
    from hetu_tpu_torch.models import LlamaLMHeadModel
    phase = "llama_train_fused_oracle" if fused else "llama_train_oracle"
    t0 = time.perf_counter()
    cfg = llama_train_cfg(num_layers=1)
    gpu = LlamaLMHeadModel(cfg, device=device, seed=SEED + 1)
    cpu = cpu_twin(gpu)
    rng = np.random.default_rng(SEED + 1)
    docs = [rng.integers(0, cfg.vocab_size, n) for n in (100, 80, 60)]
    batch = to_tensors(pack_sequences(docs, 256).as_batch())
    with fused_loss() if fused else contextlib.nullcontext():
        reading = hold_step(gpu, cpu, batch, device)
    emit(phase=phase, dtype="float32", layers=1, batch=1, seq=256,
         documents=len(docs), loss="fused" if fused else "chunked",
         **reading, seconds=time.perf_counter() - t0)
    check_step_held(phase, reading,
                    {**{k: 1 for k in FLASH},
                     **{k: int(fused) for k in FUSED}})
    del gpu, cpu
    gc.collect()
    release()


def timed_fit(trainer, run, steps: int, names=FLASH) -> dict:
    """``steps`` calls' worth of ``run(steps)`` (a ``Trainer.train`` or
    ``SFTTrainer.fit``), with the launch counters zeroed just before and
    read just after (those of ``names``); the wall time ends at a
    sync."""
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    reset_launch_counts()
    t0 = time.perf_counter()
    records = run(steps)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    return dict(records=records, dt=dt,
                counts=launches_of(launch_counts(), names))


def phase_llama_train(device, card, fused: bool = False,
                      beside: dict | None = None):
    """``Trainer.train`` over the first packed batch, repeated: 3 warm-up
    and 10 timed steps, bf16 compute over fp32 params. The loss must
    fall; each flash kernel must launch exactly twice a step. ``fused``
    (``llama_train_fused``): under ``HETU_LM_LOSS_IMPL=fused``, the LM
    head through #5-#7 on the wide tensor-core lane (E 4,096), each
    launched exactly once a step, printed ``beside`` the chunked run's
    figures."""
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.data import to_tensors
    from hetu_tpu_torch.engine import Trainer, TrainerConfig
    from hetu_tpu_torch.engine.trainer import flops_per_token
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.parallel import Strategy

    cfg = llama_train_cfg()
    model = LlamaLMHeadModel(cfg, device=device, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    # bench.py:133: 6N matmul flops per token + 6 L H s for attention
    fpt = flops_per_token(model, LLAMA_TRAIN_SEQ)
    trainer = Trainer(model, optim.adamw(1e-4),
                      Strategy(remat="selective", unroll=True),
                      config=TrainerConfig(precision="bf16", log_every=1,
                                           peak_flops=PEAK_FLOPS[
                                               torch.bfloat16]),
                      device=device)
    batch = llama_train_batch()
    phase = "llama_train_fused" if fused else "llama_train"
    names = FLASH + FUSED if fused else FLASH
    with fused_loss() if fused else contextlib.nullcontext():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm = trainer.train(itertools.repeat(batch), steps=3)
        warm_s = time.perf_counter() - t0
        trainer.config.log_every = 10         # one device read, at the end
        run = timed_fit(trainer, lambda n: trainer.train(
            itertools.repeat(batch), steps=n), 10, names)
    rec = run["records"][-1]
    L = cfg.num_layers
    want = {**{k: 10 * L for k in FLASH},
            **({k: 10 for k in FUSED} if fused else {})}
    tokens = LLAMA_TRAIN_BATCH * LLAMA_TRAIN_SEQ
    losses = [r["loss"] for r in warm] + [rec["loss"]]
    figures = dict(step_ms=run["dt"] * 1e3, tokens_per_s=tokens / run["dt"],
                   mfu=tokens / run["dt"] * fpt / PEAK_FLOPS[torch.bfloat16],
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit(phase=phase, card=card,
         config="LlamaConfig.llama_7b width, 2 layers", params=n_params,
         seq=LLAMA_TRAIN_SEQ, batch=LLAMA_TRAIN_BATCH,
         real_tokens=int((batch["labels"] != -100).sum()),
         documents=int(sum(len(np.unique(r)) - 1
                           for r in batch["segment_ids"])),
         policy="BF16_COMPUTE", remat="selective",
         loss="fused" if fused else "chunked", **figures,
         flops_per_token=fpt, trainer_record=rec,
         warmup_seconds=warm_s, losses_steps_1_2_3_13=losses,
         launches=run["counts"], expected=want,
         graphs=trainer_graphs(trainer),
         **({"chunked_llama_train": beside} if beside else {}))
    with fused_loss() if fused else contextlib.nullcontext():
        sync_free(phase, lambda: trainer._step_fn.body(
            trainer.state, to_tensors(batch)))
    check(all(np.isfinite(losses)), "non-finite Llama training loss")
    check(losses[-1] < losses[0], f"Llama loss did not fall: {losses}")
    check(run["counts"] == want, f"{phase} launches {run['counts']}, "
                                 f"expected {want}")
    return dict(trainer=trainer, batch=batch, counts=run["counts"],
                figures=figures)


def phase_llama_train_kernels(device, timer, ops, batch, results):
    """#2-#4 at the batch that ran: q (4, 32, 2048, 128) bf16, causal,
    its packed segment ids; first against their plain versions (and with
    dropout 0.1), each rerun bit-equal, then timed as
    ``phase_train_kernels`` times them. The bound counts this batch's
    live (q, k) pairs; the library yardstick is SDPA (``is_causal``, no
    segments)."""
    import torch.nn.functional as F
    gens = Generators(device, SEED + 3)
    seg = torch.from_numpy(batch["segment_ids"]).to(device)
    shape = dict(b=LLAMA_TRAIN_BATCH, hq=32, hkv=32, s=LLAMA_TRAIN_SEQ,
                 d=128, seg=None)
    dtype = torch.bfloat16
    scale = 128 ** -0.5
    errs = {n: {dtype: 0.0} for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    fwd_err = 0.0
    # the dropout case first: the no-dropout case's tensors stay for the
    # times
    for case, rate in (("llama_train_dropout", 0.1), ("llama_train", 0.0)):
        q, k, v, _ = flash_case(gens, device, dtype, **shape)
        do, out, lse, args = bwd_inputs(gens, q, True, scale, 0, 0, rate,
                                        seg, ops, k, v)
        got = ops.flash_attention_fwd(q, k, v, seg, seg, **args)
        again = ops.flash_attention_fwd(q, k, v, seg, seg, **args)
        torch.cuda.synchronize()
        err = max(max_err(got[0], out), max_err(got[1], lse))
        emit(phase="kernel", kernel="flash_fwd", case=case,
             dtype="bfloat16", shape=list(q.shape), max_abs_err=err,
             bound=TOL[dtype], ok=err <= TOL[dtype],
             rerun_bit_equal=check_rerun(case, got, again, "flash_fwd"))
        check(err <= TOL[dtype], f"flash_fwd {case}: {err}")
        fwd_err = max(fwd_err, err)
        del got, again
        got = ops.flash_attention_bwd(q, k, v, seg, seg, out, lse, do,
                                      **args)
        again = ops.flash_attention_bwd(q, k, v, seg, seg, out, lse, do,
                                        **args)
        check_rerun(case, got, again, "flash backward")
        del again
        want = ops.flash_attention_bwd_reference(q, k, v, seg, seg, out,
                                                 lse, do, **args)
        check_bwd("flash backward", case, dtype, list(q.shape), got, want,
                  errs)
        del got, want
        gc.collect()
        release()
    results["flash_fwd"]["max_abs_err_bf16"] = max(
        results["flash_fwd"]["max_abs_err_bf16"], fwd_err)
    for kernel in errs:
        results[kernel]["max_abs_err_bf16"] = max(
            results[kernel]["max_abs_err_bf16"], errs[kernel][dtype])

    # times, on the no-dropout case's q/k/v/dO/out/lse
    fwd = lambda: ops.flash_attention_fwd(q, k, v, seg, seg,  # noqa: E731
                                          causal=True, scale=scale)
    bwd = lambda: ops.flash_attention_bwd(  # noqa: E731
        q, k, v, seg, seg, out, lse, do, **args)
    reps, recorded = [], []
    for _ in range(3):
        f_ms, f_n = timer.per_kernel(fwd, ["flash_fwd_tc_kernel"])
        b_ms, b_n = timer.per_kernel(bwd, ["flash_bwd_dq_tc_kernel",
                                           "flash_bwd_dkv_tc_kernel"])
        reps.append({**f_ms, **b_ms})
        recorded.append({**f_n, **b_n})
    card = nvidia_smi()
    spread = {key: sorted(r[key] for r in reps) for key in reps[0]}
    for key, ms in spread.items():
        emit(phase="kernel_spread", kernel=key, case="llama_train",
             dtype="bfloat16", card=card, ms_min=ms[0], ms_median=ms[1],
             ms_max=ms[2], runs=[r[key] for r in reps],
             launches_recorded=[n[key] for n in recorded], launches=10)
    delta = (out.float() * do.float()).sum(-1)
    emit(phase="kernel_events", case="llama_train", dtype="bfloat16",
         card=card, fwd_ms=timer(fwd), bwd_ms=timer(
             lambda: ops.flash_attention_bwd(q, k, v, seg, seg, out, lse,
                                             do, delta=delta, **args)),
         profile_fwd_ms=spread["flash_fwd_tc_kernel"][1],
         profile_bwd_ms=spread["flash_bwd_dq_tc_kernel"][1]
         + spread["flash_bwd_dkv_tc_kernel"][1])
    del delta
    plain_fwd = timer(lambda: ops.flash_attention_fwd_reference(
        q, k, v, seg, seg, causal=True, scale=scale), iters=3)
    plain_bwd = timer(lambda: ops.flash_attention_bwd_reference(
        q, k, v, seg, seg, out, lse, do, **args), iters=3)
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             scale=scale)
    lib_bwd = timer(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do, retain_graph=True))
    lib_fwd_bwd = timer(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                       scale=scale), (qg, kg, vg), do))
    del lib_out
    nbytes, flops = flash_work(q, k, seg, True)
    (dq_b, dq_f), (dkv_b, dkv_f) = bwd_work(q, k, seg, True)
    for kernel, key, plain, lib, nb, fl in (
            ("flash_fwd", "flash_fwd_tc_kernel", plain_fwd, lib_fwd, nbytes,
             flops),
            ("flash_bwd_dq", "flash_bwd_dq_tc_kernel", plain_bwd, lib_bwd,
             dq_b, dq_f),
            ("flash_bwd_dkv", "flash_bwd_dkv_tc_kernel", plain_bwd, lib_bwd,
             dkv_b, dkv_f)):
        bound_ms, bound_by = bound(nb, fl, q.dtype)
        t = dict(ms=spread[key][1], ms_spread=spread[key], plain_ms=plain,
                 library_ms=lib, library_fwd_bwd_ms=lib_fwd_bwd,
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nb, flops=fl)
        emit(phase="kernel_time", kernel=kernel, case="llama_train",
             dtype="bfloat16", shape=list(q.shape), card=card, **t)
        results[kernel].update({f"llama_train_{k}": v for k, v in t.items()})
    emit(phase="kernel_note", note="llama_train: the bound counts the "
         "batch's live (q, k) pairs (causal within each segment, the pad "
         "tail its own segment); library = SDPA is_causal without "
         "segments: forward (library_ms of flash_fwd), backward via "
         "torch.autograd.grad (library_ms of dq, dk/dv), forward and "
         "backward (library_fwd_bwd_ms)")
    del q, k, v, do, out, lse, qg, kg, vg
    gc.collect()
    release()


def sft_pairs(vocab: int, seed: int = SEED):
    """``SFT_PAIRS``' four (prompt, response) pairs, random tokens from
    ``seed``, repeated to ten batches of four."""
    rng = np.random.default_rng(seed)
    pairs = [(rng.integers(1, vocab, p), rng.integers(1, vocab, r))
             for p, r in SFT_PAIRS]
    pairs = pairs * 10
    return [p for p, _ in pairs], [r for _, r in pairs]


def phase_llama_sft(device, card, pretrained):
    """``SFTTrainer.fit`` from the pretrained weights of ``llama_train``
    with ``resid_pdrop=0.1`` and ``chain(clip_by_global_norm(1.0),
    adamw(5e-4, weight_decay=0.01))`` (``examples/sft.py``): 10 steps at
    seq 2048, batch 4, ``shuffle=False``. The response-only loss must
    fall; each flash kernel must launch exactly twice a step."""
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.data import to_tensors
    from hetu_tpu_torch.engine import SFTTrainer, TrainerConfig, sft_batches
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.parallel import Strategy

    cfg = llama_train_cfg(resid_pdrop=0.1)
    model = LlamaLMHeadModel(cfg, device=device, seed=SEED)
    model.load_state_dict(pretrained)
    opt = optim.chain(optim.clip_by_global_norm(1.0),
                      optim.adamw(5e-4, weight_decay=0.01))
    trainer = SFTTrainer(model, opt, Strategy(remat="selective",
                                              unroll=True),
                         config=TrainerConfig(precision="bf16", log_every=1,
                                              peak_flops=PEAK_FLOPS[
                                                  torch.bfloat16]),
                         device=device)
    prompts, responses = sft_pairs(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    run = timed_fit(trainer, lambda n: trainer.fit(
        prompts, responses, seq_len=LLAMA_TRAIN_SEQ,
        batch_size=LLAMA_TRAIN_BATCH, steps=n, shuffle=False), 10)
    losses = [r["loss"] for r in run["records"]]
    L = cfg.num_layers
    want = {k: 10 * L for k in FLASH}
    emit(phase="llama_sft", card=card,
         config="LlamaConfig.llama_7b width, 2 layers, resid_pdrop 0.1",
         seq=LLAMA_TRAIN_SEQ, batch=LLAMA_TRAIN_BATCH,
         pairs=[list(p) for p in SFT_PAIRS],
         optimizer="chain(clip_by_global_norm(1.0), adamw(5e-4, wd 0.01))",
         step_ms=run["dt"] * 1e3, losses=losses,
         grad_norms_before_clip=[r["grad_norm"] for r in run["records"]],
         tokens_per_s=[r["tokens_per_sec"] for r in run["records"]][-1],
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches=run["counts"], expected=want,
         graphs=trainer_graphs(trainer))
    first = next(sft_batches(prompts, responses, seq_len=LLAMA_TRAIN_SEQ,
                             batch_size=LLAMA_TRAIN_BATCH, shuffle=False))
    sync_free("llama_sft", lambda: trainer._step_fn.body(
        trainer.state, to_tensors(first)))
    check(all(np.isfinite(losses)), "non-finite SFT loss")
    check(losses[-1] < losses[0], f"SFT loss did not fall: {losses}")
    check(run["counts"] == want, f"llama_sft launches {run['counts']}, "
                                 f"expected {want}")
    del trainer, model
    gc.collect()
    release()
    return run["counts"]


# -- GPT-MoE (BASELINE config 4) ----------------------------------------------
#: ``workloads/bench_suite.py:170-185 config4_moe``: moe_8e cut to 6 layers,
#: batch 8 at seq 1024
MOE_LAYERS, MOE_BATCH = 6, 8
#: kernels #5-#7 at the Llama training shape: N = 4 x 2,048 tokens, the
#: vocab of 32,000, E = 4,096, bf16 h and w (the wide tensor-core lane)
LLAMA_FUSED_SHAPE = (LLAMA_TRAIN_BATCH * LLAMA_TRAIN_SEQ, 32000, 4096)


def phase_llama_fused_kernel_times(device, timer, ops, results, launches):
    """#5-#7 at ``LLAMA_FUSED_SHAPE``: held against their plain versions
    (rerun bit-equal; dh and dw through the float64 yardstick of
    :func:`exact_fused_grad`, since this draw's softmax is peaky: at E
    4,096, w ~ N(0, 0.05^2), a row's largest p reaches 0.2), then timed as
    ``phase_fused_kernel_times`` times them: CUDA events over 3 calls, each after the L2-evicting write,
    beside the plain versions, one cuBLAS call for the logits product
    (``gemm_ms``), the port's ``chunked_lm_loss`` forward (#5's library
    figure) and forward and backward (#6's and #7's), and the bound (2NVE
    for #5, 4NVE for #6 and #7, on 989 TFLOP/s). ``launches`` are the
    fused training path's. The entries land under ``llama_train_shape``
    of each kernel's summary."""
    from hetu_tpu_torch.ops import chunked_lm_loss
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    n, vocab, e = LLAMA_FUSED_SHAPE
    h, w, lab, _, _ = fused_inputs(gen, device, n, vocab, torch.bfloat16,
                                   torch.bfloat16, e)
    lab[::7] = torch.randint(0, vocab, lab[::7].shape, generator=gen,
                             device=device, dtype=torch.int32)
    lab[3] = vocab - 1
    g = torch.full((n,), 1.0 / n, device=device)   # the mean loss's (g, -g)
    got, want = run_fused(ops, h, w, lab, g, -g)
    errs = {k: {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0} for k in FUSED}
    exact = {k: exact_fused_grad(h, w, lab, want[0], g, -g, k[-2:])
             for k in ("fused_ce_dh", "fused_ce_dw")}
    check_fused("llama_train", h, w, got, want, errs, exact)
    del exact
    lse = want[0]
    again = (*ops.fused_ce_fwd(h, w, lab),
             ops.fused_ce_dh(h, w, lab, lse, g, -g),
             ops.fused_ce_dw(h, w, lab, lse, g, -g))
    torch.cuda.synchronize()
    same = check_rerun("llama_train", got, again, kernel="fused_ce")
    emit(phase="kernel_rerun", kernel="fused_ce", case="llama_train",
         h_dtype="bfloat16", w_dtype="bfloat16", identical=same)
    del got, want, again
    gc.collect()
    release()

    calls = {"fused_ce_fwd": (lambda: ops.fused_ce_fwd(h, w, lab),
                              lambda: ops.fused_lse_tgt_reference(h, w, lab)),
             "fused_ce_dh": (lambda: ops.fused_ce_dh(h, w, lab, lse, g, -g),
                             lambda: ops.fused_ce_dh_reference(
                                 h, w, lab, lse, g, -g)),
             "fused_ce_dw": (lambda: ops.fused_ce_dw(h, w, lab, lse, g, -g),
                             lambda: ops.fused_ce_dw_reference(
                                 h, w, lab, lse, g, -g))}
    hid = h.view(LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ, e)
    y = lab.long().view(LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ)
    lib_fwd = timer(lambda: chunked_lm_loss(hid, w, y, mm_dt=torch.bfloat16),
                    iters=3, warmup=1)
    gemm_ms = timer(lambda: torch.mm(h, w.t(), out_dtype=torch.float32),
                    iters=3, warmup=1)
    gc.collect()
    release()
    hg, wg = hid.detach().requires_grad_(), w.detach().requires_grad_()
    lib_both = timer(lambda: chunked_lm_loss(
        hg, wg, y, mm_dt=torch.bfloat16).backward(), iters=3, warmup=1)
    del hg, wg
    base = (n * e + vocab * e) * 2 + n * 4          # h, w, labels
    work = {"fused_ce_fwd": (base + 2 * n * 4, 2.0 * n * vocab * e),
            "fused_ce_dh": (base + 3 * n * 4 + n * e * 2,
                            4.0 * n * vocab * e),
            "fused_ce_dw": (base + 3 * n * 4 + vocab * e * 2,
                            4.0 * n * vocab * e)}
    from hetu_tpu_torch.ops.fused_ce import wide_fwd_info
    fwd_plan = wide_fwd_info(n, vocab)
    for kernel, (fn, plain) in calls.items():
        ms = timer(fn, iters=3, warmup=1)
        plain_ms = timer(plain, iters=2, warmup=1)
        nbytes, flops = work[kernel]
        bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
        t = dict(ms=ms, plain_ms=plain_ms,
                 library_ms=lib_fwd if kernel == "fused_ce_fwd" else lib_both,
                 gemm_ms=gemm_ms, bound_ms=bound_ms, bound_by=bound_by,
                 bytes=nbytes, flops=flops,
                 lane=ops.fused_ce_lane(h.dtype, w.dtype, e),
                 launches=launches.get(kernel, 0),
                 max_abs_err_bf16=errs[kernel]["max_abs_err_bf16"],
                 **({"plan": fwd_plan} if kernel == "fused_ce_fwd" else {}))
        emit(phase="kernel_time", kernel=kernel, case="llama_train",
             dtype="bfloat16", shape=[n, vocab, e], **t)
        results[kernel]["llama_train_shape"] = dict(t, shape=[n, vocab, e])
        results[kernel]["max_abs_err_bf16"] = max(
            results[kernel]["max_abs_err_bf16"],
            errs[kernel]["max_abs_err_bf16"])


def state_copy(trainer) -> tuple:
    """Host copies of a trainer's params and optimizer state, by name."""
    names = {p: n for n, p in trainer.model.named_parameters()}
    params = {n: p.detach().to("cpu", copy=True)
              for n, p in trainer.model.named_parameters()}
    opt = {names[p]: {k: v.detach().to("cpu", copy=True)
                      if torch.is_tensor(v) else v for k, v in st.items()}
           for p, st in trainer.state.optimizer.state.items()}
    return params, opt


def states_equal(a, b) -> dict:
    """Which of params, moments and counts of two ``state_copy``s are bit
    for bit equal, and the names of those that differ."""
    (pa, oa), (pb, ob) = a, b
    bad = [n for n in pa if n not in pb or not torch.equal(pa[n], pb[n])]
    bad_opt = [f"{n}.{k}" for n in oa for k in oa[n]
               if n not in ob or k not in ob[n]
               or not (torch.equal(oa[n][k], ob[n][k])
                       if torch.is_tensor(oa[n][k]) else oa[n][k] == ob[n][k])]
    return dict(params=not bad and sorted(pa) == sorted(pb),
                optimizer=not bad_opt and sorted(oa) == sorted(ob),
                differ=(bad + bad_opt)[:8])


def phase_llama_ckpt(device, card):
    """Checkpoints on ``llama_train_fused``'s configuration (the fused
    loss, bf16 compute, fp32 params, AdamW): run A trains 10 steps
    without a stop; run B trains 5 with ``TrainerConfig(ckpt_dir=<a
    tempfile.mkdtemp() directory>, ckpt_every=5, async_ckpt=True)``,
    then a new model and Trainer ``resume`` from it and train 5 more.
    Steps 6-10's losses (each step logged) and the final params, moments
    and counts must be bit-equal to run A's; so must B's first 5 losses.
    Launches over the three runs: exactly 20 of each fused kernel and
    20 L of each flash kernel. Printed: the free disk, the bytes
    written, the save's blocking seconds (the snapshot), the write's
    seconds and the load's. 2 layers need about 8.0 GB of disk (667 M
    params x 12 B); with less than 12 GB free the phase runs at 1
    layer and says so. The directory is removed at the end."""
    import shutil
    import tempfile
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.engine import Trainer, TrainerConfig
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.parallel import Strategy

    root = tempfile.mkdtemp(prefix="hetu_ckpt_")
    free = shutil.disk_usage(root).free
    layers = LLAMA_TRAIN_LAYERS if free >= 12e9 else 1
    emit(phase="llama_ckpt_disk", free_bytes=free, layers=layers,
         cut_to_one_layer=layers != LLAMA_TRAIN_LAYERS)
    cfg = llama_train_cfg(num_layers=layers)
    batch = llama_train_batch()

    def trainer(**kw):
        model = LlamaLMHeadModel(cfg, device=device, seed=SEED)
        return Trainer(model, optim.adamw(1e-4),
                       Strategy(remat="selective", unroll=True),
                       config=TrainerConfig(precision="bf16", log_every=1,
                                            **kw), device=device)

    def losses(records):
        return [r["loss"] for r in records if "loss" in r]

    try:
        with fused_loss():
            reset_launch_counts()
            a = trainer()
            want = losses(a.train(itertools.repeat(batch), steps=10))
            final_a = state_copy(a)
            del a
            gc.collect()
            release()
            b = trainer(ckpt_dir=root, ckpt_every=5, async_ckpt=True)
            got = losses(b.train(itertools.repeat(batch), steps=5))
            save = b.last_save
            writer = save["writer"]
            del b
            gc.collect()
            release()
            c = trainer()
            t0 = time.perf_counter()
            c.resume(root)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            resumed_at = c.state.step
            got += losses(c.train(itertools.repeat(batch), steps=5))
            torch.cuda.synchronize()
            counts = launches_of(launch_counts(), FLASH + FUSED)
            same = states_equal(state_copy(c), final_a)
            steps = c.state.step
            del c
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    release()
    expect = {**{k: 20 * layers for k in FLASH}, **{k: 20 for k in FUSED}}
    emit(phase="llama_ckpt", card=card, layers=layers,
         config="LlamaConfig.llama_7b width", loss="fused",
         policy="BF16_COMPUTE", optimizer="adamw(1e-4)",
         saved_step=save["step"], resumed_at=resumed_at, final_step=steps,
         bytes_written=writer.nbytes, save_blocking_s=save["blocked_s"],
         snapshot_s=writer.snapshot_seconds,
         write_s=writer.write_seconds, load_s=load_s,
         losses_uninterrupted=want, losses_saved_then_resumed=got,
         losses_bit_equal=got == want, state_bit_equal=same,
         launches=counts, expected=expect)
    check(resumed_at == 5 and steps == 10,
          f"llama_ckpt: resumed at {resumed_at}, ended at {steps}")
    check(got == want, f"llama_ckpt: losses {got} against {want}")
    check(same["params"] and same["optimizer"],
          f"llama_ckpt: the resumed state differs: {same}")
    check(counts == expect, f"llama_ckpt launches {counts}, expected "
                            f"{expect}")
    return counts


# -- the captured training step (the step cache, buckets, accumulation) -------
#: llama_train_buckets' ladder, batches (4 rows each) and real lengths
LLAMA_BUCKETS = (512, 1024, 2048)
RAGGED_BATCHES = 12
RAGGED_MIN = 100


def bit_equal_step(got: dict, want: dict, a, b) -> list:
    """What differs between two steps' metrics (``loss``, ``grad_norm``)
    and two models' params, bit for bit (names; empty when equal)."""
    bad = [k for k in ("loss", "grad_norm")
           if k in want and not torch.equal(got[k], want[k])]
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        if not torch.equal(p, q):
            bad.append(n)
    return bad


def time_steps(fn, n: int) -> float:
    """Mean ms of ``n`` calls of ``fn`` between two syncs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_train_capture(device, card, b):
    """The captured step against its eager body: GPT-2 small at the
    ``train`` phase's batch ``b`` (bf16 compute, selective remat, AdamW),
    once with dropout 0 and once with ``attn_pdrop = resid_pdrop = 0.1``.
    Ten steps through ``Trainer.train_step`` (captured) and ten of
    ``TrainStep.body`` (eager) on a twin model from the same seed, on
    ten batches: ``loss``, ``grad_norm`` and every param bit-equal after
    every step; exactly one ``train_step`` capture; flash launches 12
    each a step. Then the step ms of each (5 steps between syncs) and
    each one's device idle share (``phase_train_profile``). Returns the
    captured steps' launch counts of each run."""
    import dataclasses
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.core import BF16_COMPUTE, autocast
    from hetu_tpu_torch.engine import (
        Trainer, TrainerConfig, build_train_step, init_state, make_plan,
        trace_counts,
    )
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.parallel import Strategy

    paths = {}
    for drop in (0.0, 0.1):
        t0 = time.perf_counter()
        phase = "train_capture" + ("_dropout" if drop else "")
        cfg = dataclasses.replace(GPTConfig.small(), attn_pdrop=drop,
                                  resid_pdrop=drop)
        strategy = Strategy(remat="selective", unroll=True)
        opt = optim.adamw(1e-4, weight_decay=0.01)
        model = GPTLMHeadModel(cfg, device=device, seed=SEED)
        twin = GPTLMHeadModel(cfg, device=device, seed=SEED)
        tr = Trainer(model, opt, strategy,
                     config=TrainerConfig(precision="bf16", log_every=0,
                                          prefetch=0), device=device)
        tr.initialize()
        with autocast(BF16_COMPUTE):
            plan = make_plan(twin, opt, strategy, device=device)
        tstate = init_state(twin, opt, plan)
        tstep = build_train_step(twin, opt, plan)
        before = trace_counts().get("train_step", 0)
        flash = {k: 0 for k in FLASH}
        differ, losses = [], []
        for i in range(10):
            batch = train_batch(cfg.vocab_size, b, device, seed=SEED + 10 + i)
            reset_launch_counts()
            m = tr.train_step(batch)
            for k, v in launches_of(launch_counts()).items():
                flash[k] += v
            if i == 0:
                tstate, tm = sync_free(phase, lambda: tstep.body(tstate,
                                                                 batch))
            else:
                tstate, tm = tstep.body(tstate, batch)
            bad = bit_equal_step(m, tm, model, twin)
            if bad:
                differ.append([i + 1, bad[:4]])
            losses.append(float(m["loss"]))
        captures = trace_counts().get("train_step", 0) - before
        batch = train_batch(cfg.vocab_size, b, device, seed=SEED + 99)
        captured_ms = time_steps(lambda: tr._step_fn(tr.state, batch), 5)
        eager_ms = time_steps(lambda: tstep.body(tstate, batch), 5)
        emit(phase=phase, card=card, config="GPTConfig.small", batch=b,
             seq=TRAIN_SEQ, attn_pdrop=drop, resid_pdrop=drop,
             policy="BF16_COMPUTE", remat="selective", steps=10,
             bit_equal_steps=10 - len(differ), differ=differ[:3],
             train_step_captures=captures, graphs=trainer_graphs(tr),
             launches=flash, losses=losses,
             step_ms_captured=captured_ms, step_ms_eager=eager_ms,
             seconds=time.perf_counter() - t0)
        check(not differ, f"{phase}: the captured steps differ from the "
                          f"eager body at {differ[:3]}")
        check(captures == 1, f"{phase}: {captures} train_step captures")
        check(flash == {k: 10 * cfg.num_layers for k in FLASH},
              f"{phase}: launches {flash}")
        check(all(np.isfinite(losses)), f"{phase}: non-finite loss")
        phase_train_profile(dict(state=tr.state, step=tr._step_fn,
                                 batch=batch, batch_size=b),
                            phase=phase + "_profile")
        phase_train_profile(dict(state=tstate, step=tstep.body,
                                 batch=batch, batch_size=b),
                            phase=phase + "_eager_profile")
        paths[phase] = flash
        del tr, model, twin, tstate, tstep
        release()
    return paths


def ragged_llama_batches(vocab: int, n: int, seed: int) -> list:
    """``n`` batches of ``LLAMA_TRAIN_BATCH`` rows at width
    ``LLAMA_TRAIN_SEQ`` (pad-to-max), each row's real length drawn from
    ``seed`` over ``RAGGED_MIN``..2,048: batch j's longest row falls in
    bucket j mod 3 of ``LLAMA_BUCKETS``, so every bucket is hit. Labels
    are the next tokens, -100 past the real length."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        cap = LLAMA_BUCKETS[j % len(LLAMA_BUCKETS)]
        low = ([RAGGED_MIN - 1] + list(LLAMA_BUCKETS))[j % len(LLAMA_BUCKETS)]
        lens = rng.integers(RAGGED_MIN, cap + 1, LLAMA_TRAIN_BATCH)
        lens[0] = rng.integers(low + 1, cap + 1)
        ids = rng.integers(0, vocab, (LLAMA_TRAIN_BATCH,
                                      LLAMA_TRAIN_SEQ + 1)).astype(np.int32)
        labels = np.full((LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ), -100, np.int32)
        for r, n_real in enumerate(lens):
            labels[r, :n_real] = ids[r, 1:n_real + 1]
        out.append({"input_ids": ids[:, :-1].copy(), "labels": labels})
    return out


def llama_twin(cfg, opt, strategy, device):
    """A second model from the same seed, its state and its step: the
    eager body the captured steps are held to."""
    from hetu_tpu_torch.core import BF16_COMPUTE, autocast
    from hetu_tpu_torch.engine import build_train_step, init_state, make_plan
    from hetu_tpu_torch.models import LlamaLMHeadModel
    model = LlamaLMHeadModel(cfg, device=device, seed=SEED)
    with autocast(BF16_COMPUTE):
        plan = make_plan(model, opt, strategy, device=device)
    return model, init_state(model, opt, plan), build_train_step(model, opt,
                                                                 plan)


def phase_llama_train_buckets(device, card):
    """Ragged pretraining through ``Trainer(seq_buckets=(512, 1024,
    2048))``: Llama-7B width, 2 layers, bf16 compute, selective remat,
    ``chain(clip_by_global_norm(1.0), adamw(1e-4))``, 12 ragged batches
    of 4 rows (``ragged_llama_batches``), then a second pass over them.
    Exactly 3 ``train_step`` captures in the first pass and none in the
    second; every step bit-equal to the eager body on a twin (its
    batches fitted by a ``ShapeBucketer`` of the same ladder). Printed:
    the bucket stats, each bucket's step ms (second pass), tokens/s and
    pool bytes, and the same batches padded to 2,048 through one entry
    (the pad-to-max comparison). Returns the captured steps' launch
    counts."""
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.data import SeqLenBuckets, ShapeBucketer, to_tensors
    from hetu_tpu_torch.engine import Trainer, TrainerConfig, trace_counts
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.parallel import Strategy

    t0 = time.perf_counter()
    release()
    reserved = {"before": torch.cuda.memory_reserved()}
    cfg = llama_train_cfg()
    strategy = Strategy(remat="selective", unroll=True)
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(1e-4))
    model = LlamaLMHeadModel(cfg, device=device, seed=SEED)
    tr = Trainer(model, opt, strategy,
                 config=TrainerConfig(precision="bf16", log_every=0,
                                      prefetch=0,
                                      seq_buckets=LLAMA_BUCKETS),
                 device=device)
    tr.initialize()
    twin, tstate, tstep = llama_twin(cfg, opt, strategy, device)
    fitter = ShapeBucketer(SeqLenBuckets(sizes=LLAMA_BUCKETS))
    batches = ragged_llama_batches(cfg.vocab_size, RAGGED_BATCHES, SEED + 7)
    captures, differ, losses = [], [], []
    per_bucket: dict = {}
    flash = {k: 0 for k in FLASH}
    for pas in (1, 2):
        before = trace_counts().get("train_step", 0)
        for j, batch in enumerate(batches):
            fitted = fitter.fit(batch)
            width = int(fitted["input_ids"].shape[1])
            torch.cuda.synchronize()
            reset_launch_counts()
            t1 = time.perf_counter()
            m = tr.train_step(batch)
            torch.cuda.synchronize()
            for k, v in launches_of(launch_counts()).items():
                flash[k] += v
            if pas == 2:
                rec = per_bucket.setdefault(width, {"ms": [], "tokens": 0})
                rec["ms"].append((time.perf_counter() - t1) * 1e3)
                rec["tokens"] += int((batch["labels"] != -100).sum())
            fitted = to_tensors(fitted, device)
            step = lambda: tstep.body(tstate, fitted)
            tstate, tm = sync_free("llama_train_buckets", step) \
                if pas == 1 and j == 0 else step()
            bad = bit_equal_step(m, tm, model, twin)
            if bad:
                differ.append([pas, j, bad[:4]])
            losses.append(float(m["loss"]))
        captures.append(trace_counts().get("train_step", 0) - before)
    graphs = trainer_graphs(tr)
    buckets = {str(w): dict(
        steps=len(r["ms"]), step_ms=sum(r["ms"]) / len(r["ms"]),
        real_tokens=r["tokens"],
        real_tokens_per_s=r["tokens"] / (sum(r["ms"]) / 1e3),
        pool_bytes=graphs[str(w)]["pool_bytes"])
        for w, r in sorted(per_bucket.items())}
    bucketed_ms = sum(sum(r["ms"]) for r in per_bucket.values())
    # the same batches padded to 2,048 through the 2,048 entry
    full = tr._bucket_entry(LLAMA_TRAIN_SEQ).step_fn
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for batch in batches:
        tr.state, _ = full(tr.state, to_tensors(batch, device))
    torch.cuda.synchronize()
    padded_ms = (time.perf_counter() - t1) * 1e3
    real = sum(int((b["labels"] != -100).sum()) for b in batches)
    # the three buckets' graphs share one pool: its bytes, then what
    # closing the Trainer gives back (all else alive)
    pool_total = sum(g["pool_bytes"] for g in graphs.values())
    del full, twin, tstate, tstep
    release()
    reserved["trained"] = torch.cuda.memory_reserved()
    tr.close()
    release()
    reserved["closed"] = torch.cuda.memory_reserved()
    freed = reserved["trained"] - reserved["closed"]
    emit(phase="llama_train_buckets", card=card,
         config="LlamaConfig.llama_7b width, 2 layers", policy="BF16_COMPUTE",
         remat="selective", optimizer="chain(clip_by_global_norm(1.0), "
         "adamw(1e-4))", seq_buckets=list(LLAMA_BUCKETS),
         batches=RAGGED_BATCHES, rows=LLAMA_TRAIN_BATCH,
         train_step_captures_by_pass=captures,
         bit_equal_steps=2 * RAGGED_BATCHES - len(differ),
         differ=differ[:3], bucket_stats=tr.bucketer.stats.to_record(),
         by_bucket=buckets, graphs=graphs,
         pass2_bucketed_ms=bucketed_ms, pad_to_max_ms=padded_ms,
         pass2_real_tokens_per_s=real / (bucketed_ms / 1e3),
         pad_to_max_real_tokens_per_s=real / (padded_ms / 1e3),
         losses=losses, peak_memory_bytes=torch.cuda.max_memory_allocated(),
         shared_pool_bytes=pool_total, reserved_bytes=reserved,
         freed_by_close_bytes=freed, launches=flash,
         seconds=time.perf_counter() - t0)
    check(flash == {k: 2 * RAGGED_BATCHES * cfg.num_layers for k in FLASH},
          f"llama_train_buckets: launches {flash}")
    check(freed >= 0.9 * pool_total > 0,
          f"llama_train_buckets: closing the Trainer gave back {freed} "
          f"bytes of its {pool_total}-byte pool")
    check(captures == [3, 0], f"llama_train_buckets: captures by pass "
                              f"{captures}, expected [3, 0]")
    check(sorted(per_bucket) == list(LLAMA_BUCKETS),
          f"llama_train_buckets: buckets hit {sorted(per_bucket)}")
    check(not differ, f"llama_train_buckets: the captured steps differ "
                      f"from the eager body at {differ[:3]}")
    check(all(np.isfinite(losses)), "llama_train_buckets: non-finite loss")
    del tr, model
    release()
    return flash, losses


def phase_llama_grad_accum(device, card):
    """Split-phase accumulation (``build_grad_accum_steps``) at Llama-7B
    width, 2 layers: four ``grad_step``s (one packed row each,
    ``accum_index`` 0-3) and one ``apply_step`` against one step of
    ``Strategy(num_microbatches=4)`` on the same 4-row batch, from twin
    models. The params after the update must be bit-equal (the sums run
    in one order); else within 1e-6 of the largest |param change|.
    Then a second update with ``donate_acc=False`` recycling the
    accumulator (``init_acc(like=acc)``): ``torch.cuda.memory_allocated``
    must not move across it, and each entry captures once. The
    microbatched step and one grad step's body run once eagerly under
    the sync check first."""
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.core import BF16_COMPUTE, autocast
    from hetu_tpu_torch.data import to_tensors
    from hetu_tpu_torch.engine import (
        build_grad_accum_steps, init_state, make_plan, trace_counts,
    )
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.parallel import Strategy

    t0 = time.perf_counter()
    cfg = llama_train_cfg()
    opt = optim.adamw(1e-4)
    batch = to_tensors(llama_train_batch(), device)
    nm = LLAMA_TRAIN_BATCH
    one, state1, step1 = llama_twin(
        cfg, opt, Strategy(remat="selective", unroll=True,
                           num_microbatches=nm), device)
    before = [p.detach().clone() for p in one.parameters()]
    state1, m1 = sync_free("llama_grad_accum", lambda: step1.body(state1,
                                                                  batch))
    model = LlamaLMHeadModel(cfg, device=device, seed=SEED)
    strategy = Strategy(remat="selective", unroll=True)
    with autocast(BF16_COMPUTE):
        plan = make_plan(model, opt, strategy, device=device)
    state = init_state(model, opt, plan)
    init_acc, grad_step, apply_step = build_grad_accum_steps(
        model, opt, plan, donate_acc=False)
    traces = trace_counts()
    rows = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(nm)]
    init_acc()
    sync_free("llama_grad_accum_grad_step",
              lambda: grad_step.entry.run_eager(rows[0]))
    reset_launch_counts()
    acc = init_acc()
    mb_losses = []
    for i, row in enumerate(rows):
        acc, loss = grad_step(state, acc, row, accum_index=i)
        mb_losses.append(float(loss))
    state, m = apply_step(state, acc, nm)
    worst, largest, bad = 0.0, 0.0, []
    for (n, p), q, p0 in zip(model.named_parameters(), one.parameters(),
                             before):
        largest = max(largest,
                      float((q.detach().float() - p0.float()).abs().max()))
        if not torch.equal(p, q):
            bad.append(n)
            worst = max(worst, float((p.float() - q.float()).abs().max()))
    gnorm_equal = torch.equal(m["grad_norm"], m1["grad_norm"])
    # a second update recycling the accumulator: no allocation
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    acc = init_acc(like=acc)
    for i, row in enumerate(rows):
        acc, loss = grad_step(state, acc, row, accum_index=i)
    state, m = apply_step(state, acc, nm)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    flash = launches_of(launch_counts())
    now = trace_counts()
    caps = {k: now.get(k, 0) - traces.get(k, 0)
            for k in ("grad_step", "apply_step")}
    emit(phase="llama_grad_accum", card=card,
         config="LlamaConfig.llama_7b width, 2 layers",
         policy="BF16_COMPUTE", remat="selective", optimizer="adamw(1e-4)",
         microbatches=nm, rows_per_grad_step=1,
         params_bit_equal=not bad, params_differ=bad[:4],
         max_abs_param_diff=worst, largest_param_change=largest,
         bound=1e-6 * largest, grad_norm_bit_equal=gnorm_equal,
         loss_in_step=float(m1["loss"]),
         mean_grad_step_loss=sum(mb_losses) / nm,
         memory_allocated_before=mem0, memory_allocated_after=mem1,
         captures=caps, grad_step_graphs=graph_info(grad_step),
         apply_step_graphs=graph_info(apply_step), launches=flash,
         seconds=time.perf_counter() - t0)
    check(flash == {k: 2 * nm * cfg.num_layers for k in FLASH},
          f"llama_grad_accum: launches {flash}")
    check(worst <= 1e-6 * largest, f"llama_grad_accum: params differ by "
                                   f"{worst} (bound {1e-6 * largest})")
    check(mem1 == mem0, f"llama_grad_accum: init_acc(like=) moved "
                        f"memory_allocated {mem0} -> {mem1}")
    check(caps == {"grad_step": 1, "apply_step": 1},
          f"llama_grad_accum: captures {caps}")
    del model, one, state, state1, step1, acc
    release()
    return flash


def phase_llama_train_adafactor(device, card):
    """``adafactor(inverse_sqrt(1e-3, warmup_steps=3))`` at Llama-7B
    width, 2 layers, bf16 compute, through ``Trainer.train_step``: 10
    captured steps on the packed batch, each bit-equal to the eager body
    on a twin; the loss must fall. Then one fp16-scaler step on the
    trainer's model with an ``inf`` planted in one grad, under
    ``set_sync_debug_mode("error")``: ``unscale_and_check`` reads not
    finite, ``update_scaler`` halves the scale, and the update, gated on
    ``finite`` on the device, leaves every param as it was."""
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.core import BF16_COMPUTE, autocast
    from hetu_tpu_torch.data import to_tensors
    from hetu_tpu_torch.engine import Trainer, TrainerConfig
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.parallel import Strategy

    t0 = time.perf_counter()
    cfg = llama_train_cfg()
    strategy = Strategy(remat="selective", unroll=True)
    opt = optim.adafactor(optim.inverse_sqrt(1e-3, warmup_steps=3))
    model = LlamaLMHeadModel(cfg, device=device, seed=SEED)
    tr = Trainer(model, opt, strategy,
                 config=TrainerConfig(precision="bf16", log_every=0,
                                      prefetch=0), device=device)
    tr.initialize()
    twin, tstate, tstep = llama_twin(cfg, opt, strategy, device)
    batch = to_tensors(llama_train_batch(), device)
    differ, losses = [], []
    flash = {k: 0 for k in FLASH}
    for i in range(10):
        reset_launch_counts()
        m = tr.train_step(batch)
        for k, v in launches_of(launch_counts()).items():
            flash[k] += v
        step = lambda: tstep.body(tstate, batch)
        tstate, tm = sync_free("llama_train_adafactor", step) if i == 0 \
            else step()
        bad = bit_equal_step(m, tm, model, twin)
        if bad:
            differ.append([i + 1, bad[:4]])
        losses.append(float(m["loss"]))
    graphs = trainer_graphs(tr)
    del twin, tstate, tstep
    release()
    # the fp16 scaler: a planted inf skips the update and halves the scale
    params = [p for p in model.parameters() if p.requires_grad]
    kept = [p.detach().clone() for p in params]
    scaler = optim.init_scaler(2.0 ** 16, device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    with autocast(BF16_COMPUTE):
        loss = model.loss(batch["input_ids"], batch["labels"],
                          positions=batch.get("positions"),
                          segment_ids=batch.get("segment_ids"),
                          remat="selective")
    grads = list(torch.autograd.grad(optim.scale_loss(scaler, loss), params))
    grads[0] = grads[0].clone()
    grads[0].view(-1)[:1].fill_(float("inf"))
    grads, finite = optim.unscale_and_check(scaler, grads)
    new = optim.update_scaler(scaler, finite)
    opt.stage(tr.state.optimizer, tr.state.step)
    opt.update(tr.state.optimizer, dict(zip(params, grads)))
    with torch.no_grad():
        for p, k in zip(params, kept):
            p.copy_(torch.where(finite, p, k))
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    unchanged = all(torch.equal(p, k) for p, k in zip(params, kept))
    emit(phase="llama_train_adafactor", card=card,
         config="LlamaConfig.llama_7b width, 2 layers",
         policy="BF16_COMPUTE", remat="selective",
         optimizer="adafactor(inverse_sqrt(1e-3, warmup_steps=3))",
         steps=10, bit_equal_steps=10 - len(differ), differ=differ[:3],
         losses=losses, graphs=graphs,
         scaler_finite=bool(finite), scale_before=float(scaler.scale),
         scale_after=float(new.scale),
         tracker_after=int(new.growth_tracker),
         params_unchanged_after_inf=unchanged, launches=flash,
         seconds=time.perf_counter() - t0)
    check(flash == {k: 10 * cfg.num_layers for k in FLASH},
          f"llama_train_adafactor: launches {flash}")
    check(not differ, f"llama_train_adafactor: the captured steps differ "
                      f"from the eager body at {differ[:3]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"llama_train_adafactor: losses {losses}")
    check(graphs["0"]["captures"] == 1,
          f"llama_train_adafactor: graphs {graphs}")
    check(not bool(finite) and float(new.scale) == 2.0 ** 15 and unchanged,
          "llama_train_adafactor: the planted inf did not skip the update "
          "and halve the scale")
    del tr, model, params, kept, grads
    release()
    return flash


MOE_GATES = ("topk", "ktop1", "sam", "balance")
MOE_ORACLE_SEQ = 256
#: a routing decision whose score gap is under this may flip on rounding
NEAR_TIE = 1e-4
#: the MoE serving oracle's decode chunk: the gathered expert weights of
#: a chunk of C tokens take C x 2 x 9.4 MB each at moe_8e's fp32 width
MOE_CHUNK = 64


def moe_cfg(**kw):
    """``GPTConfig.moe_8e`` (GPT-2 small's widths, 8 GELU experts, top-2)
    with ``kw`` replaced."""
    import dataclasses
    from hetu_tpu_torch.models import GPTConfig
    return dataclasses.replace(GPTConfig.moe_8e(), **kw)


def moe_model(cfg, device, seed):
    """A GPT-MoE model; the balance gate's k-downgrade warning (it is
    top-1 by construction) is expected here."""
    import warnings
    from hetu_tpu_torch.models import GPTLMHeadModel
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return GPTLMHeadModel(cfg, device=device, seed=seed)


class RoutingSpy:
    """Forward hooks on every MoE gate of a model, recording each call's
    routing (idx, on the host) and, with ``margins``, each row's
    decision margin (``nn.moe.routing_margins``). Eager use only: the
    hooks read the device."""

    def __init__(self, model, margins: bool = False):
        from hetu_tpu_torch.nn.moe import MoEMLP, routing_margins
        self.calls = []

        def hook(gate, args, out):
            m = routing_margins(gate, args[0]).cpu() if margins else None
            self.calls.append((out[0].cpu(), m))

        self.handles = [mod.gate.register_forward_hook(hook)
                        for mod in model.modules()
                        if isinstance(mod, MoEMLP)]

    def close(self) -> list:
        for h in self.handles:
            h.remove()
        return self.calls


def routing_split(got, want, margins):
    """Rows routed differently by two runs of one gate call (idx (T, k)
    each), and the rows within ``NEAR_TIE`` of a routing tie
    (``margins`` of the reference run): the callers fail a difference
    off a near-tie."""
    differ = (got != want).any(-1)
    near = margins < NEAR_TIE
    return differ, near


def phase_moe_train_oracle(device):
    """One fp32 step of ``moe_8e``'s width at 1 layer with each gate
    (topk, ktop1, sam with 2 groups, balance), the kernels on the card
    against the plain path on the CPU (``hold_step``), at batch 1 x 256.
    The routing is compared first: the tokens routed differently must
    all lie within ``NEAR_TIE`` of a tie (their count and the near-ties'
    are printed), and their labels are masked out of the step, so loss
    and grads are compared on the tokens routed alike (with one layer a
    token's experts reach no other token's loss). Bounds of
    ``train_oracle``; exactly one launch of each flash kernel."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the gates' fp32 product would round to TF32")
    for gate in MOE_GATES:
        t0 = time.perf_counter()
        cfg = moe_cfg(num_layers=1, moe_gate=gate,
                      moe_num_groups=2 if gate == "sam" else 0)
        gpu = moe_model(cfg, device, SEED + 1)
        cpu = moe_model(cfg, "cpu", SEED + 1)
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        batch = train_batch(cfg.vocab_size, 1, "cpu", seed=SEED + 1,
                            seq=MOE_ORACLE_SEQ)
        routes = {}
        for name, model, dev in (("gpu", gpu, device), ("cpu", cpu, "cpu")):
            spy = RoutingSpy(model, margins=name == "cpu")
            with torch.no_grad():
                model.loss(batch["input_ids"].to(dev),
                           batch["labels"].to(dev))
            routes[name] = spy.close()
        check(len(routes["gpu"]) == len(routes["cpu"]) == 1,
              f"moe_train_oracle {gate}: gate calls {len(routes['gpu'])}, "
              f"{len(routes['cpu'])}")
        (g_idx, _), (c_idx, margins) = routes["gpu"][0], routes["cpu"][0]
        differ, near = routing_split(g_idx, c_idx, margins)
        check(bool((~differ | near).all()),
              f"moe_train_oracle {gate}: {int((differ & ~near).sum())} "
              f"tokens routed differently off a near-tie")
        batch["labels"][0, differ] = -100
        reading = hold_step(gpu, cpu, batch, device)
        emit(phase="moe_train_oracle", gate=gate, dtype="float32",
             layers=1, hidden=cfg.hidden_size, experts=cfg.num_experts,
             k=gpu.blocks[0].mlp.k, batch=1, seq=MOE_ORACLE_SEQ,
             near_ties=int(near.sum()), routed_differently=int(differ.sum()),
             min_margin=float(margins.min()), **reading,
             seconds=time.perf_counter() - t0)
        check_step_held(f"moe_train_oracle {gate}", reading,
                        {**{k: 1 for k in FLASH}, **{k: 0 for k in FUSED}})
        del gpu, cpu
        gc.collect()
        release()


def phase_moe_train(device, card):
    """BASELINE config 4 through ``Trainer.train``: ``moe_8e`` at 6
    layers, batch 8, seq 1024, fp32 params with bf16 compute,
    ``Strategy(unroll=True)`` (no remat), ``adamw(1e-4)``, one random
    batch repeated: 3 warm-up and 10 timed steps. The loss must fall;
    each flash kernel must launch exactly 6 times a step. MFU on the
    active params (expert tensors at k/E, ``bench_suite.py:88-103``)
    against 989 TFLOP/s, beside the Trainer's own all-params figure."""
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.data import to_tensors
    from hetu_tpu_torch.engine import Trainer, TrainerConfig
    from hetu_tpu_torch.parallel import Strategy

    cfg = moe_cfg(num_layers=MOE_LAYERS)
    model = moe_model(cfg, device, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = sum(p.numel() for n, p in model.named_parameters()
                   if n.rsplit(".", 1)[-1] in ("wi", "wg", "wo"))
    n_active = n_params - n_expert * (1 - cfg.moe_top_k / cfg.num_experts)
    L = cfg.num_layers
    # bench.py:133 on the active params: 6 N + 6 L H s
    fpt = 6.0 * n_active + 6.0 * L * cfg.hidden_size * TRAIN_SEQ
    from hetu_tpu_torch.engine import trace_counts
    trainer = Trainer(model, optim.adamw(1e-4), Strategy(unroll=True),
                      config=TrainerConfig(precision="bf16", log_every=1,
                                           peak_flops=PEAK_FLOPS[
                                               torch.bfloat16]),
                      device=device)
    batch = {k: v.numpy() for k, v in
             train_batch(cfg.vocab_size, MOE_BATCH, "cpu").items()}
    captures0 = trace_counts().get("train_step", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = trainer.train(itertools.repeat(batch), steps=3)
    warm_s = time.perf_counter() - t0
    trainer.config.log_every = 10         # one device read, at the end
    run = timed_fit(trainer, lambda n: trainer.train(itertools.repeat(batch),
                                                     steps=n), 10)
    rec = run["records"][-1]
    want = {k: 10 * L for k in FLASH}
    tokens = MOE_BATCH * TRAIN_SEQ
    losses = [r["loss"] for r in warm] + [rec["loss"]]
    emit(phase="moe_train", card=card,
         config="GPTConfig.moe_8e, 6 layers (bench_suite.py config 4)",
         params=n_params, expert_params=n_expert, active_params=n_active,
         experts=cfg.num_experts, k=cfg.moe_top_k, seq=TRAIN_SEQ,
         batch=MOE_BATCH, policy="BF16_COMPUTE", remat="none",
         step_ms=run["dt"] * 1e3, tokens_per_s=tokens / run["dt"],
         mfu_active=tokens / run["dt"] * fpt / PEAK_FLOPS[torch.bfloat16],
         flops_per_token_active=fpt, trainer_mfu_all_params=rec.get("mfu"),
         trainer_record=rec,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         warmup_seconds=warm_s, losses_steps_1_2_3_13=losses,
         launches=run["counts"], expected=want,
         graphs=trainer_graphs(trainer))
    sync_free("moe_train", lambda: trainer._step_fn.body(
        trainer.state, to_tensors(batch)))
    check(trace_counts().get("train_step", 0) - captures0 == 1,
          "moe_train: the step was captured more than once")
    check(all(np.isfinite(losses)), "non-finite MoE training loss")
    check(losses[-1] < losses[0], f"MoE loss did not fall: {losses}")
    check(run["counts"] == want, f"moe_train launches {run['counts']}, "
                                 f"expected {want}")
    return dict(trainer=trainer, batch=batch, counts=run["counts"],
                step_ms=run["dt"] * 1e3)


def phase_moe_train_telemetry(device, card, model, batch, off_ms):
    """``moe_train``'s model and batch in a Trainer of its own with
    telemetry on (``moe_train``'s closed first): its step captures the
    expert plane, a ring of 10 steps (the log cadence it is built
    with). 3 warm-up and 10 timed steps, the launch counters zeroed just
    before the timed steps and read just after (each flash kernel 6
    times a step); one captured step under
    ``set_sync_debug_mode("error")``; then ``moe_expert_plane``. One
    capture. The step ms is printed beside ``moe_train``'s with
    telemetry off (``off_ms``; no bound). Returns the launch counts."""
    from hetu_tpu_torch import optim, telemetry
    from hetu_tpu_torch.data import to_tensors
    from hetu_tpu_torch.engine import Trainer, TrainerConfig, trace_counts
    from hetu_tpu_torch.parallel import Strategy

    L = model.cfg.num_layers
    telemetry.reset()
    trainer = Trainer(model, optim.adamw(1e-4), Strategy(unroll=True),
                      config=TrainerConfig(precision="bf16", log_every=10,
                                           peak_flops=PEAK_FLOPS[
                                               torch.bfloat16],
                                           telemetry=True),
                      device=device)
    captures0 = trace_counts().get("train_step", 0)
    trainer.config.log_every = 1
    trainer.train(itertools.repeat(batch), steps=3)
    trainer.config.log_every = 10         # one device read, at the end
    run = timed_fit(trainer, lambda n: trainer.train(itertools.repeat(batch),
                                                     steps=n), 10)
    want = {k: 10 * L for k in FLASH}
    # the captured step (a replay): the ring slot is a device fill; the
    # step is drained with moe_expert_plane's
    dev_batch = to_tensors(batch, device)
    sync_free("moe_train_telemetry",
              lambda: trainer._step_fn(trainer.state, dev_batch))
    emit(phase="moe_train_telemetry", card=card, layers=L,
         step_ms_telemetry_on=run["dt"] * 1e3, step_ms_telemetry_off=off_ms,
         trainer_record=run["records"][-1], launches=run["counts"],
         expected=want, graphs=trainer_graphs(trainer))
    moe_expert_plane(trainer, batch, L, 13)
    check(trace_counts().get("train_step", 0) - captures0 == 1,
          "moe_train_telemetry: the step was captured more than once")
    check(run["counts"] == want, f"moe_train_telemetry launches "
                                 f"{run['counts']}, expected {want}")
    trainer.close()
    return run["counts"]


def moe_expert_plane(trainer, batch, layers: int, steps: int) -> dict:
    """The expert plane of ``moe_train_telemetry``: ``moe_aux_loss``
    and ``moe_overflow_fraction`` one observation a layer and step, and
    one more step whose ``moe_expert_tokens`` must equal a host count of
    the routing of the layer JAX's emission order puts last in a train
    step (its backward runs the layers in reverse: layer 0), read by
    ``RoutingSpy`` from an eager forward of the same params on the same
    batch. Emits ``moe_expert_plane``; turns telemetry off."""
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.core import autocast
    from hetu_tpu_torch.data import to_tensors
    snap = telemetry.get_registry().snapshot()
    aux_n = series(snap, "moe_aux_loss")
    over_n = series(snap, "moe_overflow_fraction")
    model = trainer.model
    spy = RoutingSpy(model, margins=True)
    with torch.no_grad(), autocast(trainer.plan.policy):
        dev = to_tensors(batch, trainer.plan.device)
        model.loss(dev["input_ids"], dev["labels"])
    calls = spy.close()
    idx0, margins0 = calls[0]
    E = model.cfg.num_experts
    host = np.bincount(idx0.reshape(-1).numpy(), minlength=E)
    trainer.config.log_every = 1
    trainer.train(itertools.repeat(batch), steps=1)
    snap = telemetry.get_registry().snapshot()
    gauge = np.array([series(snap, "moe_expert_tokens", expert=e)
                      for e in range(E)])
    near = int((margins0 < NEAR_TIE).sum())
    out = dict(aux_loss_count=aux_n, overflow_count=over_n,
               expected_count=layers * steps,
               expert_tokens=gauge.tolist(), host_count=host.tolist(),
               near_ties=near, dropped=series(snap,
                                              "moe_dropped_tokens_total"))
    emit(phase="moe_expert_plane", **out)
    telemetry.enable(False)
    telemetry.reset()
    check(aux_n == over_n == layers * steps,
          f"moe_train_telemetry: expert-plane observations {aux_n}/{over_n}, "
          f"expected {layers * steps}")
    check(np.array_equal(gauge, host) or (near and np.abs(
        gauge - host).sum() <= 2 * near),
          f"moe_train_telemetry: moe_expert_tokens {gauge.tolist()} against the host "
          f"count {host.tolist()} ({near} rows within {NEAR_TIE} of a "
          f"tie)")
    return out


def moe_forward_oracle(model, reqs, vocab):
    """Each request's teacher-forced decode logits (``forced_logits``
    over a dense cache, ``MoEMLP.decode``'s gathered experts) and the
    engine's first-token logits against the plain forward
    (``model(ids)``: the flash forward and the dense expert combine) on
    prompt + tokens. Routing first: per layer, the rows the two routed
    differently must be near-ties of the forward's gate, and logits are
    compared only before the first such row. Returns the largest
    differences, the rows compared and the routing counts."""
    L = model.cfg.num_layers
    worst = first = 0.0
    rows = near_ties = differ_rows = 0
    for r in reqs:
        prompt, got = r.prompt.tolist(), list(r.tokens)
        seq = prompt + got[:-1]
        spy = RoutingSpy(model, margins=True)
        with torch.no_grad():
            fwd = model(torch.tensor([seq], device=model.device))[0]
        f_calls = spy.close()
        spy = RoutingSpy(model)
        forced = forced_logits(model, prompt, got, None, chunk=MOE_CHUNK)
        d_calls = spy.close()
        check(len(f_calls) == L and len(d_calls) % L == 0,
              f"request {r.id}: gate calls {len(f_calls)}, {len(d_calls)}")
        stop = len(seq)
        for layer in range(L):
            idx_f, margins = f_calls[layer]
            idx_d = torch.cat([c[0] for c in d_calls[layer::L]])
            differ, near = routing_split(idx_d, idx_f, margins)
            near_ties += int(near.sum())
            differ_rows += int(differ.sum())
            check(bool((~differ | near).all()),
                  f"request {r.id}: layer {layer} routes "
                  f"{int((differ & ~near).sum())} rows differently off a "
                  f"near-tie")
            if differ.any():
                stop = min(stop, int(differ.nonzero()[0, 0]))
        n = stop - (len(prompt) - 1)
        if n <= 0:
            continue
        fwd = fwd[len(prompt) - 1:stop]
        worst = max(worst, max_err(forced[:n], fwd))
        first = max(first, max_err(r.first_logits, fwd[0]))
        rows += n
    return dict(requests=len(reqs), rows_compared=rows,
                forced_max_abs_dlogit=worst,
                first_token_max_abs_dlogit=first,
                routing_near_ties=near_ties,
                routing_rows_differing=differ_rows)


def phase_moe_engine(device, card):
    """``GPTConfig.moe_8e`` uncut (12 layers, fp32, random weights from a
    seed) served by ``ServingEngine(slots=16, max_len=512,
    prefill_chunk=64, block_size=16)``: the GPT-2 engine's workload at
    half its requests (24 of the burst, then 8 sharing a 128-token
    system prompt), ``max_tokens=64``. Both lanes run ``MoEMLP.decode``.
    Launches of #1 and #2 as in ``engine``; each lane captured once.
    Greedy tokens must equal one-shot ``generate`` (a divergence only at
    a top-2 gap under 1e-4); the teacher-forced decode logits and each
    request's first-token logits must match the plain forward within
    1e-4 (``moe_forward_oracle``); profiles of a mixed and a
    steady-decode window (as ``engine``'s); ``step_graph_replay``
    bit-equal."""
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    cfg = moe_cfg()
    t0 = time.perf_counter()
    model = moe_model(cfg, device, SEED).eval()
    burst, shared = workload(cfg.vocab_size)
    burst, shared = burst[:24], shared[:8]
    sp = SamplingParams(max_tokens=64)
    warm = ServingEngine(model, slots=2, max_len=512, prefill_chunk=64,
                         block_size=16, device=device)
    warm.generate_many([burst[0][:70]], SamplingParams(max_tokens=3))
    del warm
    torch.cuda.synchronize()
    before = trace_counts()
    t1 = time.perf_counter()
    eng = ServingEngine(model, slots=16, max_len=512, prefill_chunk=64,
                        block_size=16, seed=SEED, device=device,
                        record_first_logits=True)
    emit(phase="moe_engine_setup", config="GPTConfig.moe_8e",
         dtype="float32", layers=cfg.num_layers, experts=cfg.num_experts,
         k=cfg.moe_top_k, params=sum(p.numel() for p in model.parameters()),
         slots=16, max_len=512, prefill_chunk=64, block_size=16,
         kv_blocks=eng.pool.n_blocks, arena_bytes=eng.pool.nbytes(),
         lanes=capture_stats(eng), engine_seconds=time.perf_counter() - t1,
         seconds=time.perf_counter() - t0)
    check_captures("moe_engine_setup", eng, before)

    # ---- the main path: counters zeroed just before, read just after --
    reset_launch_counts()
    run = serve(eng, burst, shared, sp)
    counts = launch_counts()
    iters = dict(eng.lane_iters)
    # ------------------------------------------------------------------
    check_captures("moe_engine", eng, before)
    check_launches("moe_engine_launches", counts, iters, cfg.num_layers)
    reqs, reqs2 = run["reqs"], run["reqs2"]
    bad = [r for r in reqs + reqs2 if r.status != "done"]
    check(not bad, f"{len(bad)} MoE requests did not finish")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    timings = [r.timing() for r in reqs]
    ttft = [t["ttft_ms"] for t in timings]
    tpot = [t["decode_ms"] / (len(r.tokens) - 1)
            for t, r in zip(timings, reqs) if len(r.tokens) > 1]
    hits = sum(r.cached_tokens for r in reqs2)
    emit(phase="moe_engine", card=card, burst_requests=len(reqs),
         burst_prompt_tokens=sum(len(p) for p in burst),
         burst_generated_tokens=gen_tokens, burst_seconds=run["t_burst"],
         burst_tokens_per_s=gen_tokens / run["t_burst"],
         burst_steps=run["steps"],
         burst_ms_per_step=run["t_burst"] / run["steps"] * 1e3,
         burst_lane_iterations=run["it_burst"],
         ttft_ms_p50=percentile(ttft, 50), ttft_ms_p99=percentile(ttft, 99),
         tpot_ms_p50=percentile(tpot, 50), shared_requests=len(reqs2),
         shared_prefix_hit_tokens=hits, shared_seconds=run["t_shared"],
         shared_tokens_per_s=sum(len(r.tokens) for r in reqs2)
         / run["t_shared"],
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    check(hits >= 7 * 128, f"MoE shared-prompt batch hit only {hits} "
                           f"cached tokens")

    t0 = time.perf_counter()
    near_ties = []
    want = oracle_generate(model, [r.prompt.tolist() for r in reqs + reqs2],
                           64, device, tag="moe_engine_oracle")
    for r in reqs + reqs2:
        want_toks, gaps = want[tuple(r.prompt.tolist())]
        got = list(r.tokens)
        check(len(got) == 64 and all(0 <= t < cfg.vocab_size for t in got),
              f"MoE request {r.id}: bad token list")
        if got == want_toks:
            continue
        t = next(i for i, (a, b) in enumerate(zip(got, want_toks)) if a != b)
        gap = float(gaps[t])
        near_ties.append(dict(request=r.id, step=t, gap=gap))
        check(gap < 1e-4, f"MoE request {r.id} diverges from generate at "
                          f"step {t} where the oracle's top-2 gap is {gap}")
    reading = moe_forward_oracle(model, reqs + reqs2, cfg.vocab_size)
    emit(phase="moe_engine_oracle", identical=len(reqs) + len(reqs2)
         - len(near_ties), near_ties=near_ties, **reading,
         seconds=time.perf_counter() - t0)
    check(reading["rows_compared"] > 0, "MoE forward oracle compared no row")
    check(reading["forced_max_abs_dlogit"] <= 1e-4
          and reading["first_token_max_abs_dlogit"] <= 1e-4,
          f"MoE logits differ from the plain forward: {reading}")
    # fresh prompts: the burst's are all in the prefix cache by now (24
    # requests do not fill the arena), so they would not prefill
    fresh = workload(cfg.vocab_size, seed=SEED + 7)[0]
    phase_profile(eng, fresh[:16], sp, phase="moe_engine_profile",
                  flash_lane="tensor_core_f32")
    decode_prompts = [p for p in fresh if len(p) <= 512 - 96][:16]
    phase_profile(eng, decode_prompts, SamplingParams(max_tokens=96),
                  phase="moe_engine_decode_profile", steady_decode=True)
    phase_step_graph_replay(eng, "GPTConfig.moe_8e fp32")
    check_captures("moe_engine_after_replay", eng, before)
    del eng, model
    gc.collect()
    release()
    return counts


# ---- LoRA fine-tuning and the multi-tenant adapter plane -----------------

#: LoRA on Llama-7B: rank 16, alpha 32 (scaling 2) on every projection
#: of ``serving.tenancy.DEFAULT_TARGETS`` (``peft.LoraConfig``'s default
#: patterns): 40 M adapter params at full depth
LORA_R, LORA_ALPHA = 16, 32.0
#: the LoRA SFT's batch ladder, and its rung that fits on 80 GB (4 does
#: not: every run of the ladder); a captured step is never retried, so
#: the phase runs that rung alone
LORA_LADDER = (4, 2, 1)
LORA_BATCH = 2
#: the tenancy engine's arena: 4 pages (the base page and 3 adapters)
TENANCY_PAGES = 4
#: a tenant capped at this many slots (``TenantQoS``)
TENANCY_CAP = 4


def lora_pages(cfg, r: int, seed: int) -> dict:
    """A seeded adapter in ``tenancy.extract_adapter``'s layout for every
    projection of ``DEFAULT_TARGETS`` the config has: A ~
    N(0, 0.02) (``peft.LoraLinear``'s init) and B ~ N(0, 0.02) (nonzero,
    as ``tests/test_tenancy.py:245-262`` draws it, so it changes tokens),
    fp32 host arrays (L, in, r) and (L, r, out)."""
    from hetu_tpu_torch.serving.tenancy import DEFAULT_TARGETS
    E, L = cfg.hidden_size, cfg.num_layers
    hd = getattr(cfg, "head_dim", None) or E // cfg.num_heads
    q = cfg.num_heads * hd
    kv = (getattr(cfg, "num_kv_heads", None) or cfg.num_heads) * hd
    hidden = getattr(cfg, "intermediate_size", None) \
        or cfg.mlp_ratio * E
    dims = {"q_proj": (E, q), "k_proj": (E, kv), "v_proj": (E, kv),
            "out_proj": (q, E), "gate_proj": (E, hidden),
            "up_proj": (E, hidden), "fc_in": (E, hidden),
            "fc_out": (hidden, E)}
    gated = hasattr(cfg, "intermediate_size")
    projs = [p for p in DEFAULT_TARGETS
             if p not in (("fc_in",) if gated else ("gate_proj", "up_proj"))]
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for p in projs:
        d_in, d_out = dims[p]
        out[p] = {"A": (0.02 * torch.randn(L, d_in, r, generator=gen))
                  .numpy(),
                  "B": (0.02 * torch.randn(L, r, d_out, generator=gen))
                  .numpy()}
    return out


def lora_arena(weights, scaling: float, device) -> dict:
    """One adapter as a page-1 arena for ``decode(lora=)`` (page 0 the
    zero base page), built from its host factors alone (the scaling
    folded into B), so an oracle under it shares no bookkeeping with the
    engine's registry."""
    out = {}
    for proj, ab in weights.items():
        a = torch.as_tensor(ab["A"], dtype=torch.float32)
        b = torch.as_tensor(ab["B"], dtype=torch.float32) * scaling
        out[proj] = {k: torch.stack([torch.zeros_like(t), t], 1).to(device)
                     for k, t in (("A", a), ("B", b))}
    return out


def wrap_lora(model, weights, r: int, alpha: float) -> list:
    """Wrap the projections ``weights`` pages (``lora_pages``' layout) in
    ``peft.LoraLinear``, in place, each holding that adapter's layer
    factors as its task 0: the delta computed by ``LoraLinear`` itself,
    ``alpha / r`` applied there, through no arena and no ``lora_apply``.
    ``unwrap_lora`` undoes it."""
    from hetu_tpu_torch.peft import LoraConfig, inject_lora
    pattern = r"\.(" + "|".join(sorted(weights)) + r")$"
    wrapped = inject_lora(model, LoraConfig(r=r, alpha=alpha,
                                            target_patterns=(pattern,)))
    check(len(wrapped) == model.cfg.num_layers * len(weights),
          f"wrap_lora wrapped {len(wrapped)} projections")
    mods = dict(model.named_modules())
    with torch.no_grad():
        for path in wrapped:
            layer = int(path.split(".")[1])          # blocks.{layer}.…
            ab = weights[path.rsplit(".", 1)[1]]
            mods[path].lora_A[0].copy_(torch.as_tensor(ab["A"][layer]))
            mods[path].lora_B[0].copy_(torch.as_tensor(ab["B"][layer]))
    return wrapped


def unwrap_lora(model) -> None:
    """Put each ``LoraLinear``'s base layer back in its place, in place:
    the model's module tree as it was before ``inject_lora``, which a
    ``merge_lora`` state dict loads into."""
    from hetu_tpu_torch.peft import LoraLinear
    for _, mod in list(model.named_modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, LoraLinear):
                setattr(mod, name, child.base)


def checksum(t: torch.Tensor) -> tuple:
    """Two integer sums of ``t``'s 32-bit words (plain and position
    weighted): equal before and after means the bits did not move."""
    w = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
    return int(w.sum()), int((w * pos).sum())


def phase_llama_lora_train_oracle(device):
    """One fp32 step of a LoRA-injected Llama-7B-width model (1 layer,
    r 16 on every projection, random nonzero B), kernels on the card
    against the plain path on the CPU (``hold_step``), base params
    frozen: the loss and every adapter grad within ``train_oracle``'s
    bounds, no grad on a base param, one launch of each flash kernel."""
    from hetu_tpu_torch.data import pack_sequences, to_tensors
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.peft import LoraConfig, inject_lora, \
        lora_trainable_mask
    t0 = time.perf_counter()
    cfg = llama_train_cfg(num_layers=1)
    models = []
    for dev in (device, "cpu"):
        m = LlamaLMHeadModel(cfg, device=dev, seed=SEED + 2)
        inject_lora(m, LoraConfig(r=LORA_R, alpha=LORA_ALPHA), seed=SEED)
        mask = lora_trainable_mask(m)
        for name, p in m.named_parameters():
            p.requires_grad_(mask[name])
        models.append(m)
    gpu, cpu = models
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    with torch.no_grad():
        for name, p in gpu.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.02, generator=gen)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(SEED + 1)
    docs = [rng.integers(0, cfg.vocab_size, n) for n in (100, 80, 60)]
    batch = to_tensors(pack_sequences(docs, 256).as_batch())
    reading = hold_step(gpu, cpu, batch, device)
    emit(phase="llama_lora_train_oracle", dtype="float32", layers=1,
         lora_r=LORA_R, lora_alpha=LORA_ALPHA, batch=1, seq=256,
         adapter_params=sum(p.numel() for p in gpu.parameters()
                            if p.requires_grad), **reading,
         seconds=time.perf_counter() - t0)
    check(reading["compared_grads"] == 14,
          f"llama_lora_train_oracle: {reading['compared_grads']} grads "
          f"compared, expected the 14 adapter factors")
    check_step_held("llama_lora_train_oracle", reading,
                    {**{k: 1 for k in FLASH}, **{k: 0 for k in FUSED}})
    del gpu, cpu, models
    gc.collect()
    release()


def phase_llama_lora_sft(device, card):
    """LoRA SFT of Llama-7B at full depth (32 layers, 6.74 B params, fp32
    weights from a seed) through ``SFTTrainer.fit``: r 16 / alpha 32 on
    every projection (40 M adapter params), ``masked(chain(
    clip_by_global_norm(1.0), adamw(1e-4)), lora_trainable_mask)``, bf16
    compute, selective remat, ``SFT_PAIRS`` at seq 2048, batch
    ``LORA_BATCH``; 3 warm-up and 10 timed steps. The loss
    must fall, every base param keep its bits (``checksum``), the
    optimizer hold state for the adapter factors alone, each flash kernel
    launch exactly 32 times a step; then ``merge_lora``, loaded into the
    plain module tree (``unwrap_lora``): its fp32 forward against the
    adapter's fp32 forward on one batch, each row's last-position logits
    within ``TOL[fp32]`` of the largest of them, and the bf16 forwards'
    distances printed. Returns the timed steps' launch counts."""
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.core import BF16_COMPUTE, FP32, autocast
    from hetu_tpu_torch.data import to_tensors
    from hetu_tpu_torch.engine import SFTTrainer, TrainerConfig, sft_batches
    from hetu_tpu_torch.engine.trainer import flops_per_token
    from hetu_tpu_torch.models import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.parallel import Strategy
    from hetu_tpu_torch.peft import (
        LoraConfig, inject_lora, lora_trainable_mask, merge_lora,
    )

    t0 = time.perf_counter()
    cfg = LlamaConfig.llama_7b()
    model = LlamaLMHeadModel(cfg, device=device, seed=SEED)
    n_base = sum(p.numel() for p in model.parameters())
    wrapped = inject_lora(model, LoraConfig(r=LORA_R, alpha=LORA_ALPHA),
                          seed=SEED + 3)
    mask = lora_trainable_mask(model)
    n_lora = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    sums = {n: checksum(p) for n, p in model.named_parameters()
            if not mask[n]}
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    opt = optim.masked(optim.chain(optim.clip_by_global_norm(1.0),
                                   optim.adamw(1e-4)), mask)
    trainer = SFTTrainer(model, opt, Strategy(remat="selective",
                                              unroll=True),
                         config=TrainerConfig(precision="bf16", log_every=1,
                                              peak_flops=PEAK_FLOPS[
                                                  torch.bfloat16]),
                         device=device)
    prompts, responses = sft_pairs(cfg.vocab_size)
    fit = dict(seq_len=LLAMA_TRAIN_SEQ, shuffle=False)
    batch = LORA_BATCH
    # the eager body once before anything is captured (its activations
    # and a graph's pool would not fit beside each other at full depth)
    trainer.initialize()
    first = next(sft_batches(prompts, responses, batch_size=batch, **fit))
    sync_free("llama_lora_sft", lambda: trainer._step_fn.body(
        trainer.state, to_tensors(first)))
    release()
    torch.cuda.reset_peak_memory_stats()
    warm = trainer.fit(prompts, responses, batch_size=batch, steps=3, **fit)
    trainer.config.log_every = 10         # one device read, at the end
    # the caching allocator's frees and retries inside the timed window:
    # a candidate cause of the step time's spread between runs
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    run = timed_fit(trainer, lambda n: trainer.fit(
        prompts, responses, batch_size=batch, steps=n, **fit), 10)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) \
        - retries0
    peak = torch.cuda.max_memory_allocated()
    rec = run["records"][-1]
    losses = [r["loss"] for r in warm] + [rec["loss"]]
    L = cfg.num_layers
    want = {k: 10 * L for k in FLASH}
    moved = [n for n, p in model.named_parameters()
             if not mask[n] and checksum(p) != sums[n]]
    optimizer = trainer.state.optimizer
    held = {id(p) for p in optimizer.state}
    in_groups = {id(p) for g in optimizer.param_groups for p in g["params"]}
    lora_ids = {id(p) for n, p in model.named_parameters() if mask[n]}
    tokens = batch * LLAMA_TRAIN_SEQ
    fpt = flops_per_token(model, LLAMA_TRAIN_SEQ)
    reading = dict(
        card=card, config="LlamaConfig.llama_7b (32 layers, uncut)",
        base_params=n_base, adapter_params=n_lora,
        wrapped_layers=len(wrapped), lora_r=LORA_R, lora_alpha=LORA_ALPHA,
        optimizer="masked(chain(clip_by_global_norm(1.0), adamw(1e-4)))",
        policy="BF16_COMPUTE (fp32 params)", remat="selective",
        seq=LLAMA_TRAIN_SEQ, pairs=[list(p) for p in SFT_PAIRS],
        ladder=list(LORA_LADDER), batch=batch,
        graphs=trainer_graphs(trainer),
        step_ms=run["dt"] * 1e3, tokens_per_s=tokens / run["dt"],
        alloc_retries_timed=retries,
        reserved_bytes=torch.cuda.memory_reserved(),
        mfu_6n_all_params=tokens / run["dt"] * fpt
        / PEAK_FLOPS[torch.bfloat16],
        peak_memory_bytes=peak, init_seconds=t_init,
        losses_steps_1_2_3_13=losses,
        grad_norm_step_13=rec["grad_norm"], launches=run["counts"],
        expected=want, base_params_moved=len(moved),
        optimizer_state_params=len(held),
        optimizer_params_are_adapters=in_groups == lora_ids)
    check(all(np.isfinite(losses)), "non-finite LoRA SFT loss")
    check(losses[-1] < losses[0], f"LoRA SFT loss did not fall: {losses}")
    check(not moved, f"llama_lora_sft: base params moved: {moved[:3]}")
    check(in_groups == lora_ids and held == lora_ids,
          "llama_lora_sft: the optimizer holds more than the adapters")
    check(run["counts"] == want, f"llama_lora_sft launches "
                                 f"{run['counts']}, expected {want}")

    # ---- merge_lora, then the plain forward against the adapter's ----
    del trainer, optimizer
    gc.collect()
    release()
    t1 = time.perf_counter()
    rng = np.random.default_rng(SEED + 43)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 512)),
                          device=device)
    policies = {"fp32": FP32, "bf16": BF16_COMPUTE}
    lora_out, plain_out = {}, {}
    with torch.no_grad():
        for name, policy in policies.items():
            with autocast(policy):
                lora_out[name] = model(ids)[:, -1].float()
        merged = merge_lora(model)
        unwrap_lora(model)
        model.load_state_dict(merged)        # strict: the plain tree
        del merged
        for name, policy in policies.items():
            with autocast(policy):
                plain_out[name] = model(ids)[:, -1].float()
    err32 = max_err(plain_out["fp32"], lora_out["fp32"])
    bound32 = TOL[torch.float32] * float(lora_out["fp32"].abs().max())
    reading.update(
        merge_rows=4, merge_seq=512, merge_fp32_max_abs_diff=err32,
        merge_fp32_bound=bound32,
        merge_bf16_max_abs_diff=max_err(plain_out["bf16"], lora_out["bf16"]),
        merge_bf16_vs_fp32_max_abs_diff={
            "adapter": max_err(lora_out["bf16"], lora_out["fp32"]),
            "merged": max_err(plain_out["bf16"], lora_out["fp32"])},
        last_logit_max_abs=float(lora_out["fp32"].abs().max()),
        merge_seconds=time.perf_counter() - t1,
        seconds=time.perf_counter() - t0)
    emit(phase="llama_lora_sft", **reading)
    check(err32 <= bound32,
          f"llama_lora_sft: merge_lora's plain forward differs from the "
          f"adapter forward by {err32} in fp32 (bound {bound32})")
    del model
    gc.collect()
    release()
    return run["counts"]


def serve_tenants(eng, prompts, sps, waves=None):
    """Submit ``prompts`` with their ``sps`` and step to drain; requests
    whose index is in ``waves`` are first served one at a time until
    their first token (so their prompts enter the prefix cache first).
    Returns the requests, each step's host ms with whether it ran a
    prefill pack, and the wall seconds."""
    t0 = time.perf_counter()
    first = [] if waves is None else list(waves)
    reqs = [None] * len(prompts)
    for i in first:
        reqs[i] = eng.submit(prompts[i], sps[i])
        check(reqs[i].status != "rejected", f"rejected: {reqs[i].error}")
        while reqs[i].first_token_s is None:
            eng.step()
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        if reqs[i] is None:
            reqs[i] = eng.submit(p, sp)
    bad = [r.error for r in reqs if r.status == "rejected"]
    check(not bad, f"rejected: {bad[:2]}")
    steps = []
    while eng.has_work():
        check(len(steps) < 20_000, "the engine never drained")
        pf = eng.lane_iters["prefill"]
        t1 = time.perf_counter()
        eng.step()
        steps.append(dict(ms=(time.perf_counter() - t1) * 1e3,
                          prefill=eng.lane_iters["prefill"] > pf))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.status == "done" for r in reqs), "requests unfinished")
    return reqs, steps, wall


def tenant_of(sp) -> str:
    return f"{sp.tenant}/{sp.adapter}" if sp.adapter else "base"


def per_tenant(reqs) -> dict:
    """TTFT and TPOT p50/p99 and the tokens of each tenant's requests."""
    out = {}
    for r in reqs:
        out.setdefault(tenant_of(r.sampling), []).append(r)
    read = {}
    for name, rs in sorted(out.items()):
        t = [r.timing() for r in rs]
        ttft = [x["ttft_ms"] for x in t]
        tpot = [x["decode_ms"] / (len(r.tokens) - 1)
                for x, r in zip(t, rs) if len(r.tokens) > 1]
        read[name] = dict(requests=len(rs),
                          tokens=sum(len(r.tokens) for r in rs),
                          ttft_ms_p50=percentile(ttft, 50),
                          ttft_ms_p99=percentile(ttft, 99),
                          tpot_ms_p50=percentile(tpot, 50),
                          tpot_ms_p99=percentile(tpot, 99))
    return read


@contextlib.contextmanager
def planted_page(eng, victims, page):
    """Serve the requests whose ids are in ``victims`` from arena page
    ``page`` (another adapter's, or the base page 0) in place of their
    own: the engine's admission stamps the wrong page into the slot's
    operand; the lanes and the kernels are untouched."""
    real = eng._bind_adapter_locked

    def faulty(req, slot):
        ok = real(req, slot)
        if ok and req.id in victims:
            eng._adapter_page[slot] = page
        return ok

    eng._bind_adapter_locked = faulty
    try:
        yield
    finally:
        eng._bind_adapter_locked = real


def bgmv_ms(timer, eng, rows: int) -> float:
    """Device ms of every ``lora_apply`` of one lane iteration at ``rows``
    tokens (each layer's paged projections, pages drawn at random over
    the arena, the page masks made once as ``StackedBlocks.decode`` makes
    them), through the engine's own arena, captured as a CUDA graph and
    timed as one replay: the adapter lane's added work, timed apart from
    the base model's."""
    from hetu_tpu_torch.nn.parallel import lora_apply, lora_select
    pages = eng._lora_pages
    L = eng.model.blocks.num_layers
    g = torch.Generator(device=eng.device).manual_seed(SEED)
    ids = torch.randint(0, TENANCY_PAGES, (1, rows), generator=g,
                        device=eng.device)
    sel, live = lora_select(ids, TENANCY_PAGES, LORA_R, torch.float32)
    xs = {n: torch.randn(1, rows, ab["A"].shape[2], device=eng.device,
                         dtype=torch.bfloat16, generator=g)
          for n, ab in pages.items()}
    ys = {n: torch.randn(1, rows, ab["B"].shape[3], device=eng.device,
                         dtype=torch.bfloat16, generator=g)
          for n, ab in pages.items()}

    def run():
        for layer in range(L):
            one = {"sel": sel, "live": live,
                   "pages": {n: {"A": ab["A"][layer], "B": ab["B"][layer]}
                             for n, ab in pages.items()}}
            for n in pages:
                lora_apply(one, n, xs[n], ys[n])

    if eng.device.type != "cuda":
        return timer(run)
    # captured, as the lanes run it: the host does not pace the replay
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return timer(graph.replay)


def phase_llama_tenancy(device, card, model, timer):
    """Multi-tenant serving at Llama-7B width (bf16, int8 arena): the
    llama_engine's settings with ``tenancy=TenantPlane(max_adapters=4,
    r=16)``, two seeded adapters (``acme/fr``, ``beta/de``: every
    projection, nonzero B). First base-only traffic on a fresh tenancy
    engine against a tenancy-off engine (tokens, first-token logits and
    the whole KV arena bit-equal); then the main path (counters zeroed
    just before, read just after): ``llama_workload``'s 48 requests in
    base / acme / beta thirds, then its 16 shared-prompt requests (the
    first of each tenant alone, then the rest), every request against the
    teacher-forced bf16 oracle carrying its adapter alone (a one-page
    arena, ``lora_arena``) under the llama_engine's bounds; prefix hits
    only within a tenant. Planted faults (the other adapter's page, the
    base page) must fail the bounds. Then churn (hot-swap of acme under
    live traffic, a third adapter evicting the LRU idle page,
    ``evict_adapter``), the QoS slot cap, the HBM-budget sizing, a
    profile and the BGMV ops' device ms. Returns the main path's launch
    counts."""
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.engine import memory, trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import (
        SamplingParams, ServingEngine, TenantPlane,
    )

    cfg, vocab = model.cfg, model.cfg.vocab_size
    t0 = time.perf_counter()
    scale = LORA_ALPHA / LORA_R
    adapters = {"acme/fr": lora_pages(cfg, LORA_R, SEED + 51),
                "beta/de": lora_pages(cfg, LORA_R, SEED + 52)}
    kw = dict(slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
              prefill_chunk=LLAMA_CHUNK, block_size=LLAMA_BLOCK,
              cache_dtype=torch.int8, seed=SEED, device=device,
              record_first_logits=True)
    arena_bytes = memory.size_adapter_arena(cfg, r=LORA_R,
                                            max_adapters=TENANCY_PAGES)

    def load(eng, name, weights):
        tenant, adapter = name.split("/")
        return eng.load_adapter(tenant, adapter, weights, scaling=scale)

    def sp_of(name, new, **extra):
        if name == "base":
            return SamplingParams(max_tokens=new, **extra)
        tenant, adapter = name.split("/")
        return SamplingParams(max_tokens=new, tenant=tenant,
                              adapter=adapter, **extra)

    with autocast(BF16_FULL):
        # ---- base traffic: tenancy on (adapters loaded) vs off ----
        rng = np.random.default_rng(SEED + 53)
        base_prompts = [rng.integers(0, vocab, int(n)).tolist()
                        for n in rng.integers(16, LLAMA_MAX_LEN // 2 + 1,
                                              16)]
        before = trace_counts()
        off = ServingEngine(model, **kw)
        check_captures("llama_tenancy_off_setup", off, before)
        before = trace_counts()
        t1 = time.perf_counter()
        eng = ServingEngine(model, tenancy=TenantPlane(
            max_adapters=TENANCY_PAGES, r=LORA_R), **kw)
        t_build = time.perf_counter() - t1
        check_captures("llama_tenancy_setup", eng, before)
        pages_bytes = sum(t.numel() * t.element_size()
                          for ab in eng._lora_pages.values()
                          for t in ab.values())
        for name, w in adapters.items():
            load(eng, name, w)
        base_runs = []
        for e in (off, eng):
            reqs = [e.submit(p, SamplingParams(max_tokens=32))
                    for p in base_prompts]
            e.run_until_drained()
            base_runs.append(reqs)
        torch.cuda.synchronize()
        same_tokens = all(a.tokens == b.tokens for a, b in zip(*base_runs))
        same_logits = all(torch.equal(a.first_logits, b.first_logits)
                          for a, b in zip(*base_runs))
        same_arena = all(torch.equal(a, b) for a, b in
                         zip(off.pool.caches, eng.pool.caches))
        # one decode replay of the same staged step on each engine: the
        # adapter lane's device cost at 16 slots
        lanes_off = capture_stats(off)
        base_replay_ms = {"tenancy_off": replay_device_ms(off),
                          "tenancy_on": replay_device_ms(eng)}
        del off, base_runs
        gc.collect()
        release()
        emit(phase="llama_tenancy_setup", card=card,
             config="LlamaConfig.llama_7b", dtype="bfloat16",
             cache_dtype="int8", max_adapters=TENANCY_PAGES, r=LORA_R,
             adapters=sorted(adapters), scaling=scale,
             arena_bytes=pages_bytes, ledger_arena_bytes=arena_bytes,
             engine_seconds=t_build, lanes=capture_stats(eng),
             lanes_tenancy_off=lanes_off,
             base_requests=len(base_prompts),
             base_tokens_equal_tenancy_off=same_tokens,
             base_first_logits_equal_tenancy_off=same_logits,
             base_kv_arena_equal_tenancy_off=same_arena,
             base_last_step_replay_device_ms=base_replay_ms)
        check(pages_bytes == arena_bytes,
              f"llama_tenancy: the arena holds {pages_bytes} B, the ledger "
              f"prices {arena_bytes} B")
        check(same_tokens and same_logits and same_arena,
              "llama_tenancy: base traffic on the tenancy engine differs "
              "from the tenancy-off engine")

        # ---- the main path: counters zeroed just before, read after ----
        burst, shared = llama_workload(vocab)
        names = ("base", "acme/fr", "beta/de")
        new = 64
        sps = [sp_of(names[i % 3], new) for i in range(len(burst))]
        sps2 = [sp_of(names[i % 3], new) for i in range(len(shared))]
        stats0 = eng.tenancy.registry.stats()
        iters0 = dict(eng.lane_iters)
        reset_launch_counts()
        reqs, steps, wall = serve_tenants(eng, burst, sps)
        reqs2, steps2, wall2 = serve_tenants(eng, shared, sps2,
                                             waves=range(3))
        counts = launch_counts()
        iters = {k: n - iters0[k] for k, n in eng.lane_iters.items()}
        # ---------------------------------------------------------------
        decode_ms = [s["ms"] for s in steps + steps2 if not s["prefill"]]
        replay_ms = replay_device_ms(eng)
    check_captures("llama_tenancy", eng, before)
    check_launches("llama_tenancy_launches", counts, iters, cfg.num_layers,
                   paged="paged_attention_int8")
    gen = sum(len(r.tokens) for r in reqs)
    hits = {r.id: r.cached_tokens for r in reqs2[3:]}
    system = sum(1 for _ in itertools.takewhile(
        lambda ab: ab[0] == ab[1], zip(shared[0], shared[1])))
    system -= system % LLAMA_BLOCK
    root_tags = sorted({c.adapter for c in eng.prefix_cache._root.children
                        if list(c.tokens) == shared[0][:LLAMA_BLOCK]})
    uids = {n: eng.tenancy.registry.get(*n.split("/")).uid
            for n in names[1:]}

    arenas = {n: lora_arena(w, scale, device) for n, w in adapters.items()}

    def lora_for(r):
        return arenas.get(tenant_of(r.sampling))

    t1 = time.perf_counter()
    with autocast(BF16_FULL):
        sound = oracle(model, reqs + reqs2, new, vocab, lora_for=lora_for)
        # how often the adapter moves the oracle's choice: the base
        # oracle's argmax on the same tokens, on six adapter requests
        moved = total = 0
        for r in [r for r in reqs if r.sampling.adapter][:6]:
            toks = list(r.tokens)
            a = forced_logits(model, r.prompt.tolist(), toks, torch.int8,
                              lora=lora_for(r)).argmax(-1)
            b = forced_logits(model, r.prompt.tolist(), toks,
                              torch.int8).argmax(-1)
            moved += int((a != b).sum())
            total += len(toks)
        # the delta a second way, through no arena and no lora_apply: the
        # first request of each tenant against the serving model wrapped
        # in peft.LoraLinear with that tenant's factors
        direct = {}
        for n in names[1:]:
            r = next(x for x in reqs if tenant_of(x.sampling) == n)
            wrap_lora(model, adapters[n], LORA_R, LORA_ALPHA)
            try:
                direct[n] = oracle(model, [r], new, vocab)
            finally:
                unwrap_lora(model)
    emit(phase="llama_tenancy", card=card, requests=len(reqs),
         tenants=list(names), burst_generated_tokens=gen,
         burst_seconds=wall, burst_tokens_per_s=gen / wall,
         burst_steps=len(steps), shared_requests=len(reqs2),
         shared_seconds=wall2,
         shared_tokens_per_s=sum(len(r.tokens) for r in reqs2) / wall2,
         per_tenant=per_tenant(reqs), shared_per_tenant=per_tenant(reqs2),
         decode_step_ms=spread(decode_ms), replay_device_ms=replay_ms,
         shared_prefix_hits=hits, root_block_adapter_tags=root_tags,
         adapter_uids=uids, registry=eng.tenancy.registry.stats(),
         registry_before=stats0, ledgers={k: {str(kk): v for kk, v in
                                               d.items()}
                                          for k, d in
                                          eng.tenancy.ledgers.items()},
         oracle=sound, dlogit_bound=DLOGIT_BF16, tie_bound=TIE_BF16,
         adapter_moves_oracle_argmax_share=moved / max(total, 1),
         adapter_argmax_steps=total, lora_linear_oracle=direct,
         oracle_seconds=time.perf_counter() - t1,
         seconds=time.perf_counter() - t0)
    check_held("llama_tenancy against the adapter oracle", sound,
               DLOGIT_BF16, TIE_BF16)
    for n, reading in direct.items():
        check_held(f"llama_tenancy {n} against the LoraLinear oracle",
                   reading, DLOGIT_BF16, TIE_BF16)
    check(moved > 0, "llama_tenancy: the adapters never change the "
                     "oracle's choice")
    check(all(h >= system for h in hits.values()),
          f"llama_tenancy: a shared-prompt request missed its tenant's "
          f"cached system prompt: {hits}")
    check(root_tags == sorted([0] + list(uids.values())),
          f"llama_tenancy: the system prompt's first block is cached "
          f"under tags {root_tags}, expected one a tenant")

    # ---- churn: hot-swap under live traffic, LRU eviction, evict ----
    t1 = time.perf_counter()
    rng = np.random.default_rng(SEED + 55)
    fresh = [rng.integers(0, vocab, int(n)).tolist()
             for n in rng.integers(LLAMA_MAX_LEN // 20,
                                   LLAMA_MAX_LEN * 3 // 10 + 1, 16)]
    reg = eng.tenancy.registry
    v2 = {p: {"A": ab["A"] * np.float32(1.5), "B": ab["B"]}
          for p, ab in adapters["acme/fr"].items()}
    gamma = lora_pages(cfg, LORA_R, SEED + 56)
    with autocast(BF16_FULL):
        old = [eng.submit(p, sp_of("acme/fr", 32)) for p in fresh[:4]]
        while any(r.adapter_ref is None for r in old):
            eng.step()
        uid_v1 = reg.get("acme", "fr").uid
        ev0 = reg.stats()["evictions"]
        info_v2 = load(eng, "acme/fr", v2)
        info_g = load(eng, "gamma/x", gamma)
        evicted_lru = reg.stats()["evictions"] - ev0
        beta_resident = reg.resident("beta", "de")
        later = [(eng.submit(p, sp_of(n, 32)), n) for p, n in zip(
            fresh[4:], ["acme/fr", "gamma/x", "beta/de", "base"] * 3)]
        eng.run_until_drained()
        flushed = eng.evict_adapter("beta", "de")
    arenas_v = {"acme/fr": lora_arena(v2, scale, device),
                "gamma/x": lora_arena(gamma, scale, device),
                "beta/de": arenas["beta/de"]}
    with autocast(BF16_FULL):
        old_read = oracle(model, old, 32, vocab, lora_for=lora_for)
        new_read = oracle(model, [r for r, _ in later], 32, vocab,
                          lora_for=lambda r: arenas_v.get(
                              tenant_of(r.sampling)))
    emit(phase="llama_tenancy_churn", in_flight_at_swap=len(old),
         uid_v1=uid_v1, swap=info_v2, third_adapter=info_g,
         lru_evictions_at_third_load=evicted_lru,
         beta_resident_after_third_load=beta_resident,
         after_swap_requests=len(later), evict_beta=flushed,
         registry=reg.stats(), old_version_oracle=old_read,
         new_version_oracle=new_read, seconds=time.perf_counter() - t1)
    check(info_v2["version"] == 2 and info_v2["uid"] != uid_v1,
          "llama_tenancy_churn: the hot-swap kept the old uid")
    check(evicted_lru == 1 and not beta_resident,
          "llama_tenancy_churn: the third adapter did not evict the LRU "
          "idle page (beta/de)")
    check_held("llama_tenancy_churn requests in flight at the swap",
               old_read, DLOGIT_BF16, TIE_BF16)
    check_held("llama_tenancy_churn requests after the swap", new_read,
               DLOGIT_BF16, TIE_BF16)
    check(not reg.has("beta", "de"), "evict_adapter left beta/de")
    check_captures("llama_tenancy_churn", eng, before)

    # ---- QoS: a tenant capped at TENANCY_CAP slots ----
    t1 = time.perf_counter()
    eng.tenancy.qos.configure("noisy", max_slots=TENANCY_CAP)
    rng = np.random.default_rng(SEED + 57)
    qp = [rng.integers(0, vocab, int(n)).tolist()
          for n in rng.integers(LLAMA_MAX_LEN // 32,
                                LLAMA_MAX_LEN // 8 + 1, 32)]
    qsp = [SamplingParams(max_tokens=32, tenant="noisy")
           if i % 2 == 0 else sp_of(("base", "acme/fr")[i // 2 % 2], 32)
           for i in range(len(qp))]
    with autocast(BF16_FULL):
        qreqs = [eng.submit(p, sp) for p, sp in zip(qp, qsp)]
        most = 0
        while eng.has_work():
            eng.step()
            most = max(most, sum(1 for r in eng._slot_req if r is not None
                                 and r.sampling.tenant == "noisy"))
    check(all(r.status == "done" for r in qreqs), "QoS requests unfinished")
    ttft = per_tenant(qreqs)
    emit(phase="llama_tenancy_qos", cap=TENANCY_CAP,
         noisy_requests=len(qp) // 2, most_noisy_slots=most,
         throttled={str(k): v for k, v in
                    eng.tenancy.ledgers["throttled"].items()},
         per_tenant=ttft, seconds=time.perf_counter() - t1)
    check(most <= TENANCY_CAP, f"the capped tenant held {most} slots")
    check_captures("llama_tenancy_qos", eng, before)

    # ---- planted faults: the wrong page must fail the oracle ----
    t1 = time.perf_counter()
    rng = np.random.default_rng(SEED + 59)
    fp = [rng.integers(0, vocab, int(n)).tolist()
          for n in rng.integers(LLAMA_CHUNK + 1, LLAMA_MAX_LEN // 2 + 1, 8)]
    caught = {}
    bounds = (DLOGIT_BF16, TIE_BF16)
    other = reg.get("gamma", "x").page
    check(other is not None, "llama_tenancy: gamma/x left the arena")
    for fault, page in (("other_adapter_page", other), ("base_page", 0)):
        with autocast(BF16_FULL):
            with planted_page(eng, set(range(eng._next_id,
                                              eng._next_id + 8)), page):
                freqs = [eng.submit(p, sp_of("acme/fr", 16)) for p in fp]
                eng.run_until_drained()
            got = oracle(model, freqs, 16, vocab, lora_for=lambda r:
                         arenas_v["acme/fr"])
        caught[fault] = not held(got, *bounds)
        emit(phase="llama_tenancy_fault", fault=fault, page=page, **got,
             dlogit_bound=bounds[0], tie_bound=bounds[1],
             caught=caught[fault])
        # the faulty run's spans are tagged with acme's uid: drop them
        eng.prefix_cache.flush_adapter(reg.get("acme", "fr").uid)
    for fault, seen in caught.items():
        check(seen, f"the adapter oracle passes a planted fault ({fault})")

    # ---- where the time goes: a profile, the BGMV ops alone ----
    with autocast(BF16_FULL):
        prof_p = [rng.integers(0, vocab, LLAMA_MAX_LEN // 4).tolist()
                  for _ in range(LLAMA_SLOTS)]
        eng.tenancy.qos.configure("noisy")
        live = ("base", "acme/fr", "gamma/x")     # beta/de was evicted
        phase_profile(eng, prof_p, [sp_of(live[i % 3], 96)
                                    for i in range(LLAMA_SLOTS)],
                      phase="llama_tenancy_profile", classes=LLAMA_CLASSES,
                      steady_decode=True)
        bgmv = {"decode_16_rows": bgmv_ms(timer, eng, LLAMA_SLOTS),
                "prefill_256_rows": bgmv_ms(timer, eng, LLAMA_CHUNK)}
    emit(phase="llama_tenancy_bgmv", device_ms=bgmv,
         projections=sorted(eng._lora_pages), layers=cfg.num_layers,
         pages=TENANCY_PAGES, r=LORA_R,
         note="every lora_apply of one lane iteration, captured as a "
              "CUDA graph; one replay timed with CUDA events")
    check_captures("llama_tenancy_after_profiles", eng, before)
    del eng, arenas, arenas_v
    gc.collect()
    release()

    # ---- the HBM budget: the arena comes off it first ----
    with autocast(BF16_FULL):
        beng = ServingEngine(model, hbm_budget_bytes=BUDGET_BYTES,
                             max_len=LLAMA_MAX_LEN,
                             prefill_chunk=LLAMA_CHUNK,
                             block_size=LLAMA_BLOCK, cache_dtype=torch.int8,
                             seed=SEED, device=device,
                             tenancy=TenantPlane(
                                 max_adapters=TENANCY_PAGES, r=LORA_R))
    want = memory.size_kv_pool(cfg, hbm_budget_bytes=BUDGET_BYTES
                               - arena_bytes, max_len=LLAMA_MAX_LEN,
                               cache_dtype="int8")
    plain = memory.size_kv_pool(cfg, hbm_budget_bytes=BUDGET_BYTES,
                                max_len=LLAMA_MAX_LEN, cache_dtype="int8")
    emit(phase="llama_tenancy_budget", hbm_budget_bytes=BUDGET_BYTES,
         arena_bytes=arena_bytes, slots=beng.pool.slots,
         ledger_slots=want, ledger_slots_without_tenancy=plain)
    check(beng.pool.slots == want, f"budget with tenancy: "
                                   f"{beng.pool.slots} slots, the ledger "
                                   f"sizes {want}")
    del beng
    gc.collect()
    release()
    return counts


def phase_gpt2_tenancy(device, card):
    """GPT-2 small (fp32) at ``engine``'s settings with an attention-only
    adapter (``q_proj|v_proj``, r 4, alpha 8: JAX's fixture) made with
    ``peft`` (B ~ N(0, 0.1)): 16 mixed requests (16-128 + 64 tokens, every
    other one under the adapter), launches as in ``engine`` (counters
    zeroed just before, read just after), each lane captured once; each
    adapter request's greedy tokens equal ``generate`` under the
    ``merge_lora`` weights, each base request's under the plain ones (a
    divergence only at a top-2 gap under 1e-4). Returns the launch
    counts."""
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.peft import LoraConfig, inject_lora, merge_lora
    from hetu_tpu_torch.serving import (
        SamplingParams, ServingEngine, TenantPlane, extract_adapter,
        lora_scaling,
    )

    t0 = time.perf_counter()
    cfg = GPTConfig.small()
    model = GPTLMHeadModel(cfg, device=device, seed=SEED).eval()
    lmodel = GPTLMHeadModel(cfg, device=device, seed=SEED)
    inject_lora(lmodel, LoraConfig(r=4, alpha=8.0, target_patterns=(
        r"\.(q_proj|v_proj)$",)), seed=SEED + 61)
    gen = torch.Generator(device=device).manual_seed(SEED + 62)
    with torch.no_grad():
        for name, p in lmodel.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.1, generator=gen)
    weights = extract_adapter(lmodel.state_dict())
    scale = lora_scaling(lmodel)
    merged = GPTLMHeadModel(cfg, device=device, seed=SEED).eval()
    merged.load_state_dict(merge_lora(lmodel))
    del lmodel
    n, lo_len, hi_len, new = GPT2_SPEC
    rng = np.random.default_rng(SEED + 63)
    prompts = [rng.integers(0, cfg.vocab_size, int(k)).tolist()
               for k in rng.integers(lo_len, hi_len + 1, n)]
    sps = [SamplingParams(max_tokens=new, tenant="acme", adapter="fr")
           if i % 2 == 0 else SamplingParams(max_tokens=new)
           for i in range(n)]
    before = trace_counts()
    eng = ServingEngine(model, slots=16, max_len=512, prefill_chunk=64,
                        block_size=16, seed=SEED, device=device,
                        tenancy=TenantPlane(max_adapters=4, r=4))
    info = eng.load_adapter("acme", "fr", weights, scaling=scale)
    # ---- the main path: counters zeroed just before, read after ----
    reset_launch_counts()
    reqs, steps, wall = serve_tenants(eng, prompts, sps)
    counts = launch_counts()
    iters = dict(eng.lane_iters)
    # ---------------------------------------------------------------
    check_captures("gpt2_tenancy", eng, before)
    check_launches("gpt2_tenancy_launches", counts, iters, cfg.num_layers)
    ad = [r for r in reqs if r.sampling.adapter]
    base = [r for r in reqs if not r.sampling.adapter]
    generate_oracle("gpt2_tenancy_adapter_oracle", merged, ad, new, device)
    generate_oracle("gpt2_tenancy_base_oracle", model, base, new, device)
    base_want = oracle_generate(model, [r.prompt.tolist() for r in ad],
                                new, device, tag="gpt2_tenancy")
    changed = sum(base_want[tuple(r.prompt.tolist())][0] != r.tokens
                  for r in ad)
    gen_toks = sum(len(r.tokens) for r in reqs)
    emit(phase="gpt2_tenancy", card=card, config="GPTConfig.small",
         dtype="float32", adapter="q_proj|v_proj, r 4, alpha 8",
         load=info, requests=n, adapter_requests=len(ad),
         adapter_requests_changed_by_adapter=changed,
         tokens_per_s=gen_toks / wall, per_tenant=per_tenant(reqs),
         lanes=capture_stats(eng), seconds=time.perf_counter() - t0)
    del eng, model, merged
    gc.collect()
    release()
    return counts


def phase_gpt2_spec_small_draft(device, card):
    """GPT-2 small (fp32) at ``engine``'s settings with ``spec_depth=4``
    and ``draft_model=`` a 2-layer GPT of GPT-2 small's width from
    another seed, whose vocabulary (50,304) is larger than the target's
    (50,257: drafts past it are masked, q given over the target's
    vocabulary). Launches (counters zeroed just before the greedy run,
    read just after) exactly 12 #1 per verify and prefill replay plus 2
    x K per draft step, 12 #2 per prefill replay; each lane and the draft
    step captured once. Greedy: the tokens of spec-off ``generate`` but
    at a near tie. T = 1.0 (per-request seeds): residual resamples
    happen, two runs from the same seeds are bit-equal, every token
    lies in the target's vocabulary. Returns the greedy run's counts."""
    import dataclasses
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    t0 = time.perf_counter()
    cfg = GPTConfig.small()
    dcfg = dataclasses.replace(cfg, num_layers=2, vocab_size=50304)
    model = GPTLMHeadModel(cfg, device=device, seed=SEED).eval()
    draft_model = GPTLMHeadModel(dcfg, device=device, seed=SEED + 65).eval()
    n, lo_len, hi_len, new = GPT2_SPEC
    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(0, cfg.vocab_size, int(k)).tolist()
               for k in rng.integers(lo_len, hi_len + 1, n)]
    before = trace_counts()
    eng = ServingEngine(model, slots=16, max_len=512, prefill_chunk=64,
                        block_size=16, seed=SEED, device=device,
                        spec_depth=SPEC_DEPTH, draft_model=draft_model)
    draft = eng._draftsman
    check(draft.graph.captures == 1, "the draft step was not captured once")
    stats0 = dict(eng.spec_stats)
    # ---- the main path: counters zeroed just before, read after ----
    reset_launch_counts()
    steps0 = draft.steps
    reqs, steps, wall = serve_stepped(eng, prompts,
                                      SamplingParams(max_tokens=new))
    counts = launch_counts()
    iters = dict(eng.lane_iters)
    draft_steps = draft.steps - steps0
    # ---------------------------------------------------------------
    L = cfg.num_layers
    want = {"paged_attention": L * (iters["decode"] + iters["prefill"])
            + dcfg.num_layers * SPEC_DEPTH * draft_steps,
            "flash_fwd": L * iters["prefill"], "paged_attention_int8": 0}
    greedy = spec_reading(eng, reqs, steps, wall, stats0)
    emit(phase="gpt2_spec_small_draft_launches", counts=counts,
         lane_iters=iters, draft_steps=draft_steps, expected=want)
    check(all(counts.get(k, 0) == v for k, v in want.items()),
          f"gpt2_spec_small_draft: launches {counts}, expected {want}")
    generate_oracle("gpt2_spec_small_draft_oracle", model, reqs, new,
                    device)
    sps = [SamplingParams(max_tokens=new, temperature=1.0, seed=3000 + i)
           for i in range(n)]
    runs = []
    for _ in range(2):
        stats0 = dict(eng.spec_stats)
        rs, st, w = serve_stepped(eng, prompts, sps)
        runs.append((rs, spec_reading(eng, rs, st, w, stats0)))
    (a, sampled), (b, _) = runs
    replay_equal = [r.tokens for r in a] == [r.tokens for r in b]
    in_vocab = all(0 <= t < cfg.vocab_size for r in a + b for t in r.tokens)
    emit(phase="gpt2_spec_small_draft", card=card, config="GPTConfig.small",
         draft="GPT-2 small width, 2 layers, vocab 50304, seed "
               f"{SEED + 65}", dtype="float32", spec_depth=SPEC_DEPTH,
         requests=n, max_tokens=new, greedy=greedy,
         sampled_t1=sampled, sampled_replay_bit_equal=replay_equal,
         sampled_tokens_in_target_vocab=in_vocab,
         draft_captures=draft.graph.captures,
         seconds=time.perf_counter() - t0)
    check(sampled["resampled"] > 0, "gpt2_spec_small_draft: no residual "
                                    "resample at T = 1.0")
    check(replay_equal, "gpt2_spec_small_draft: the T = 1.0 replay differs")
    check(in_vocab, "gpt2_spec_small_draft: a token past the target's "
                    "vocabulary")
    check_captures("gpt2_spec_small_draft", eng, before)
    check(draft.graph.captures == 1, "the draft step re-captured")
    del eng, draft, model, draft_model
    gc.collect()
    release()
    return counts


# ---- the online front end: the engine's loop behind the line-protocol
# server, driven by the port's client from threads of this script ------------

#: every client socket read and stream event waits at most this long
WIRE_TIMEOUT_S = 120.0
#: the client modes; each takes a third of a burst, over two threads
WIRE_MODES = ("generate", "submit", "stream")
WIRE_THREADS_PER_MODE = 2
#: the swap round: the shared-prompt requests served on each weight set
SWAP_REQUESTS, SWAP_NEW = 8, 16


def record_requests(eng) -> dict:
    """Keep every Request ``eng`` makes, by id: the server's poll map
    drops a request once its RESULT is read, and the oracles read the
    engine's own Request (prompt, tokens, recorded first-token logits).
    The server calls ``engine.submit``, so this wraps it on the
    instance."""
    made = {}
    real = eng.submit

    def submit(*args, **kw):
        req = real(*args, **kw)
        made[req.id] = req
        return req

    eng.submit = submit
    return made


class FrameTap:
    """Records the token events every stream client of this process
    receives (the channel, request id, offset and tokens), by wrapping
    ``StreamChannel._dispatch`` while the context is open."""

    def __init__(self):
        self.frames: list = []
        self._serial = itertools.count()

    def __enter__(self):
        from hetu_tpu_torch.rpc import stream
        self._real = real = stream.StreamChannel._dispatch
        tap = self

        def dispatch(ch, fr):
            if fr.get("k") == "ev":
                if not hasattr(ch, "_tap_serial"):
                    ch._tap_serial = next(tap._serial)
                tap.frames.append((ch._tap_serial, int(fr["req"]),
                                   int(fr["off"]),
                                   [int(t) for t in fr["toks"]]))
            return real(ch, fr)

        stream.StreamChannel._dispatch = dispatch
        return self

    def __exit__(self, *exc):
        from hetu_tpu_torch.rpc import stream
        stream.StreamChannel._dispatch = self._real

    def check(self, phase, finals: dict) -> dict:
        """Every streamed request's events run contiguously from offset 0
        and their tokens make up its final tokens (``finals``: request id
        -> tokens), across reconnects. Returns each request's number of
        channels."""
        by_req: dict = {}
        for ch, rid, off, toks in self.frames:
            by_req.setdefault(rid, []).append((ch, off, toks))
        for rid, frs in by_req.items():
            got = []
            for _, off, toks in frs:
                check(off == len(got), f"{phase}: request {rid}: an event "
                      f"at offset {off} after {len(got)} tokens")
                got += toks
            check(got == finals[rid], f"{phase}: request {rid}: streamed "
                  f"tokens differ from its final tokens")
        return {rid: len({f[0] for f in frs}) for rid, frs in by_req.items()}


def wire_client(port, mode, prompts, max_tokens, kill_first=False) -> list:
    """One client thread's requests, all in ``mode``: ``generate`` (the
    blocking verb, one at a time), ``submit`` (every SUBMIT, then RESULT
    polls) or ``stream`` (``generate_stream`` one at a time, then RESULT
    for its tokens). ``kill_first`` shuts the stream socket after the
    first token event of the first request: the client reconnects and
    resubscribes at its offset. Returns one record a request: the prompt,
    the result document and the client's clock."""
    import socket

    from hetu_tpu_torch.rpc import CoordinatorClient
    cli = CoordinatorClient(port, timeout=WIRE_TIMEOUT_S)
    out = []
    try:
        if mode == "submit":
            sent = [(p, time.perf_counter(),
                     cli.serving_submit(p, max_tokens=max_tokens))
                    for p in prompts]
            for p, t0, rid in sent:
                doc, deadline = None, time.monotonic() + WIRE_TIMEOUT_S
                while doc is None:
                    check(time.monotonic() < deadline,
                          f"request {rid}: no RESULT in {WIRE_TIMEOUT_S} s")
                    doc = cli.serving_result(rid, timeout_ms=1000)
                out.append(dict(mode=mode, prompt=p, doc=doc, t0=t0,
                                t_done=time.perf_counter(), killed=False))
            return out
        for i, p in enumerate(prompts):
            t0 = time.perf_counter()
            if mode == "generate":
                doc = cli.serving_generate(p, max_tokens=max_tokens)
                out.append(dict(mode=mode, prompt=p, doc=doc, t0=t0,
                                t_done=time.perf_counter(), killed=False))
                continue
            toks, t_first, doc, killed = [], None, None, False
            for ev in cli.generate_stream(p, max_tokens=max_tokens,
                                          event_timeout_s=WIRE_TIMEOUT_S):
                if ev["tokens"] and t_first is None:
                    t_first = time.perf_counter()
                toks += ev["tokens"]
                if ev["done"]:
                    doc = ev["result"]
                elif kill_first and i == 0 and toks and not killed:
                    killed = True
                    cli._stream._sock.shutdown(socket.SHUT_RDWR)
            t_done = time.perf_counter()
            polled = cli.serving_result(doc["id"], timeout_ms=0)
            out.append(dict(mode=mode, prompt=p, doc=doc, streamed=toks,
                            result_tokens=polled["tokens"], killed=killed,
                            t0=t0, t_first=t_first, t_done=t_done))
    finally:
        cli.close()
    return out


def run_wire(port, jobs) -> tuple:
    """``jobs``: ``(mode, prompts, max_tokens, kill_first)``, one client
    thread each, all at once. Returns the records and the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = [pool.submit(wire_client, port, *job) for job in jobs]
        recs = [r for f in futs for r in f.result()]
    return recs, time.perf_counter() - t0


def burst_jobs(burst, new, kill=False) -> list:
    """A third of ``burst`` (every third prompt) in each client mode, each
    third over two threads; ``kill``: the first stream thread kills its
    first request's socket."""
    jobs = []
    for k, mode in enumerate(WIRE_MODES):
        third = burst[k::len(WIRE_MODES)]
        for j in range(WIRE_THREADS_PER_MODE):
            jobs.append((mode, third[j::WIRE_THREADS_PER_MODE], new,
                         kill and mode == "stream" and j == 0))
    return jobs


def check_wire(phase, recs, made) -> dict:
    """Every request done, its client tokens the engine's own; a streamed
    request's events and its RESULT read after the stream give those
    tokens too."""
    for r in recs:
        doc = r["doc"]
        req = made[doc["id"]]
        check(doc["status"] == "done" and req.status == "done",
              f"{phase}: request {doc['id']} is {doc['status']}")
        check(doc["tokens"] == list(req.tokens),
              f"{phase}: request {doc['id']}: the client's tokens are not "
              f"the engine's")
        if r["mode"] == "stream":
            check(r["streamed"] == doc["tokens"] == r["result_tokens"],
                  f"{phase}: request {doc['id']}: streamed, final and "
                  f"RESULT tokens differ")
    return {r["doc"]["id"]: r["doc"]["tokens"] for r in recs}


def wire_latency(recs) -> dict:
    """Client-side TTFT and TPOT of the streamed requests (killed ones
    aside) beside the engine's own ``Request.timing()`` for the same
    requests, and GENERATE's client-side total beside the engine's: the
    difference is what the wire and the loop add."""
    st = [r for r in recs if r["mode"] == "stream" and not r["killed"]
          and len(r["streamed"]) > 1]
    gen = [r for r in recs if r["mode"] == "generate"]
    c_ttft = [(r["t_first"] - r["t0"]) * 1e3 for r in st]
    e_ttft = [r["doc"]["timing"]["ttft_ms"] for r in st]
    c_tpot = [(r["t_done"] - r["t_first"]) * 1e3 / (len(r["streamed"]) - 1)
              for r in st]
    e_tpot = [r["doc"]["timing"]["decode_ms"] / (len(r["streamed"]) - 1)
              for r in st]
    c_tot = [(r["t_done"] - r["t0"]) * 1e3 for r in gen]
    e_tot = [r["doc"]["timing"]["total_ms"] for r in gen]
    out = dict(stream_requests=len(st), generate_requests=len(gen))
    for name, xs in (("client_ttft_ms", c_ttft), ("engine_ttft_ms", e_ttft),
                     ("client_tpot_ms", c_tpot), ("engine_tpot_ms", e_tpot),
                     ("generate_client_total_ms", c_tot),
                     ("generate_engine_total_ms", e_tot),
                     ("stream_ttft_added_ms", np.subtract(c_ttft, e_ttft)),
                     ("generate_total_added_ms", np.subtract(c_tot, e_tot))):
        out[name + "_p50"] = percentile(xs, 50)
        out[name + "_p99"] = percentile(xs, 99)
    return out


def stream_counters(reg) -> dict:
    return dict(
        subscribes_new=reg.counter(
            "serving_stream_subscribes_total").value(mode="new"),
        subscribes_resume=reg.counter(
            "serving_stream_subscribes_total").value(mode="resume"),
        poll_fallbacks=reg.counter(
            "serving_stream_fallbacks_total").value(reason="client_poll"),
        subscriber_drops=reg.counter(
            "serving_stream_subscriber_drops_total").value())


def phase_gpt2_server(device, card, gpt2):
    """GPT-2 small behind ``ServingServer``, its loop running, at
    ``engine``'s settings: ``engine``'s 48 burst prompts in three client
    modes over 6 threads (one stream socket killed mid-request), then the
    16 shared-prefix prompts streamed. Returns the launch counts."""
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import ServingEngine, ServingServer

    model = gpt2["model"]
    cfg = model.cfg
    burst, shared = workload(cfg.vocab_size)
    new = 64
    before = trace_counts()
    t0 = time.perf_counter()
    eng = ServingEngine(model, slots=16, max_len=512, prefill_chunk=64,
                        block_size=16, seed=SEED, device=device)
    made = record_requests(eng)
    srv = ServingServer(eng, 0)
    srv.start()
    srv.wait_ready()
    emit(phase="gpt2_server_setup", config="GPTConfig.small",
         dtype="float32", slots=16, max_len=512, prefill_chunk=64,
         block_size=16, port=srv.port, client_threads=len(burst_jobs(
             burst, new)), lanes=capture_stats(eng),
         seconds=time.perf_counter() - t0)
    telemetry.reset()
    telemetry.enable(True)
    try:
        with FrameTap() as tap:
            # ---- the main path: counters zeroed just before, read after -
            reset_launch_counts()
            recs, t_burst = run_wire(srv.port, burst_jobs(burst, new,
                                                          kill=True))
            first, _ = run_wire(srv.port, [("stream", shared[:1], new)])
            rest, t_shared = run_wire(srv.port, [
                ("stream", shared[1 + j::5], new) for j in range(5)])
            counts = launch_counts()
            iters = dict(eng.lane_iters)
            # ------------------------------------------------------------
        counters = stream_counters(telemetry.get_registry())
    finally:
        telemetry.enable(False)
        telemetry.reset()
        srv.stop()
    check(eng._thread is None, "gpt2_server: stop() left the loop thread")
    check_captures("gpt2_server", eng, before)
    check_launches("gpt2_server_launches", counts, iters, cfg.num_layers)
    finals = check_wire("gpt2_server", recs + first + rest, made)
    channels = tap.check("gpt2_server", finals)
    killed = [r["doc"]["id"] for r in recs if r["killed"]]
    check(len(killed) == 1, f"gpt2_server: {len(killed)} streams killed")
    check(channels[killed[0]] == 2 and counters["subscribes_resume"] == 1,
          f"gpt2_server: the killed stream did not resume on a second "
          f"channel ({channels[killed[0]]} channels, {counters})")
    check(counters["poll_fallbacks"] == 0
          and counters["subscriber_drops"] == 0,
          f"gpt2_server: a stream fell back to polling: {counters}")
    hits = sum(r["doc"]["timing"]["cached_tokens"] for r in rest)
    check(hits >= 15 * 128, f"gpt2_server: the shared prompts hit only "
                            f"{hits} cached tokens")
    gen_tokens = sum(len(r["doc"]["tokens"]) for r in recs)
    emit(phase="gpt2_server", card=card, burst_requests=len(recs),
         burst_generated_tokens=gen_tokens, burst_seconds=t_burst,
         burst_tokens_per_s=gen_tokens / t_burst,
         engine_burst_tokens_per_s=gpt2["perf"]["burst_tokens_per_s"],
         engine_ttft_ms_p50_in_process=gpt2["perf"]["ttft_ms_p50"],
         engine_tpot_ms_p50_in_process=gpt2["perf"]["tpot_ms_p50"],
         shared_requests=1 + len(rest), shared_prefix_hit_tokens=hits,
         shared_seconds=t_shared, killed_request=killed[0],
         stream_channels=sorted(set(channels.values())),
         stream_frames=len(tap.frames), **counters, **wire_latency(recs))
    generate_oracle("gpt2_server_oracle", model,
                    [made[r["doc"]["id"]] for r in recs + first + rest],
                    new, device, memo=gpt2["oracle"])
    return counts


# -- the in-process serving fleet -------------------------------------------

#: every fleet wait gives up after this long
FLEET_WAIT_S = 300.0
#: the kill phase: requests, their budget, and the tokens its victim's
#: busiest request must have before the kill
KILL_REQUESTS, KILL_NEW, KILL_AFTER = 16, 64, 8
#: the push phase: trickle requests, their budget, their spacing (s)
PUSH_TRICKLE, PUSH_NEW, PUSH_GAP_S = 24, 16, 0.02
#: the front door's GENERATE and SUBMIT requests
SERVER_REQUESTS = 6


def fleet_engine(model, device):
    """A GPT-2 small replica at ``engine``'s settings."""
    from hetu_tpu_torch.serving import ServingEngine
    return ServingEngine(model, slots=16, max_len=512, prefill_chunk=64,
                         block_size=16, seed=SEED, device=device)


def wait_done(phase, rreqs) -> None:
    for r in rreqs:
        check(r.done.wait(FLEET_WAIT_S),
              f"{phase}: request {r.id} not done in {FLEET_WAIT_S} s")


def replica_launches(eng) -> dict:
    """One replica's kernel launches: each lane's launches a replay times
    the replays (``lane_iters``)."""
    out: dict = {}
    for lane, g in eng.lanes.items():
        for name, n in g.launches.items():
            out[name] = out.get(name, 0) + n * eng.lane_iters[lane]
    return out


def check_fleet_launches(phase, counts, replicas, layers, built=()) -> dict:
    """Each replica's #1 and #2 tallies are its own lane iterations times
    the layers (``check_launches``' formula), and the process counters,
    zeroed just before the phase's traffic, are their sum plus the
    warm-up launches of the replicas in ``built`` (built after the
    zeroing, while a peer served)."""
    per = {}
    for name, eng in replicas.items():
        mine = replica_launches(eng)
        iters = dict(eng.lane_iters)
        want = {"paged_attention": layers * (iters["decode"]
                                             + iters["prefill"]),
                "flash_fwd": layers * iters["prefill"]}
        per[name] = dict(launches=mine, lane_iters=iters, expected=want)
        for k, n in want.items():
            check(mine.get(k, 0) == n,
                  f"{phase}: replica {name}: {k} {mine.get(k, 0)} "
                  f"launches, expected {n}")
    total: dict = {}
    tallies = [replica_launches(eng) for eng in replicas.values()] \
        + [g.warmup_launches for eng in built for g in eng.lanes.values()]
    for tally in tallies:
        for k, n in tally.items():
            total[k] = total.get(k, 0) + n
    emit(phase=phase, replicas=per, counts=counts,
         expected_counts=total)
    for k in ("paged_attention", "flash_fwd"):
        check(counts.get(k, 0) > 0, f"{phase}: {k} never launched")
        check(counts.get(k, 0) == total.get(k, 0),
              f"{phase}: {k}: {counts.get(k, 0)} launches, the replicas "
              f"account for {total.get(k, 0)}")
    return per


def check_fleet_captures(phase, replicas) -> None:
    for name, eng in replicas.items():
        check_captures(f"{phase}_{name}", eng)


def check_tokens(phase, rows, new) -> dict:
    """``oracle_divergences``, printed as one line."""
    near = oracle_divergences(phase, rows, new)
    line = dict(phase=phase, requests=len(rows),
                identical=len(rows) - len(near), near_ties=near)
    emit(**line)
    return line


def router_latency(rreqs, first=None) -> dict:
    """Router-level TTFT (submit → the request's first token, wherever it
    was sampled: ``first`` maps a request id to that time, default its
    last engine request's) and TPOT (first token → finish over the later
    tokens), p50 and p99, in ms."""
    ttft, tpot = [], []
    for r in rreqs:
        t1 = r.inner.first_token_s if first is None else first[r.id]
        ttft.append((t1 - r.submit_s) * 1e3)
        if len(r.tokens) > 1:
            tpot.append((r.finish_s - t1) * 1e3 / (len(r.tokens) - 1))
    return dict(ttft_ms_p50=percentile(ttft, 50),
                ttft_ms_p99=percentile(ttft, 99),
                tpot_ms_p50=percentile(tpot, 50),
                tpot_ms_p99=percentile(tpot, 99))


def series_by(reg, name, label) -> dict:
    return {dict(k).get(label): v
            for k, v in reg.counter(name)._values.items()}


def phase_gpt2_fleet(device, card, gpt2):
    """Two GPT-2 small replicas behind one Router, the second built and
    registered while the first serves the first half of ``engine``'s
    burst; then the whole burst on the settled fleet (its caches flushed,
    as ``engine``'s burst found its own), for the throughput beside
    ``engine``'s; then the 16 shared-prefix prompts one at a time."""
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import Router, SamplingParams

    model, memo = gpt2["model"], gpt2["oracle"]
    cfg = model.cfg
    burst, shared = workload(cfg.vocab_size)
    sp = SamplingParams(max_tokens=64)
    before = trace_counts()
    telemetry.reset()
    telemetry.enable(True)
    router = Router(poll_s=0.001)
    try:
        e0 = fleet_engine(model, device)
        check_captures("gpt2_fleet_setup_r0", e0)
        # ---- the main path: counters zeroed just before, read after ----
        reset_launch_counts()
        router.register("r0", e0)
        half = len(burst) // 2
        first = [router.submit(p, sp) for p in burst[:half]]
        busy = e0.has_work()
        it0 = dict(e0.lane_iters)
        t0 = time.perf_counter()
        e1 = fleet_engine(model, device)        # captures while r0 serves
        build_s = time.perf_counter() - t0
        it1 = dict(e0.lane_iters)
        check_captures("gpt2_fleet_setup_r1", e1)
        router.register("r1", e1)
        second = [router.submit(p, sp) for p in burst[half:]]
        wait_done("gpt2_fleet", first + second)
        mid = dict(build_seconds=build_s, r0_busy_at_build=busy,
                   r0_iterations_during_build={
                       k: it1[k] - it0[k] for k in it0},
                   served_by_r0=sum(r.replica == "r0"
                                    for r in first + second))
        check(busy, "gpt2_fleet: r0 had no work when r1 was built")
        # the throughput burst on the settled fleet, caches flushed
        for eng in (e0, e1):
            with eng._lock:
                eng.prefix_cache.evict(eng.pool.n_blocks)
        with router._lock:
            router._directory.flush_stale(below_version=1 << 30)
        dispatched0 = {n: h.dispatched for n, h in router._replicas.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tput = [router.submit(p, sp) for p in burst]
        wait_done("gpt2_fleet", tput)
        t_burst = time.perf_counter() - t1
        spread = {n: h.dispatched - dispatched0[n]
                  for n, h in router._replicas.items()}
        # the shared prompts one at a time on the idle fleet
        solo = []
        for p in shared:
            solo.append(router.submit(p, sp))
            wait_done("gpt2_fleet", solo[-1:])
        counts = launch_counts()
        # -----------------------------------------------------------------
        replicas = {"r0": e0, "r1": e1}
        per = check_fleet_launches("gpt2_fleet_launches", counts, replicas,
                                   cfg.num_layers, built=(e1,))
        check_fleet_captures("gpt2_fleet", replicas)
        since = {lane: trace_counts().get(k, 0) - before.get(k, 0)
                 for lane, k in TRACE_KEYS.items()}
        check(since == {"decode": 2, "prefill": 2},
              f"gpt2_fleet: captures since the replicas were built: "
              f"{since}, expected 2 a lane")
        everyone = first + second + tput + solo
        check(all(r.status == "done" for r in everyone),
              "gpt2_fleet: a request did not finish")
        check_tokens("gpt2_fleet_oracle",
                     [(r.id, r.prompt, list(r.tokens), memo)
                      for r in everyone], 64)
        check(all(n > 0 for n in spread.values()),
              f"gpt2_fleet: a replica took none of the burst: {spread}")
        homes = {r.replica for r in solo}
        cached = [r.result()["timing"]["cached_tokens"] for r in solo]
        check(len(homes) == 1 and all(c >= 128 for c in cached[1:]),
              f"gpt2_fleet: the shared prefix landed on {homes}, cached "
              f"{cached}")
        reg = telemetry.get_registry()
        gen = sum(len(r.tokens) for r in tput)
        perf = dict(burst_tokens_per_s=gen / t_burst,
                    **router_latency(tput))
        engine = gpt2["perf"]
        emit(phase="gpt2_fleet", card=card, replicas=2, **mid,
             burst_requests=len(tput), burst_generated_tokens=gen,
             burst_seconds=t_burst, **perf,
             burst_dispatch=spread,
             engine_burst_tokens_per_s=engine["burst_tokens_per_s"],
             engine_ttft_ms_p50=engine["ttft_ms_p50"],
             engine_ttft_ms_p99=engine["ttft_ms_p99"],
             engine_tpot_ms_p50=engine["tpot_ms_p50"],
             fleet_over_engine_tokens_per_s=perf["burst_tokens_per_s"]
             / engine["burst_tokens_per_s"],
             shared_replica=sorted(homes), shared_cached_tokens=cached,
             dispatch_reasons=series_by(reg, "router_dispatch_reason_total",
                                        "reason"),
             replica_launches={n: p["launches"] for n, p in per.items()})
    finally:
        router.stop()
        telemetry.enable(False)
        telemetry.reset()
    return counts, perf


def decode_step_ms(model, device, prompts, replicate: bool) -> dict:
    """Median host ms of a steady decode step (no prefill in it) of one
    replica serving ``prompts`` at ``KILL_NEW`` tokens, with its decode KV
    replicated to a store every 20 ms or not."""
    from hetu_tpu_torch.serving import KVReplicaStore, SamplingParams
    eng = fleet_engine(model, device)
    store = KVReplicaStore()
    if replicate:
        eng.configure_replication(store.put, origin="probe")
    try:
        for p in prompts:
            eng.submit(p, SamplingParams(max_tokens=KILL_NEW))
        times = []
        while eng.has_work():
            pf = eng.lane_iters["prefill"]
            t0 = time.perf_counter()
            eng.step()
            if eng.lane_iters["prefill"] == pf:
                times.append((time.perf_counter() - t0) * 1e3)
    finally:
        eng.configure_replication(None)
        eng.stop()
    return dict(steps=len(times), ms_p50=percentile(times, 50),
                ms_p99=percentile(times, 99), ms_max=max(times),
                shipments=store.put_total)


def phase_gpt2_fleet_kill(device, card, gpt2):
    """Two replicas with decode-KV replication on; 16 requests; the
    replica with the most in flight killed mid-decode (its arena
    salvaged). Then a fresh pair whose victim's arena cannot be read:
    recovery from the buddy's replica store. Decode step ms with
    replication on beside off."""
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import Router, SamplingParams

    model, memo = gpt2["model"], gpt2["oracle"]
    cfg = model.cfg
    burst, _ = workload(cfg.vocab_size)
    prompts = burst[:KILL_REQUESTS]
    sp = SamplingParams(max_tokens=KILL_NEW)
    telemetry.reset()
    telemetry.enable(True)
    reg = telemetry.get_registry()
    readings, counts = {}, {}
    try:
        for case in ("salvage", "buddy"):
            router = Router(poll_s=0.001, replicate_kv=True)
            try:
                engines = {n: fleet_engine(model, device)
                           for n in ("r0", "r1")}
                for n, eng in engines.items():
                    router.register(n, eng)
                deadline = time.monotonic() + FLEET_WAIT_S
                while len(router._buddy_of) < 2:
                    check(time.monotonic() < deadline,
                          f"gpt2_fleet_kill: buddies never wired")
                    time.sleep(0.001)
                c0 = {k: reg.counter(k).value() for k in (
                    "router_resumed_requeues_total",
                    "fleet_kv_recoveries_total")}
                done0 = reg.counter("serving_requests_total").value(
                    outcome="completed")
                # ---- the main path: counters zeroed just before ----------
                reset_launch_counts()
                rreqs = [router.submit(p, sp) for p in prompts]

                def ready():
                    with router._lock:
                        h = max(router._replicas.values(),
                                key=lambda x: len(x.inflight))
                        live = [r for r in h.inflight.values()
                                if r.inner is not None
                                and r.inner.status == "decode"]
                        if not live or max(len(r.inner.tokens)
                                           for r in live) < KILL_AFTER:
                            return None
                        if case == "buddy":
                            store = router._replicas[
                                router._buddy_of[h.name]
                            ].engine.kv_replica_store
                            if not any(r.trace_id in store for r in live):
                                return None
                        return h
                deadline = time.monotonic() + FLEET_WAIT_S
                while (victim := ready()) is None:
                    check(time.monotonic() < deadline,
                          f"gpt2_fleet_kill {case}: no request reached "
                          f"{KILL_AFTER} tokens")
                    time.sleep(0.0005)
                if case == "buddy":
                    def unreachable(*a, **k):
                        raise RuntimeError("arena unreachable")
                    victim.engine.evict_request = unreachable
                inflight = len(victim.inflight)
                requeued = router.kill_replica(victim.name)
                wait_done("gpt2_fleet_kill", rreqs)
                victim.engine._thread.join(timeout=FLEET_WAIT_S)
                counts_case = launch_counts()
                # ----------------------------------------------------------
                for k, n in counts_case.items():
                    counts[k] = counts.get(k, 0) + n
                check_fleet_launches(f"gpt2_fleet_kill_{case}_launches",
                                     counts_case, engines, cfg.num_layers)
                check_fleet_captures(f"gpt2_fleet_kill_{case}", engines)
                check(all(r.status == "done" for r in rreqs),
                      f"gpt2_fleet_kill {case}: a request did not finish")
                done = reg.counter("serving_requests_total").value(
                    outcome="completed") - done0
                check(done == len(rreqs),
                      f"gpt2_fleet_kill {case}: {done} completions for "
                      f"{len(rreqs)} requests")
                check_tokens(f"gpt2_fleet_kill_{case}_oracle",
                             [(r.id, r.prompt, list(r.tokens), memo)
                              for r in rreqs], KILL_NEW)
                delta = {k: reg.counter(k).value() - v
                         for k, v in c0.items()}
                resumed = sum(bool(r.result()["timing"].get("resumed"))
                              for r in rreqs)
                check(router.requeues_total > 0,
                      f"gpt2_fleet_kill {case}: nothing requeued")
                if case == "salvage":
                    check(delta["router_resumed_requeues_total"] >= 1,
                          f"gpt2_fleet_kill: no salvaged spill was resumed "
                          f"by the peer: {delta}")
                else:
                    check(delta["fleet_kv_recoveries_total"] >= 1
                          and resumed >= 1,
                          f"gpt2_fleet_kill: no recovery from the buddy's "
                          f"store: {delta}, resumed {resumed}")
                readings[case] = dict(
                    victim=victim.name, victim_inflight=inflight,
                    requeued=requeued, requeues_total=router.requeues_total,
                    resumed_requests=resumed, **delta,
                    replicated_blocks=reg.counter(
                        "fleet_kv_replicated_blocks_total").value())
            finally:
                router.stop()
    finally:
        telemetry.enable(False)
        telemetry.reset()
    decode_prompts = [p for p in burst if len(p) <= 512 - KILL_NEW][:16]
    steps = {"off": decode_step_ms(model, device, decode_prompts, False),
             "on": decode_step_ms(model, device, decode_prompts, True)}
    emit(phase="gpt2_fleet_kill", card=card, requests=KILL_REQUESTS,
         max_tokens=KILL_NEW, **readings, decode_step_replication=steps,
         heap_objects=len(gc.get_objects()),
         decode_step_ms_on_over_off=steps["on"]["ms_p50"]
         / steps["off"]["ms_p50"])
    return counts


def phase_gpt2_fleet_push(device, card, gpt2):
    """A rolling push of a seed-1 GPT-2 small into two replicas (each its
    own copy of ``engine``'s weights) under a trickle of 24 requests."""
    import copy
    import threading

    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.models import GPTLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import Router, SamplingParams, \
        WeightPublisher

    model, memo = gpt2["model"], gpt2["oracle"]
    cfg = model.cfg
    burst, _ = workload(cfg.vocab_size)
    new_model = GPTLMHeadModel(cfg, device=device, seed=SEED + 1).eval()
    sp = SamplingParams(max_tokens=PUSH_NEW)
    telemetry.reset()
    telemetry.enable(True)
    router = Router(poll_s=0.001)
    try:
        engines = {n: fleet_engine(copy.deepcopy(model), device)
                   for n in ("r0", "r1")}
        for n, eng in engines.items():
            router.register(n, eng)
        publisher = WeightPublisher(router)
        trickle, floor, stop = [], [], threading.Event()

        def sampler():
            while not stop.is_set():
                floor.append(router.fleet_status()["live"])
                time.sleep(0.001)

        def submitter():
            for p in burst[:PUSH_TRICKLE]:
                trickle.append(router.submit(p, sp))
                time.sleep(PUSH_GAP_S)

        # ---- the main path: counters zeroed just before, read after -----
        reset_launch_counts()
        threads = [threading.Thread(target=sampler),
                   threading.Thread(target=submitter)]
        for t in threads:
            t.start()
        time.sleep(PUSH_GAP_S * 4)             # the trickle is under way
        report = publisher.publish(new_model)
        threads[1].join()
        stop.set()
        threads[0].join()
        wait_done("gpt2_fleet_push", trickle)
        after = router.generate_many(burst[PUSH_TRICKLE:PUSH_TRICKLE + 8],
                                     sp)
        counts = launch_counts()
        # -----------------------------------------------------------------
        check_fleet_launches("gpt2_fleet_push_launches", counts, engines,
                             cfg.num_layers)
        check_fleet_captures("gpt2_fleet_push", engines)
        check(all(r.status == "done" for r in trickle),
              f"gpt2_fleet_push: {[r.status for r in trickle]}")
        check(min(floor) >= 1, "gpt2_fleet_push: no live replica at some "
                               "point of the push")
        versions = [r.weight_version for r in trickle]
        check(set(versions) <= {0, 1}, f"gpt2_fleet_push: versions "
                                       f"{versions}")
        new_prompts = [r.prompt for r in trickle if r.weight_version == 1] \
            + burst[PUSH_TRICKLE:PUSH_TRICKLE + 8]
        memo1 = oracle_generate(new_model, new_prompts, PUSH_NEW, device,
                                tag="gpt2_fleet_push_oracle")
        check_tokens("gpt2_fleet_push_oracle",
                     [(r.id, r.prompt, list(r.tokens),
                       memo if r.weight_version == 0 else memo1)
                      for r in trickle]
                     + [(-1 - i, p, toks, memo1) for i, (p, toks) in
                        enumerate(zip(burst[PUSH_TRICKLE:PUSH_TRICKLE + 8],
                                      after))], PUSH_NEW)
        st = router.fleet_status()
        check(st["weight_versions"] == [1] and st["live"] == 2,
              f"gpt2_fleet_push: fleet after the push: {st}")
        reg = telemetry.get_registry()
        emit(phase="gpt2_fleet_push", card=card, trickle=len(trickle),
             max_tokens=PUSH_NEW, versions={v: versions.count(v)
                                            for v in (0, 1)},
             live_min=min(floor), push_ms=report["duration_ms"],
             replicas=report["replicas"],
             weight_push_bytes_total=reg.counter(
                 "weight_push_bytes_total").value(transport="reshard"),
             requeues_total=router.requeues_total,
             resumed_requeues=reg.counter(
                 "router_resumed_requeues_total").value())
    finally:
        router.stop()
        telemetry.enable(False)
        telemetry.reset()
    return counts


def phase_gpt2_fleet_pd(device, card, gpt2, colocated):
    """A prefill-role and a decode-role replica: ``engine``'s burst, each
    request prefilled on one, its KV handed to the other, decoded
    there."""
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import Router, SamplingParams

    model, memo = gpt2["model"], gpt2["oracle"]
    cfg = model.cfg
    burst, _ = workload(cfg.vocab_size)
    sp = SamplingParams(max_tokens=64)
    telemetry.reset()
    telemetry.enable(True)
    router = Router(poll_s=0.001)
    try:
        engines = {"pre": fleet_engine(model, device),
                   "dec": fleet_engine(model, device)}
        made = record_requests(engines["pre"])
        router.register("pre", engines["pre"], role="prefill")
        router.register("dec", engines["dec"], role="decode")
        # ---- the main path: counters zeroed just before, read after -----
        reset_launch_counts()
        t0 = time.perf_counter()
        rreqs = [router.submit(p, sp) for p in burst]
        wait_done("gpt2_fleet_pd", rreqs)
        t_burst = time.perf_counter() - t0
        counts = launch_counts()
        # -----------------------------------------------------------------
        check_fleet_launches("gpt2_fleet_pd_launches", counts, engines,
                             cfg.num_layers)
        check_fleet_captures("gpt2_fleet_pd", engines)
        check(all(r.status == "done" for r in rreqs),
              "gpt2_fleet_pd: a request did not finish")
        check_tokens("gpt2_fleet_pd_oracle",
                     [(r.id, r.prompt, list(r.tokens), memo)
                      for r in rreqs], 64)
        reg = telemetry.get_registry()
        handoffs = reg.counter("fleet_pd_handoffs_total").value()
        check(handoffs == len(rreqs), f"gpt2_fleet_pd: {handoffs} handoffs "
                                      f"for {len(rreqs)} requests")
        first = {r.trace_id: r.first_token_s for r in made.values()}
        gen = sum(len(r.tokens) for r in rreqs)
        emit(phase="gpt2_fleet_pd", card=card, requests=len(rreqs),
             handoffs=handoffs,
             fleet_kv_stream_blocks_total=reg.counter(
                 "fleet_kv_stream_blocks_total").value(),
             burst_seconds=t_burst, burst_tokens_per_s=gen / t_burst,
             **router_latency(rreqs, {r.id: first[r.trace_id]
                                      for r in rreqs}),
             colocated=colocated,
             lane_iters={n: dict(e.lane_iters) for n, e in engines.items()})
    finally:
        router.stop()
        telemetry.enable(False)
        telemetry.reset()
    return counts


def phase_gpt2_fleet_server(device, card, gpt2):
    """``launch_serving_fleet(build_engine, 2, port=0)``: GENERATE and
    SUBMIT + RESULT through the port's client, FLEET, DRAIN, RESUME and
    FLEETMETRICS; KVEXPORT and KVIMPORT between two ``ServingServer``s,
    the import refused after a swap; DUMPOBS merged by
    ``tools/fleet_trace.py``; ``tools/fleet_top.py --once``."""
    import io

    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.rpc import CoordinatorClient, launch_serving_fleet
    from hetu_tpu_torch.serving import ServingServer
    from hetu_tpu_torch.telemetry import parse_prometheus
    from hetu_tpu_torch.tools import fleet_top, fleet_trace

    model, memo = gpt2["model"], gpt2["oracle"]
    cfg = model.cfg
    burst, shared = workload(cfg.vocab_size)
    new = 64
    telemetry.reset()
    telemetry.enable(True)
    built = []

    def build(i):
        built.append(fleet_engine(model, device))
        return built[-1]

    fleet = launch_serving_fleet(build, 2, port=0)
    servers = []
    try:
        # ---- the main path: counters zeroed just before, read after -----
        reset_launch_counts()
        cli = CoordinatorClient(fleet.port, timeout=WIRE_TIMEOUT_S)
        docs = [cli.serving_generate(p, max_tokens=new)
                for p in burst[:SERVER_REQUESTS // 2]]
        ids = [cli.serving_submit(p, max_tokens=new)
               for p in burst[SERVER_REQUESTS // 2:SERVER_REQUESTS]]
        for rid in ids:
            doc, deadline = None, time.monotonic() + WIRE_TIMEOUT_S
            while doc is None:
                check(time.monotonic() < deadline,
                      f"gpt2_fleet_server: no RESULT for {rid}")
                doc = cli.serving_result(rid, timeout_ms=1000)
            docs.append(doc)
        check(all(d["status"] == "done" for d in docs),
              "gpt2_fleet_server: a wire request did not finish")
        check_tokens("gpt2_fleet_server_oracle",
                     [(d["id"], p, d["tokens"], memo)
                      for d, p in zip(docs, burst[:SERVER_REQUESTS])], new)
        st = cli.fleet_status()
        check(st["live"] == 2 and set(st["replicas"]) == {"r0", "r1"},
              f"gpt2_fleet_server: FLEET {st}")
        drained = cli.fleet_drain("r1")
        check(cli.fleet_status()["replicas"]["r1"]["state"] == "draining",
              "gpt2_fleet_server: DRAIN did not drain")
        health = cli.healthz()
        cli.fleet_resume("r1")
        check(cli.fleet_status()["live"] == 2,
              "gpt2_fleet_server: RESUME did not resume")
        fleet.router._tick()
        text = cli.fleet_metrics_text()
        series = parse_prometheus(text)
        per_replica = {n: f'replica="{n}"' in text for n in ("r0", "r1")}
        check(all(per_replica.values()),
              f"gpt2_fleet_server: FLEETMETRICS lacks a replica's series: "
              f"{per_replica}")
        # the KV verbs between two servers
        a = ServingServer(fleet_engine(model, device), 0)
        b = ServingServer(fleet_engine(model, device), 0)
        servers = [a, b]
        for srv in servers:
            srv.start()
            srv.wait_ready()
        ca = CoordinatorClient(a.port, timeout=WIRE_TIMEOUT_S)
        cb = CoordinatorClient(b.port, timeout=WIRE_TIMEOUT_S)
        ra = ca.serving_generate(shared[0], max_tokens=new)
        exported = ca.serving_kv_export(shared[0][:128])
        check(exported["spill"] is not None,
              "gpt2_fleet_server: KVEXPORT found no cached prefix")
        imported = cb.serving_kv_import(exported["spill"])
        rb = cb.serving_generate(shared[1], max_tokens=new)
        check(imported["ok"] and rb["timing"]["cached_tokens"] >= 128,
              f"gpt2_fleet_server: KVIMPORT {imported}, cached "
              f"{rb['timing']['cached_tokens']}")
        check_tokens("gpt2_fleet_server_kv_oracle",
                     [(ra["id"], shared[0], ra["tokens"], memo),
                      (rb["id"], shared[1], rb["tokens"], memo)], new)
        b.engine.swap_params(dict(model.named_parameters()))
        stale = cb.serving_kv_import(exported["spill"])
        check(stale["ok"] is False,
              "gpt2_fleet_server: an import after a swap was accepted")
        counts = launch_counts()
        # -----------------------------------------------------------------
        engines = {"r0": built[0], "r1": built[1], "kv_a": a.engine,
                   "kv_b": b.engine}
        check_fleet_launches("gpt2_fleet_server_launches", counts, engines,
                             cfg.num_layers, built=(a.engine, b.engine))
        check_fleet_captures("gpt2_fleet_server", engines)
        # the tools
        bundle = cli.dump_obs()
        merged = fleet_trace.merge_bundles([bundle])
        tid = docs[0]["timing"]["trace_id"]
        spans = fleet_trace.span_order(merged, tid)
        check("dispatch" in spans and "decode" in spans,
              f"gpt2_fleet_server: request {tid}'s merged track: {spans}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = fleet_top.main(["--port", str(fleet.port), "--once"])
        frame = out.getvalue()
        rows = [ln for ln in frame.splitlines()
                if ln.split()[:1] in (["r0"], ["r1"])]
        check(rc == 0 and len(rows) == 2,
              f"gpt2_fleet_server: fleet_top printed {frame!r}")
        for c in (cli, ca, cb):
            c.close()
        emit(phase="gpt2_fleet_server", card=card, port=fleet.port,
             requests=len(docs), drain=drained,
             healthz_status=health["status"],
             healthz_fleet=health.get("fleet"),
             fleetmetrics_samples=len(series[1]),
             kv_export_blocks=exported["spill"]["n_blocks"],
             kv_import=imported, kv_import_after_swap=stale,
             kv_cached_tokens=rb["timing"]["cached_tokens"],
             merged_track=spans, fleet_top_rows=rows)
    finally:
        for srv in servers:
            srv.stop()
        fleet.stop()
        telemetry.enable(False)
        telemetry.reset()
    check(all(e._thread is None for e in built),
          "gpt2_fleet_server: stop() left a loop thread")
    return counts


def phase_gpt2_rollout(device, card):
    """The port's ``run_rollout_loop`` on GPT-2 small: 2 rounds of 2
    replicas, 6 prompts a round, 2 SFT steps a round (bf16 compute), a
    trickle of 3 under each push."""
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.workloads import run_rollout_loop

    t0 = time.perf_counter()
    # ---- the main path: counters zeroed just before, read after ---------
    reset_launch_counts()
    out = run_rollout_loop(rounds=2, n_replicas=2, prompts_per_round=6,
                           max_tokens=8, steps_per_round=2, trickle=3,
                           model_size="small", device=device)
    counts = launch_counts()
    # ---------------------------------------------------------------------
    telemetry.enable(False)
    telemetry.reset()
    emit(phase="gpt2_rollout", card=card, counts=counts,
         seconds=time.perf_counter() - t0, **out)
    check(out["zero_downtime"], f"gpt2_rollout: {out['continuity']}")
    check(out["continuity"]["submitted"] == out["continuity"]["completed"]
          == 6, f"gpt2_rollout: {out['continuity']}")
    check([r["weight_version"] for r in out["rounds"]] == [1, 2],
          f"gpt2_rollout: versions {out['rounds']}")
    check(all(r["fleet_versions"] == [r["weight_version"]]
              for r in out["rounds"]), "gpt2_rollout: a replica lagged")
    check(all(np.isfinite(r["loss"]) for r in out["rounds"]),
          "gpt2_rollout: a non-finite loss")
    for name in ("paged_attention", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        check(counts.get(name, 0) > 0, f"gpt2_rollout: {name} never "
                                       f"launched")
    return counts


def weight_sums(model) -> list:
    return [checksum(p) for p in model.parameters()]


def phase_llama_server(device, card, model, llama_perf):
    """Llama-7B (bf16, int8 arena) behind ``ServingServer`` at
    ``llama_engine``'s settings, the engine built under ``BF16_FULL`` and
    started from this thread under the default policy:
    ``llama_workload``'s 48 burst prompts in three client modes, within
    the bf16 oracle, with one capture a lane. Then the weight swap
    (``llama_server_swap``). Returns the burst's launch counts."""
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import ServingEngine, ServingServer

    gc.collect()
    release()
    cfg = model.cfg
    burst, shared = llama_workload(cfg.vocab_size)
    new = 64
    before = trace_counts()
    t0 = time.perf_counter()
    with autocast(BF16_FULL):
        eng = ServingEngine(model, slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
                            prefill_chunk=LLAMA_CHUNK,
                            block_size=LLAMA_BLOCK, cache_dtype=torch.int8,
                            seed=SEED, device=device,
                            record_first_logits=True)
    made = record_requests(eng)
    srv = ServingServer(eng, 0)
    srv.start()              # under the default policy: the loop steps
    srv.wait_ready()         # under the lanes' own
    emit(phase="llama_server_setup", config="LlamaConfig.llama_7b",
         dtype="bfloat16", cache_dtype="int8", slots=LLAMA_SLOTS,
         max_len=LLAMA_MAX_LEN, prefill_chunk=LLAMA_CHUNK,
         block_size=LLAMA_BLOCK, port=srv.port,
         lane_policy=str(eng.lanes["decode"].policy),
         lanes=capture_stats(eng), seconds=time.perf_counter() - t0)
    telemetry.reset()
    telemetry.enable(True)
    try:
        with FrameTap() as tap:
            # ---- the main path: counters zeroed just before, read after -
            reset_launch_counts()
            recs, t_burst = run_wire(srv.port, burst_jobs(burst, new))
            counts = launch_counts()
            iters = dict(eng.lane_iters)
            # ------------------------------------------------------------
        counters = stream_counters(telemetry.get_registry())
        check_captures("llama_server", eng, before)
        check_launches("llama_server_launches", counts, iters,
                       cfg.num_layers, paged="paged_attention_int8")
        finals = check_wire("llama_server", recs, made)
        tap.check("llama_server", finals)
        check(counters["poll_fallbacks"] == 0
              and counters["subscriber_drops"] == 0,
              f"llama_server: a stream fell back to polling: {counters}")
        gen_tokens = sum(len(r["doc"]["tokens"]) for r in recs)
        emit(phase="llama_server", card=card, burst_requests=len(recs),
             burst_generated_tokens=gen_tokens, burst_seconds=t_burst,
             burst_tokens_per_s=gen_tokens / t_burst,
             engine_burst_tokens_per_s=llama_perf["burst_tokens_per_s"],
             engine_ttft_ms_p50_in_process=llama_perf["ttft_ms_p50"],
             engine_tpot_ms_p50_in_process=llama_perf["tpot_ms_p50"],
             stream_frames=len(tap.frames), **counters,
             **wire_latency(recs))
        t1 = time.perf_counter()
        with autocast(BF16_FULL):
            sound = oracle(model, [made[r["doc"]["id"]] for r in recs],
                           new, cfg.vocab_size)
        emit(phase="llama_server_oracle", dtype="bfloat16", **sound,
             dlogit_bound=DLOGIT_BF16, tie_bound=TIE_BF16,
             seconds=time.perf_counter() - t1)
        check_held("llama_server against the bf16 oracle", sound,
                   DLOGIT_BF16, TIE_BF16)
        llama_swap(device, card, eng, srv.port, made, shared, before)
    finally:
        telemetry.enable(False)
        telemetry.reset()
        srv.stop()
    check(eng._thread is None, "llama_server: stop() left the loop thread")
    del eng, made
    gc.collect()
    release()
    return counts


def llama_swap(device, card, eng, port, made, shared, before):
    """``swap_params`` on the live server: refused on a busy engine with
    every weight's checksum kept; drained, a swap to a seed-1 init of the
    same config (bf16) flushes the cached prefix and serves
    ``SWAP_REQUESTS`` shared-prompt requests within the bf16 oracle on
    the new weights, each unlike its pre-swap tokens; the swap back
    (version 2) gives the pre-swap tokens bit for bit, each set served one
    request at a time. One capture a lane throughout."""
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.rpc import CoordinatorClient
    from hetu_tpu_torch.serving import SamplingParams

    model = eng.model
    cfg = model.cfg
    prompts = shared[:SWAP_REQUESTS]
    cli = CoordinatorClient(port, timeout=WIRE_TIMEOUT_S)
    t0 = time.perf_counter()
    try:
        def one_at_a_time():
            return [cli.serving_generate(p, max_tokens=SWAP_NEW)
                    for p in prompts]

        first = one_at_a_time()
        held_w = {n: p.detach().clone() for n, p in model.named_parameters()}
        other = LlamaLMHeadModel(cfg, device=device, dtype=torch.bfloat16,
                                 seed=SEED + 1)
        new_w = {n: p.detach() for n, p in other.named_parameters()}
        del other
        sums = weight_sums(model)
        busy = eng.submit(prompts[0], SamplingParams(max_tokens=64))
        refused = None
        try:
            eng.swap_params(new_w)
        except RuntimeError as err:
            refused = str(err)
        check(refused is not None and "drain" in refused,
              "llama_server_swap: a swap on a busy engine was not refused")
        check(weight_sums(model) == sums,
              "llama_server_swap: the refused swap changed a weight")
        check(eng.result(busy, timeout=WIRE_TIMEOUT_S) is not None,
              "llama_server_swap: the busy request did not finish")
        deadline = time.monotonic() + WIRE_TIMEOUT_S
        while eng.has_work():
            check(time.monotonic() < deadline,
                  "llama_server_swap: the engine did not drain")
            time.sleep(0.01)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        info = eng.swap_params(new_w)
        torch.cuda.synchronize()
        swap_ms = (time.perf_counter() - ts) * 1e3
        check(info["version"] == 1 and info["flushed_blocks"] >= 1,
              f"llama_server_swap: swap returned {info}")
        swapped, _ = run_wire(port, [("submit", prompts, SWAP_NEW)])
        with autocast(BF16_FULL):
            reading = oracle(model, [made[r["doc"]["id"]] for r in swapped],
                             SWAP_NEW, cfg.vocab_size)
        check_held("llama_server_swap: the swapped weights against the "
                   "bf16 oracle", reading, DLOGIT_BF16, TIE_BF16)
        check(all(r["doc"]["weight_version"] == 1 for r in swapped),
              "llama_server_swap: a request ran under another version")
        differ = sum(r["doc"]["tokens"] != f["tokens"]
                     for r, f in zip(swapped, first))
        check(differ == len(prompts), f"llama_server_swap: only {differ} "
              f"of {len(prompts)} requests changed with the weights")
        back = eng.swap_params(held_w)
        again = one_at_a_time()
        same = [a["tokens"] == f["tokens"] for a, f in zip(again, first)]
        check(all(same), f"llama_server_swap: after the swap back the "
                         f"tokens differ ({same})")
        check(back["version"] == 2 and all(
            a["weight_version"] == 2 for a in again),
              f"llama_server_swap: swap back returned {back}")
        check_captures("llama_server_after_swaps", eng, before)
    finally:
        cli.close()
    emit(phase="llama_server_swap", card=card, swap_ms=swap_ms,
         flushed_blocks=info["flushed_blocks"],
         swap_back_flushed_blocks=back["flushed_blocks"],
         weight_bytes=sum(t.numel() * t.element_size()
                          for t in held_w.values()),
         refused_busy=refused, requests=len(prompts), new_tokens=SWAP_NEW,
         swapped_oracle=reading, swapped_differ=differ,
         swap_back_bit_equal=len(same),
         seconds=time.perf_counter() - t0)
    del held_w, new_w


# ---- W8A8 quantized decode (Llama-7B and GPT-MoE, int8 arena) ----------

#: the int8 FFN products timed alone: Llama-7B's (in, out), at the decode
#: lane's rows (16 slots) and the K = 4 verify lane's (16 x 5)
W8A8_GEMM_SHAPES = ((4096, 11008), (11008, 4096))
W8A8_GEMM_ROWS = (16, 80)
#: each W8A8 product's largest error over the bf16 product's largest
#: value (``hetu_tpu``'s ``tests/test_kernel_plane.py`` bound)
W8A8_REL_ERR = 0.05
#: the W8A8 engine's largest shortfall against the dense oracle under the
#: same W8A8 decode (bf16, Llama-7B). W8A8's quantize is discontinuous:
#: an input that two implementations round differently in its last bf16
#: bit can flip an activation code, and 32 random-weight layers amplify
#: it, so two implementations of one W8A8 decode lie further apart than
#: two bf16 ones (``oracle_self_noise`` prints both). The first token
#: comes from the bf16 prefill lane and keeps DLOGIT_BF16. This script
#: read, on an NVIDIA H100 80GB HBM3 at 700 W: sound 1.419 (64 requests;
#: the bf16 engine 0.438 against its bf16 oracle), 0.881 and 0.919
#: (swap, spec); a stale tree after a swap 8.75
TIE_W8A8 = 3.0
#: the MoE W8A8 cell: ``moe_engine``'s settings from the int8 arena, 12
#: burst requests and 4 sharing the system prompt, 32 new tokens each
MOE_W8A8 = (12, 4, 32)
#: fp32 bounds of the MoE W8A8 engine against the teacher-forced W8A8
#: decode at the steps ``moe_w8a8_oracle`` compares: first-token |dlogit|
#: (the fp32 prefill lane over the int8 arena) at most, and the share of
#: steps whose token is the oracle's best at least. Under W8A8 a code
#: that flips on fp32 noise moves the gate's input far past fp32 noise,
#: so rows route apart beyond the near-tie margin and the shortfall
#: (logit gaps of about 1 on random weights) cannot tell a fault from
#: noise. This script read, on an NVIDIA H100 80GB HBM3 at 700 W: sound
#: 0.0229 and 0.910 (largest shortfall 0.934); one layer's ``wo`` codes
#: rolled by one expert 0.188 (shortfall 1.313); one layer's ``wo``
#: scales rolled by a channel 0.816, which no bound here separates from
#: noise (the CPU tests hold the lane to ``hetu_tpu``'s bit for bit)
DLOGIT_MOE_W8A8, AGREE_MOE_W8A8 = 0.05, 0.7


def phase_w8a8_gemm(device, timer, card):
    """One FFN product at Llama-7B's shapes four ways: bf16 ``F.linear``
    (the fp lane's), W8A16 (``int8_matmul``: the weight dequantized per
    call), W8A8 with the weight quantized per call (``int8_w8a8_matmul``)
    and pre-quantized (``int8_w8a8_matmul_prequant``: the W8A8 lane's),
    and the int32 contraction alone (``int8_mm``, 16 rows padded to 24);
    each timed by CUDA events after an L2 flush, beside the bound of the
    int8 weight's bytes at 3.35 TB/s (and the bf16 weight's), with each
    output's largest error over the bf16 product's largest value
    (``max_rel_err``, under ``W8A8_REL_ERR``). The two W8A8 functions
    must agree bit for bit."""
    import torch.nn.functional as F
    from hetu_tpu_torch.ops import quantization as qz
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    for k, n in W8A8_GEMM_SHAPES:
        w = torch.randn(n, k, generator=gen, device=device,
                        dtype=torch.bfloat16) * 0.02
        wq, ws = qz.quantize_int8(w, axis=-1)
        for m in W8A8_GEMM_ROWS:
            x = torch.randn(m, k, generator=gen, device=device,
                            dtype=torch.bfloat16)
            xq = qz.quantize_int8(x)[0]
            fns = {"bf16": lambda: F.linear(x, w),
                   "w8a16": lambda: qz.int8_matmul(x, wq.t(), ws.t()),
                   "w8a8": lambda: qz.int8_w8a8_matmul(x, w.t()),
                   "w8a8_prequant": lambda: qz.int8_w8a8_matmul_prequant(
                       x, wq.t(), ws)}
            outs = {name: fn() for name, fn in fns.items()}
            ref = outs["bf16"].float()
            top = float(ref.abs().max())
            err = {name: float((o.float() - ref).abs().max()) / top
                   for name, o in outs.items() if name != "bf16"}
            same = bool(torch.equal(outs["w8a8"], outs["w8a8_prequant"]))
            ms = {f"{name}_ms": timer(fn) for name, fn in fns.items()}
            ms["int8_mm_ms"] = timer(lambda: qz.int8_mm(xq, wq.t()))
            emit(phase="w8a8_gemm", card=card, shape=[m, k, n], **ms,
                 bound_ms=n * k / HBM_BYTES_PER_S * 1e3,
                 bound_by="bytes (the int8 weight)",
                 bf16_bound_ms=2 * n * k / HBM_BYTES_PER_S * 1e3,
                 max_rel_err=err["w8a8"],
                 prequant_max_rel_err=err["w8a8_prequant"],
                 w8a16_max_rel_err=err["w8a16"], w8a8_bit_equal=same)
            check(all(e < W8A8_REL_ERR for e in err.values()),
                  f"w8a8_gemm {[m, k, n]}: relative errors {err}")
            check(same, f"w8a8_gemm {[m, k, n]}: the per-call and the "
                        f"pre-quantized W8A8 products differ")
        del w, wq, ws
    gc.collect()
    release()


def w8a8_trees(model) -> list:
    """One ``prequantize`` tree a layer of ``model``'s current weights:
    the oracles' own, never the engine's."""
    return [blk.mlp.prequantize() for blk in model.blocks]


def tree_bytes(trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               for leaf in tree.values() for t in leaf.values())


def tree_sums(trees) -> list:
    return [checksum(t) for tree in trees for leaf in tree.values()
            for t in leaf.values()]


def int8_gemm_kernels(device, shapes) -> set:
    """The names of the kernels ``torch._int_mm`` launches at each (rows,
    in, out) of ``shapes`` (one layer's products as the lane runs them,
    rows padded as ``int8_mm`` pads them), from the profiler over a few
    calls of each: the int8 GEMM's own kernels. A window of a few short
    launches often records no kernel at all (the first window did in
    every run of the script; once all three of 5 calls each did), so
    each window makes 20 calls of each product, and an empty one is
    profiled again, up to six in all."""
    from torch.profiler import ProfilerActivity, profile
    ops = [(torch.zeros(m, k, dtype=torch.int8, device=device),
            torch.zeros(n, k, dtype=torch.int8, device=device).t())
           for m, k, n in shapes]
    for a, b in ops:
        torch._int_mm(a, b)
    torch.cuda.synchronize()
    windows = 6
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                for a, b in ops:
                    torch._int_mm(a, b)
            torch.cuda.synchronize()
        counts: dict = {}
        device_kernel_ms(prof, counts)
        if counts:
            return set(counts)
        emit(phase="profile_retry", of="int8_gemm_kernels",
             window=window + 1, windows=windows)
    check(False, "the profiler recorded no int8 GEMM kernel")
    return set()


def replay_int8_gemms(phase, eng, names: set, launches: int,
                      replays: int = 3) -> dict:
    """Profile ``replays`` replays of ``eng``'s decode lane: kernels named
    in ``names`` (``int8_gemm_kernels``) must launch ``launches`` times a
    replay, one a product (a lane whose FFN ran in the compute dtype
    shows none). Returns those launches and their device ms a replay,
    and the replay's busy device ms."""
    from torch.profiler import ProfilerActivity, profile
    lane = eng.lanes["decode"]
    lane.replay()
    torch.cuda.synchronize()
    for window in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(replays):
                lane.replay()
            torch.cuda.synchronize()
        counts: dict = {}
        by_name = device_kernel_ms(prof, counts)[0]
        if any(name in counts for name in names):
            break
        emit(phase="profile_retry", of=phase, window=window + 1, windows=3)
    seen = sum(counts.get(name, 0) for name in names) / replays
    check(seen == launches, f"{phase}: {seen} int8 GEMM launches a replay, "
          f"expected {launches}: the W8A8 lane did not run as built")
    return dict(int8_gemm_launches_per_replay=seen,
                int8_gemm_expected=launches,
                int8_gemm_ms_per_replay=sum(by_name.get(n, 0.0)
                                            for n in names) / replays,
                int8_gemm_kernels=sorted(n[:90] for n in names),
                device_busy_ms_per_replay=sum(by_name.values()) / replays)


def oracle_self_noise(model, reqs, new, trees) -> dict:
    """How far two runs of one dense oracle lie apart when only their
    chunking differs (``reqs`` in one batch, the prompt in 256- and in
    128-token chunks), in bf16 and under the W8A8 decode, on ``reqs``'
    own tokens: the first-token |dlogit| and the shortfall of one run's
    best token under the other. W8A8's quantize is
    discontinuous, so a last-bit difference before it can flip a code."""
    out = {}
    prompts = [r.prompt.tolist() for r in reqs]
    tokens = [list(r.tokens) for r in reqs]
    for name, w8a8 in (("bf16", None), ("w8a8", trees)):
        dlogit = short = 0.0
        runs = [forced_logits_rows(model, prompts, tokens, torch.int8,
                                   chunk=chunk, w8a8=w8a8)
                for chunk in (LLAMA_CHUNK, 128)]
        for a, b in zip(*runs):
            dlogit = max(dlogit, max_err(a[0], b[0]))
            best = a.argmax(-1, keepdim=True)
            short = max(short, float((b.max(-1).values
                                      - b.gather(1, best)[:, 0]).max()))
        out[name] = dict(first_token_max_abs_dlogit=dlogit,
                         max_shortfall=short)
    return dict(requests=len(reqs), **out)


def phase_llama_w8a8(device, card, model, llama_perf):
    """Llama-7B (bf16, int8 arena) at ``llama_engine``'s settings with
    ``w8a8="on"``: every layer's decode-lane FFN contracts int8
    activations with int8 weights (``_int_mm``), against a tree quantized
    once at construction; the prefill lane stays bf16. The 64-request
    workload (counters zeroed just before, read just after: #1 and #2 as
    in ``llama_engine``), one capture a lane, every request within
    ``DLOGIT_BF16`` and ``TIE_W8A8`` of the dense oracle teacher-forced
    on its tokens under the same W8A8 decode (``forced_logits(w8a8=)``,
    its own tree); the shared batch read against the bf16 oracle too,
    with no bound (how far W8A8 moves the logits), and the oracle's own
    noise (``oracle_self_noise``). TPOT, tokens/s and one decode replay's
    device ms beside ``llama_engine``'s; the int8 GEMM kernels in a
    replay's profile; the tree's bytes. Then ``llama_w8a8_swap``.
    Returns the main path's launch counts."""
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.ops.quantization import INT_MM_MIN_ROWS
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    gc.collect()
    release()
    cfg = model.cfg
    L, vocab = cfg.num_layers, cfg.vocab_size
    burst, shared = llama_workload(vocab)
    new = 64
    sp = SamplingParams(max_tokens=new)
    t0 = time.perf_counter()
    with autocast(BF16_FULL):
        before = trace_counts()
        base = torch.cuda.memory_allocated()
        eng = ServingEngine(model, slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
                            prefill_chunk=LLAMA_CHUNK,
                            block_size=LLAMA_BLOCK, cache_dtype=torch.int8,
                            seed=SEED, device=device,
                            record_first_logits=True, w8a8="on")
        tree = tree_bytes(eng._w8a8_wq)
        emit(phase="llama_w8a8_setup", config="LlamaConfig.llama_7b",
             dtype="bfloat16", cache_dtype="int8", w8a8="on",
             w8a8_layers=sum(eng._w8a8_mask), tree_bytes=tree,
             arena_bytes=eng.pool.nbytes(),
             engine_allocated_bytes=torch.cuda.memory_allocated() - base,
             allocated_bytes=torch.cuda.memory_allocated(),
             lanes=capture_stats(eng), seconds=time.perf_counter() - t0)
        check(eng._w8a8_mask == (True,) * L,
              f"llama_w8a8: mask {eng._w8a8_mask}")
        check_captures("llama_w8a8_setup", eng, before)

        # ---- the main path: counters zeroed just before, read after ----
        reset_launch_counts()
        run = serve(eng, burst, shared, sp)
        counts = launch_counts()
        iters = dict(eng.lane_iters)
        # ---------------------------------------------------------------
    check_captures("llama_w8a8", eng, before)
    check_launches("llama_w8a8_launches", counts, iters, L,
                   paged="paged_attention_int8")
    reqs, reqs2 = run["reqs"], run["reqs2"]
    bad = [r for r in reqs + reqs2 if r.status != "done"]
    check(not bad, f"llama_w8a8: {len(bad)} requests did not finish")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    timings = [r.timing() for r in reqs]
    tpot = [t["decode_ms"] / (len(r.tokens) - 1)
            for t, r in zip(timings, reqs) if len(r.tokens) > 1]
    perf = dict(burst_tokens_per_s=gen_tokens / run["t_burst"],
                burst_ms_per_step=run["t_burst"] / run["steps"] * 1e3,
                ttft_ms_p50=percentile([t["ttft_ms"] for t in timings], 50),
                tpot_ms_p50=percentile(tpot, 50),
                tpot_ms_p99=percentile(tpot, 99),
                shared_tokens_per_s=sum(len(r.tokens) for r in reqs2)
                / run["t_shared"])
    emit(phase="llama_w8a8", card=card, burst_requests=len(reqs),
         burst_generated_tokens=gen_tokens, burst_seconds=run["t_burst"],
         burst_steps=run["steps"], burst_lane_iterations=run["it_burst"],
         **perf, bf16={k: llama_perf[k] for k in perf},
         peak_memory_bytes=torch.cuda.max_memory_allocated())

    t1 = time.perf_counter()
    trees = w8a8_trees(model)
    with autocast(BF16_FULL):
        sound = oracle(model, reqs + reqs2, new, vocab, w8a8=trees)
        fp = oracle(model, reqs2, new, vocab)
        noise = oracle_self_noise(model, reqs2[:8], new, trees)
    del trees
    emit(phase="llama_w8a8_oracle", dtype="bfloat16", **sound,
         dlogit_bound=DLOGIT_BF16, tie_bound=TIE_W8A8, against_bf16_oracle=fp,
         oracle_self_noise=noise, seconds=time.perf_counter() - t1)
    check_held("llama_w8a8 against the W8A8 oracle", sound, DLOGIT_BF16,
               TIE_W8A8)

    with autocast(BF16_FULL):
        phase_profile(eng, burst[:LLAMA_SLOTS], SamplingParams(max_tokens=96),
                      phase="llama_w8a8_decode_profile",
                      classes=LLAMA_CLASSES, steady_decode=True)
        split = phase_step_split(eng, burst[:LLAMA_SLOTS],
                                 SamplingParams(max_tokens=48),
                                 "llama_w8a8_step_split")
        rows = max(LLAMA_SLOTS, INT_MM_MIN_ROWS)
        names = int8_gemm_kernels(device, (
            (rows, cfg.hidden_size, cfg.intermediate_size),
            (rows, cfg.intermediate_size, cfg.hidden_size)))
        seen = replay_int8_gemms("llama_w8a8_profile", eng, names, 3 * L)
    emit(phase="llama_w8a8_profile", card=card,
         replay_device_ms_median=split["replay_device_ms_median"],
         bf16_replay_device_ms_median=llama_perf["replay_device_ms_median"],
         **seen)
    llama_w8a8_swap(card, eng, before)
    del eng
    gc.collect()
    release()
    return counts


def llama_w8a8_swap(card, eng, before):
    """``swap_params`` on the W8A8 engine: 8 fresh shared-prompt requests
    (16 new tokens) served before; a swap to a seed-1 init with the tree's
    re-quantize skipped (the stale tree ``hetu_tpu``'s regression test
    guards against) must fail the W8A8 oracle of the new weights; the swap
    with the re-quantize (timed) writes the new codes into the same
    tensors, and serves within that oracle, every request's tokens
    changed; the swap back (timed) restores the tree bit for bit and the
    first tokens bit for bit. One capture a lane throughout."""
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.nn.parallel import ParallelMLP
    from hetu_tpu_torch.serving import SamplingParams

    model = eng.model
    cfg = model.cfg
    prompts = llama_workload(cfg.vocab_size, seed=SEED + 13)[1][
        :SWAP_REQUESTS]
    sp = SamplingParams(max_tokens=SWAP_NEW)
    t0 = time.perf_counter()
    ptrs = [(leaf["q"].data_ptr(), leaf["scale"].data_ptr())
            for tree in eng._w8a8_wq for leaf in tree.values()]
    sums = tree_sums(eng._w8a8_wq)

    def served():
        with autocast(BF16_FULL):
            reqs = [eng.submit(p, sp) for p in prompts]
            eng.run_until_drained()
        check(all(r.status == "done" for r in reqs),
              "llama_w8a8_swap: requests unfinished")
        return reqs

    def reading(reqs):
        trees = w8a8_trees(model)
        with autocast(BF16_FULL):
            got = oracle(model, reqs, SWAP_NEW, cfg.vocab_size, w8a8=trees)
        del trees
        return got

    def swap(params):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        info = eng.swap_params(params)
        torch.cuda.synchronize()
        return info, (time.perf_counter() - ts) * 1e3

    first = [list(r.tokens) for r in served()]
    held_w = {n: p.detach().clone() for n, p in model.named_parameters()}
    other = LlamaLMHeadModel(cfg, device=model.device, dtype=torch.bfloat16,
                             seed=SEED + 1)
    new_w = {n: p.detach() for n, p in other.named_parameters()}
    del other
    real = ParallelMLP.prequantize
    ParallelMLP.prequantize = lambda self, into=None: into   # stale tree
    try:
        swap(new_w)
    finally:
        ParallelMLP.prequantize = real
    stale = reading(served())
    caught = not held(stale, DLOGIT_BF16, TIE_W8A8)
    emit(phase="llama_w8a8_swap_fault", fault="tree_not_requantized",
         **stale, dlogit_bound=DLOGIT_BF16, tie_bound=TIE_W8A8,
         caught=caught)
    check(caught, "llama_w8a8_swap: the W8A8 oracle passes a stale tree")
    info, swap_ms = swap(new_w)
    same_ptrs = ptrs == [(leaf["q"].data_ptr(), leaf["scale"].data_ptr())
                         for tree in eng._w8a8_wq for leaf in tree.values()]
    fresh = w8a8_trees(model)
    requantized = all(torch.equal(a[k][m], b[k][m])
                      for a, b in zip(eng._w8a8_wq, fresh)
                      for k in a for m in ("q", "scale"))
    del fresh
    check(same_ptrs and requantized, f"llama_w8a8_swap: the tree was not "
          f"re-quantized in place (same tensors {same_ptrs}, codes of the "
          f"new weights {requantized})")
    swapped = served()
    sound = reading(swapped)
    check_held("llama_w8a8_swap: the swapped weights against the W8A8 "
               "oracle", sound, DLOGIT_BF16, TIE_W8A8)
    differ = sum(list(r.tokens) != f for r, f in zip(swapped, first))
    check(differ == len(prompts), f"llama_w8a8_swap: only {differ} of "
          f"{len(prompts)} requests changed with the weights")
    back, back_ms = swap(held_w)
    again = [list(r.tokens) for r in served()]
    tree_back = tree_sums(eng._w8a8_wq) == sums
    check(tree_back and again == first, f"llama_w8a8_swap: after the swap "
          f"back the tree (restored {tree_back}) or the tokens differ")
    check_captures("llama_w8a8_after_swaps", eng, before)
    emit(phase="llama_w8a8_swap", card=card, swap_ms=swap_ms,
         swap_back_ms=back_ms, versions=[info["version"], back["version"]],
         tree_bytes=tree_bytes(eng._w8a8_wq), requests=len(prompts),
         new_tokens=SWAP_NEW, swapped_oracle=sound, swapped_differ=differ,
         swap_back_bit_equal=again == first, tree_bit_equal=tree_back,
         seconds=time.perf_counter() - t0)
    del held_w, new_w


def phase_llama_w8a8_spec(device, card, model):
    """``llama_w8a8``'s engine with ``spec_depth=4`` (the n-gram
    draftsman; the verify lane's 80 rows through the int8 products) on
    ``spec_prompts`` at 64 new tokens: one capture a lane, #1 and #2 as in
    ``llama_engine`` (counters zeroed just before, read just after), every
    request within ``llama_w8a8``'s bounds of the W8A8 oracle; tokens a
    slot-step, TPOT and tokens/s. Returns the launch counts."""
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    cfg = model.cfg
    new = 64
    t0 = time.perf_counter()
    with autocast(BF16_FULL):
        before = trace_counts()
        eng = ServingEngine(model, slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
                            prefill_chunk=LLAMA_CHUNK,
                            block_size=LLAMA_BLOCK, cache_dtype=torch.int8,
                            seed=SEED, device=device,
                            record_first_logits=True, w8a8="on",
                            spec_depth=SPEC_DEPTH)
        stats0 = dict(eng.spec_stats)
        # ---- the main path: counters zeroed just before, read after ----
        reset_launch_counts()
        reqs, steps, wall = serve_stepped(eng, spec_prompts(cfg.vocab_size),
                                          SamplingParams(max_tokens=new))
        counts = launch_counts()
        iters = dict(eng.lane_iters)
        # ---------------------------------------------------------------
    check_captures("llama_w8a8_spec", eng, before)
    check_launches("llama_w8a8_spec_launches", counts, iters,
                   cfg.num_layers, paged="paged_attention_int8")
    spec = spec_reading(eng, reqs, steps, wall, stats0)
    trees = w8a8_trees(model)
    with autocast(BF16_FULL):
        sound = oracle(model, reqs, new, cfg.vocab_size, w8a8=trees)
    del trees
    emit(phase="llama_w8a8_spec", card=card, spec_depth=SPEC_DEPTH,
         requests=len(reqs), **spec, oracle=sound,
         dlogit_bound=DLOGIT_BF16, tie_bound=TIE_W8A8,
         phase_seconds=time.perf_counter() - t0)
    check_held("llama_w8a8_spec against the W8A8 oracle", sound,
               DLOGIT_BF16, TIE_W8A8)
    del eng
    gc.collect()
    release()
    return counts


def moe_w8a8_oracle(model, reqs, new, trees):
    """Each request of the MoE W8A8 engine against the dense int8 oracle
    teacher-forced on its tokens under the same W8A8 decode, routing
    first: the oracle's gates record each row's routing margin
    (``RoutingSpy``), and a step whose row (the position its logits come
    from) some layer routed within ``NEAR_TIE`` of a tie is not compared
    (the engine may have routed it the other way), as ``moe_engine``
    compares no row its two runs routed differently. Returns ``oracle``'s
    figures over the steps compared (``agree_share``: the share whose
    token is the oracle's best), the steps left out, and the largest
    shortfall over every step (``max_shortfall_all``)."""
    vocab, L = model.cfg.vocab_size, model.cfg.num_layers
    dlogit = worst = worst_all = 0.0
    where, agree, skipped = None, 0, 0
    for r in reqs:
        prompt, got = r.prompt.tolist(), list(r.tokens)
        check(len(got) == new and all(0 <= t < vocab for t in got),
              f"MoE request {r.id}: bad token list")
        spy = RoutingSpy(model, margins=True)
        logits = forced_logits(model, prompt, got, torch.int8,
                               chunk=MOE_CHUNK, w8a8=trees)
        calls = spy.close()
        check(bool(torch.isfinite(logits).all()),
              f"MoE request {r.id}: non-finite oracle logits")
        # each chunk calls every layer's gate once, in order; step j's
        # logits come from position len(prompt) - 1 + j
        margins = torch.stack([torch.cat([m for _, m in calls[layer::L]])
                               for layer in range(L)]).min(0).values
        near = margins[len(prompt) - 1:] < NEAR_TIE              # (new,)
        skipped += int(near.sum())
        idx = torch.tensor(got, device=logits.device)[:, None]
        short = (logits.max(dim=-1).values
                 - logits.gather(1, idx)[:, 0]).cpu()
        worst_all = max(worst_all, float(short.max()))
        if not near[0]:
            dlogit = max(dlogit, max_err(r.first_logits, logits[0]))
        agree += int(((short == 0) & ~near).sum())
        short = torch.where(near, torch.zeros_like(short), short)
        step = int(short.argmax())
        if float(short[step]) > worst:
            worst, where = float(short[step]), dict(request=r.id, step=step)
    return dict(requests=len(reqs),
                agree_share=agree / max(new * len(reqs) - skipped, 1),
                first_token_max_abs_dlogit=dlogit, max_shortfall=worst,
                max_shortfall_at=where, steps_not_compared=skipped,
                max_shortfall_all=worst_all)


def moe_w8a8_held(reading) -> bool:
    return (reading["first_token_max_abs_dlogit"] <= DLOGIT_MOE_W8A8
            and reading["agree_share"] >= AGREE_MOE_W8A8)


def phase_moe_w8a8(device, card):
    """``GPTConfig.moe_8e`` (fp32, random weights from a seed) at
    ``moe_engine``'s settings from the int8 arena with ``w8a8="on"``:
    each expert projection one int32 product over all 8 experts
    (``MoEMLP._q_lane``). ``MOE_W8A8``'s requests, one capture a lane,
    #1 and #2 as in ``moe_engine`` (counters zeroed just before, read
    just after), held to the teacher-forced W8A8 decode
    (``moe_w8a8_oracle``, ``moe_w8a8_held``); a planted fault (one layer's
    ``wo`` codes rolled by one expert) must fail the same bounds.
    Returns the launch counts."""
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.ops.quantization import INT_MM_MIN_ROWS
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine

    cfg = moe_cfg()
    t0 = time.perf_counter()
    model = moe_model(cfg, device, SEED).eval()
    n_burst, n_shared, new = MOE_W8A8
    burst, shared = workload(cfg.vocab_size)
    sp = SamplingParams(max_tokens=new)
    kw = dict(slots=16, max_len=512, prefill_chunk=64, block_size=16,
              cache_dtype=torch.int8, seed=SEED, device=device,
              record_first_logits=True, w8a8="on")
    before = trace_counts()
    eng = ServingEngine(model, **kw)
    emit(phase="moe_w8a8_setup", config="GPTConfig.moe_8e", dtype="float32",
         cache_dtype="int8", w8a8="on", layers=cfg.num_layers,
         experts=cfg.num_experts, tree_bytes=tree_bytes(eng._w8a8_wq),
         lanes=capture_stats(eng), seconds=time.perf_counter() - t0)
    check_captures("moe_w8a8_setup", eng, before)
    # ---- the main path: counters zeroed just before, read just after --
    reset_launch_counts()
    run = serve(eng, burst[:n_burst], shared[:n_shared], sp)
    counts = launch_counts()
    iters = dict(eng.lane_iters)
    # ------------------------------------------------------------------
    check_captures("moe_w8a8", eng, before)
    check_launches("moe_w8a8_launches", counts, iters, cfg.num_layers,
                   paged="paged_attention_int8")
    reqs = run["reqs"] + run["reqs2"]
    check(all(r.status == "done" for r in reqs),
          "moe_w8a8: requests unfinished")
    gen_tokens = sum(len(r.tokens) for r in run["reqs"])
    hidden, T = cfg.mlp_ratio * cfg.hidden_size, kw["slots"]
    names = int8_gemm_kernels(device, (
        (max(T, INT_MM_MIN_ROWS), cfg.hidden_size,
         cfg.num_experts * hidden),
        (max(T * cfg.moe_top_k, INT_MM_MIN_ROWS), hidden,
         cfg.num_experts * cfg.hidden_size)))
    seen = replay_int8_gemms("moe_w8a8_profile", eng, names,
                             2 * cfg.num_layers)
    emit(phase="moe_w8a8", card=card, burst_requests=n_burst,
         burst_generated_tokens=gen_tokens, burst_seconds=run["t_burst"],
         burst_tokens_per_s=gen_tokens / run["t_burst"],
         burst_steps=run["steps"], **seen)
    t1 = time.perf_counter()
    trees = w8a8_trees(model)
    sound = moe_w8a8_oracle(model, reqs, new, trees)
    bounds = dict(dlogit_bound=DLOGIT_MOE_W8A8, agree_bound=AGREE_MOE_W8A8)
    emit(phase="moe_w8a8_oracle", **sound, **bounds,
         seconds=time.perf_counter() - t1)
    check(moe_w8a8_held(sound), f"moe_w8a8 against the W8A8 oracle: "
          f"{sound} ({bounds})")
    # the fault: one layer's down-projection codes rolled by one expert
    # (each row reads the next expert's int8 weights there)
    t1 = time.perf_counter()
    codes = eng._w8a8_wq[cfg.num_layers // 2]["wo"]["q"]
    good = codes.clone()
    codes.copy_(good.roll(1, 0))
    try:
        fresh = workload(cfg.vocab_size, seed=SEED + 7)[0][:8]
        freqs = [eng.submit(p, sp) for p in fresh]
        eng.run_until_drained()
    finally:
        codes.copy_(good)
    fault = moe_w8a8_oracle(model, freqs, new, trees)
    del trees
    caught = not moe_w8a8_held(fault)
    emit(phase="moe_w8a8_oracle_fault", fault="wo_experts_rolled", **fault,
         **bounds, caught=caught, seconds=time.perf_counter() - t1)
    check(caught, "the MoE W8A8 oracle passes a planted fault")
    check_captures("moe_w8a8_after_fault", eng, before)
    # one decode replay on the device against the same engine with W8A8
    # off, each after the same steady-decode window
    steady = [p for p in workload(cfg.vocab_size, seed=SEED + 3)[0]
              if len(p) <= 512 - 48][:16]
    split = phase_step_split(eng, steady, SamplingParams(max_tokens=48),
                             "moe_w8a8_step_split")
    del eng
    off = ServingEngine(model, **dict(kw, w8a8="off"))
    split_off = phase_step_split(off, steady, SamplingParams(max_tokens=48),
                                 "moe_int8_step_split")
    emit(phase="moe_w8a8_replay", card=card,
         replay_device_ms_median=split["replay_device_ms_median"],
         w8a8_off_replay_device_ms_median=split_off[
             "replay_device_ms_median"])
    del off, model
    gc.collect()
    release()
    return counts


# -- telemetry and observability on the served and trained paths -------------

#: gpt2_telemetry's watchdog floor (``watchdog_min_timeout_s``) and the
#: planted stall that holds the engine's iteration lock past it
WATCHDOG_FLOOR_S = 1.0
STALL_S = 3.0
#: llama_telemetry: a healthy wave, then a wave held this long before its
#: admission (past the default rules' 1 s TTFT objective)
TTFT_WAVES = (8, 16)
TTFT_DELAY_S = 1.5


def series(snap: dict, metric: str, **labels) -> float:
    """One series of a registry snapshot (0 when absent; a histogram
    gives its count)."""
    key = metric
    if labels:
        key += "{" + ",".join(f'{k}="{v}"' for k, v in
                              sorted(labels.items())) + "}"
    v = snap.get(key, 0.0)
    return v["count"] if isinstance(v, dict) else v


def telemetry_off() -> None:
    """Telemetry off and its records dropped (the next phase starts
    clean)."""
    from hetu_tpu_torch import telemetry
    telemetry.enable(False)
    telemetry.reset()


def request_tracks(trace_path: str) -> int:
    """Request tracks in an exported ``trace.json`` (``req <trace_id>``
    thread names), after the port's ``trace_summary`` parsed it."""
    from hetu_tpu_torch.tools import trace_summary
    check(bool(trace_summary.load_records(trace_path)),
          f"trace_summary read no record from {trace_path}")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("ph") == "M"
               and e.get("name") == "thread_name"
               and str(e.get("args", {}).get("name", "")).startswith("req "))


def check_serving_series(phase, snap, reqs, iters) -> dict:
    """The engine's series against what the run did: requests, tokens,
    TTFT and TPOT counts, the kernel-path counters against the lanes'
    replays, the prefix hit and miss tokens against the requests' own
    cached tokens, and the drained gauges."""
    gen = sum(len(r.tokens) for r in reqs)
    hit = sum(r.cached_tokens for r in reqs)
    miss = sum(len(r.prompt) - r.cached_tokens for r in reqs)
    got = dict(
        submitted=series(snap, "serving_requests_total",
                         outcome="submitted"),
        completed=series(snap, "serving_requests_total",
                         outcome="completed"),
        generated_tokens=series(snap, "serving_tokens_total",
                                kind="generated"),
        prompt_tokens=series(snap, "serving_tokens_total", kind="prompt"),
        ttft=series(snap, "serving_ttft_seconds"),
        tpot=series(snap, "serving_tpot_seconds"),
        paged=series(snap, "serving_attn_kernel_total", path="paged"),
        flash=series(snap, "prefill_attn_kernel_total", path="flash"),
        prefix_hit=series(snap, "serving_prefix_hit_tokens_total"),
        prefix_miss=series(snap, "serving_prefix_miss_tokens_total"),
        queue_depth=series(snap, "serving_queue_depth"),
        occupancy=series(snap, "serving_slot_occupancy"))
    want = dict(submitted=len(reqs), completed=len(reqs),
                generated_tokens=gen, prompt_tokens=miss, ttft=len(reqs),
                tpot=sum(len(r.tokens) > 1 for r in reqs),
                paged=iters["decode"], flash=iters["prefill"],
                prefix_hit=hit, prefix_miss=miss, queue_depth=0,
                occupancy=0.0)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    emit(phase=phase + "_series", series=got, expected=want, ok=not bad)
    check(not bad, f"{phase}: series against the run: {bad}")
    return got


def phase_gpt2_telemetry(device, card, gpt2, engine_counts):
    """``engine``'s GPT-2 small engine and its 48 + 16 prompts, served
    with telemetry off, then on with ``slo=True`` and the watchdog
    (``watchdog_min_timeout_s`` 1 s): every token and every first-token
    logit bit-equal, one capture a lane each, #1/#2 launches as in
    ``engine``; the series against the run (``check_serving_series``);
    ``export_dir``'s ``trace.json`` parsed by the port's
    ``trace_summary`` with one request track a request. Then behind
    ``ServingServer``: HEALTHZ ``ok``, METRICS parsed as Prometheus
    text, DUMPOBS's bundle; a planted stall holds the step lock for
    ``STALL_S``: the watchdog trips once, its dump parses, HEALTHZ reads
    degraded and a later request finishes. Returns the launch counts of
    the telemetry-on run."""
    import shutil
    import tempfile
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.rpc import CoordinatorClient
    from hetu_tpu_torch.serving import (
        SamplingParams, ServingEngine, ServingServer,
    )
    from hetu_tpu_torch.tools import obs_report

    model = gpt2["model"]
    cfg = model.cfg
    burst, shared = workload(cfg.vocab_size)
    sp = SamplingParams(max_tokens=64)
    runs = {}
    t0 = time.perf_counter()
    for on in (False, True):
        telemetry.reset()
        telemetry.enable(on)
        before = trace_counts()
        eng = ServingEngine(model, slots=16, max_len=512, prefill_chunk=64,
                            block_size=16, seed=SEED, device=device,
                            record_first_logits=True,
                            slo=True if on else None, watchdog=on,
                            watchdog_min_timeout_s=WATCHDOG_FLOOR_S)
        # ---- the main path (the telemetry-on run): counters zeroed
        # just before, read just after
        reset_launch_counts()
        run = serve(eng, burst, shared, sp)
        counts = launch_counts()
        # ----------------------------------------------------------------
        tag = "gpt2_telemetry" if on else "gpt2_telemetry_off"
        check_captures(tag, eng, before)
        runs[on] = dict(eng=eng, reqs=run["reqs"] + run["reqs2"],
                        counts=counts, iters=dict(eng.lane_iters),
                        step_ms=run["t_burst"] / run["steps"] * 1e3,
                        snap=telemetry.get_registry().snapshot())
    off, on = runs[False], runs[True]
    eng = on["eng"]
    check_launches("gpt2_telemetry_launches", on["counts"], on["iters"],
                   cfg.num_layers)
    same_counts = {k: (on["counts"].get(k, 0), off["counts"].get(k, 0),
                       engine_counts.get(k, 0))
                   for k in ("paged_attention", "flash_fwd")}
    check(all(a == b == c for a, b, c in same_counts.values()),
          f"gpt2_telemetry: launches on / off / engine {same_counts}")
    tokens_equal = [r.tokens for r in on["reqs"]] \
        == [r.tokens for r in off["reqs"]]
    logits_equal = all(torch.equal(a.first_logits, b.first_logits)
                       for a, b in zip(on["reqs"], off["reqs"]))
    check(tokens_equal and logits_equal,
          f"gpt2_telemetry: telemetry changed the output (tokens equal "
          f"{tokens_equal}, first-token logits equal {logits_equal})")
    check(off["snap"] == {}, "gpt2_telemetry: the off run recorded series")
    check_serving_series("gpt2_telemetry", on["snap"], on["reqs"],
                         on["iters"])
    tmp = tempfile.mkdtemp(prefix="hetu_obs_")
    try:
        paths = telemetry.export_dir(os.path.join(tmp, "export"))
        tracks = request_tracks(paths["trace"])
        check(tracks == len(on["reqs"]),
              f"gpt2_telemetry: {tracks} request tracks for "
              f"{len(on['reqs'])} requests")
        # over the wire, the loop running, then the planted stall
        eng.watchdog.dump_dir = tmp
        eng.watchdog.poll_s = 0.1
        srv = ServingServer(eng, 0)
        srv.start()
        srv.wait_ready()
        try:
            cli = CoordinatorClient(srv.port, timeout=WIRE_TIMEOUT_S)
            health = cli.healthz()
            meta, samples = telemetry.parse_prometheus(cli.metrics_text())
            bundle = cli.dump_obs()
            t1 = time.perf_counter()
            with eng._step_lock:
                time.sleep(STALL_S)
            stalled_s = time.perf_counter() - t1
            trips = eng.watchdog.trips
            degraded = cli.healthz()
            later = cli.serving_generate(burst[1][:32], max_tokens=8)
            cli.close()
        finally:
            srv.stop()
        dumps = sorted(f for f in os.listdir(tmp)
                       if f.startswith("flight_") and f.endswith(".jsonl"))
        dump = obs_report.load_jsonl(os.path.join(tmp, dumps[0])) \
            if dumps else []
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    snap = telemetry.get_registry().snapshot()
    emit(phase="gpt2_telemetry", card=card,
         step_ms_on=on["step_ms"], step_ms_off=off["step_ms"],
         tokens_equal=tokens_equal, first_logits_equal=logits_equal,
         launches=on["counts"], request_tracks=tracks,
         healthz=health["status"], healthz_serving=health.get("serving"),
         metrics_families=len(meta), metrics_samples=len(samples),
         dumpobs_keys=sorted(bundle), dumpobs_flight_events=len(
             bundle.get("flight", [])),
         stall_s=stalled_s, watchdog_trips=trips,
         watchdog_trips_total=series(snap, "watchdog_trips_total",
                                     name="serving"),
         healthz_after_stall=degraded["status"],
         dump_reason=dump[0].get("reason") if dump else None,
         dump_records=len(dump), later_tokens=len(later["tokens"]),
         seconds=time.perf_counter() - t0)
    check(health["status"] == "ok" and health["serving"]["loop_running"],
          f"gpt2_telemetry: HEALTHZ before the stall {health}")
    check("serving_tokens_total" in meta
          and meta["serving_tokens_total"].get("type") == "counter",
          "gpt2_telemetry: METRICS did not parse as Prometheus text")
    check({"chrome", "flight", "pid"} <= set(bundle),
          f"gpt2_telemetry: DUMPOBS bundle keys {sorted(bundle)}")
    check(trips == 1 and series(snap, "watchdog_trips_total",
                                name="serving") == 1,
          f"gpt2_telemetry: the stall tripped the watchdog {trips} times")
    check(bool(dump) and dump[0].get("kind") == "flight_header"
          and str(dump[0].get("reason", "")).startswith("watchdog")
          and any(r.get("kind") == "thread_stacks" for r in dump),
          "gpt2_telemetry: the watchdog's dump did not parse")
    check(degraded["status"] == "degraded",
          f"gpt2_telemetry: HEALTHZ after the stall {degraded['status']}")
    check(len(later["tokens"]) == 8,
          "gpt2_telemetry: a request after the stall did not finish")
    counts = on["counts"]
    del runs, eng, on, off
    telemetry_off()
    gc.collect()
    return counts


def phase_llama_telemetry(device, card, model, engine_reqs):
    """The llama_engine's model and settings (32 layers, int8 arena,
    bf16) with telemetry on and ``slo=True``, in two parts. (a)
    llama_engine's workload on llama_engine's schedule (``serve``'s),
    the queue, occupancy, block and spill gauges read against the
    engine's own counts after every step: every token and first-token
    logit bit-equal to llama_engine's telemetry-off run
    (``engine_reqs``), which llama_engine's oracle read. (b) The SLO on
    fresh traffic: the default serving rules afresh (the burst's queued
    TTFTs, all past the 1 s objective, would fire them),
    ``TTFT_WAVES[0]`` fresh short prompts, then ``TTFT_WAVES[1]`` held
    ``TTFT_DELAY_S`` before admission: the TTFT burn-rate alert fires on
    the delayed wave and not before, and the health document reads
    degraded; every request of both waves within the bf16 oracle's
    bounds (``oracle`` under ``BF16_FULL``, the policy the engine serves
    under). One capture a lane; #1/#2 launches a lane replay. Returns
    the launch counts."""
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.core import BF16_FULL, autocast
    from hetu_tpu_torch.engine import trace_counts
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.serving import SamplingParams, ServingEngine
    from hetu_tpu_torch.telemetry.slo import (
        SLOEngine, default_serving_rules, health_status,
    )

    vocab = model.cfg.vocab_size
    burst, shared = llama_workload(vocab)
    rng = np.random.default_rng(SEED + 21)
    waves = [[rng.integers(0, vocab, int(n)).tolist()
              for n in rng.integers(16, 257, k)] for k in TTFT_WAVES]
    sp = SamplingParams(max_tokens=64)
    t0 = time.perf_counter()
    telemetry.reset()
    telemetry.enable(True)
    mismatches, steps = [], 0
    with autocast(BF16_FULL):
        before = trace_counts()
        eng = ServingEngine(model, slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
                            prefill_chunk=LLAMA_CHUNK,
                            block_size=LLAMA_BLOCK, cache_dtype=torch.int8,
                            seed=SEED, device=device,
                            record_first_logits=True, slo=True)

        def step():
            nonlocal steps
            eng.step()
            steps += 1
            snap = telemetry.get_registry().snapshot()
            want = {"serving_queue_depth": eng.scheduler.depth,
                    "serving_slot_occupancy": eng.scheduler.occupancy,
                    "serving_kv_blocks_in_use": eng.blocks.blocks_in_use,
                    "serving_kv_spill_arena_blocks":
                        eng.spill_arena.blocks_held}
            mismatches.extend((steps, k, snap.get(k), v)
                              for k, v in want.items() if snap.get(k) != v)

        def drain():
            while eng.has_work():
                step()

        def wave(prompts, delay):
            reqs = [eng.submit(p, SamplingParams(max_tokens=16))
                    for p in prompts]
            time.sleep(delay)             # the injected admission delay
            drain()
            return reqs

        # ---- the main path: counters zeroed just before, read after ----
        reset_launch_counts()
        reqs = [eng.submit(p, sp) for p in burst]
        drain()
        reqs2 = [eng.submit(shared[0], sp)]
        while reqs2[0].first_token_s is None:
            step()
        reqs2 += [eng.submit(p, sp) for p in shared[1:]]
        drain()
        served = reqs + reqs2
        eng.slo = default_serving_rules(SLOEngine(telemetry.get_registry()))
        healthy = wave(waves[0], 0.0)
        early = [a.to_record() for a in eng.slo.evaluate()]
        delayed = wave(waves[1], TTFT_DELAY_S)
        counts = launch_counts()
        iters = dict(eng.lane_iters)
        # ------------------------------------------------------------------
        alerts = [a.to_record() for a in eng.slo.evaluate()]
        doc = health_status(serving=eng, slo=eng.slo)
        sound = oracle(model, healthy + delayed, 16, vocab)
    check_captures("llama_telemetry", eng, before)
    check_launches("llama_telemetry_launches", counts, iters,
                   LLAMA_SERVE_LAYERS, paged="paged_attention_int8")
    every = served + healthy + delayed
    check(all(r.status == "done" for r in every),
          "llama_telemetry: requests unfinished")
    tokens_equal = [r.tokens for r in served] \
        == [r.tokens for r in engine_reqs]
    logits_equal = all(torch.equal(a.first_logits, b.first_logits)
                       for a, b in zip(served, engine_reqs))
    ttft = {n: [r.timing()["ttft_ms"] for r in w]
            for n, w in (("healthy", healthy), ("delayed", delayed))}
    snap = telemetry.get_registry().snapshot()
    got = check_serving_series("llama_telemetry", snap, every, iters)
    fired = [a["rule"] for a in alerts]
    emit(phase="llama_telemetry", card=card, layers=LLAMA_SERVE_LAYERS,
         requests=len(every), steps=steps, gauge_mismatches=mismatches[:4],
         tokens_equal_llama_engine=tokens_equal,
         first_logits_equal_llama_engine=logits_equal,
         ttft_ms_healthy_max=max(ttft["healthy"]),
         ttft_ms_delayed_min=min(ttft["delayed"]), alerts_before=early,
         alerts=alerts, healthz=doc["status"],
         alerting_rules=doc["slo"]["alerting_rules"], series=got,
         oracle=sound, dlogit_bound=DLOGIT_BF16, tie_bound=TIE_BF16,
         seconds=time.perf_counter() - t0)
    check(tokens_equal and logits_equal,
          f"llama_telemetry: telemetry changed the output (tokens equal "
          f"{tokens_equal}, first-token logits equal {logits_equal})")
    check(not mismatches, f"llama_telemetry: gauges against the engine's "
                          f"own counts {mismatches[:4]}")
    check(not early and "ttft_slo" in fired,
          f"llama_telemetry: alerts before the delay {early}, after "
          f"{fired}")
    check(doc["status"] == "degraded"
          and "ttft_slo" in doc["slo"]["alerting_rules"],
          f"llama_telemetry: HEALTHZ {doc['status']} "
          f"{doc['slo']['alerting_rules']}")
    check_held("llama_telemetry_oracle", sound, DLOGIT_BF16, TIE_BF16)
    del eng, every, served, reqs, reqs2, healthy, delayed
    telemetry_off()
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_llama_train_telemetry(device, card, off_losses):
    """``llama_train_buckets``' Trainer with telemetry: ``Trainer(
    TrainerConfig(telemetry=True, trace_dir=, watchdog=True, slo=True,
    peak_flops=989e12, seq_buckets=(512, 1024, 2048)))`` over the same
    12 ragged batches, twice, one save between the passes: every loss
    bit-equal to ``llama_train_buckets``' (telemetry off); 3 captures,
    then none; ``compile`` seconds booked in the first pass only;
    ``data_bucket_compiles_total`` 1 a bucket and the ``data_*`` token
    counters equal to the bucketer's stats; the goodput report's MFU
    within 1% of this script's own from the same tokens/s;
    ``checkpoint_write_seconds`` one write; the artifacts parsed; one
    captured step under ``set_sync_debug_mode("error")`` with telemetry
    on. Returns the launch counts."""
    import shutil
    import tempfile
    from hetu_tpu_torch import optim, telemetry
    from hetu_tpu_torch.data import SeqLenBuckets, ShapeBucketer, to_tensors
    from hetu_tpu_torch.engine import Trainer, TrainerConfig, trace_counts
    from hetu_tpu_torch.models import LlamaLMHeadModel
    from hetu_tpu_torch.ops import launch_counts, reset_launch_counts
    from hetu_tpu_torch.parallel import Strategy
    from hetu_tpu_torch.tools import trace_summary

    t0 = time.perf_counter()
    cfg = llama_train_cfg()
    strategy = Strategy(remat="selective", unroll=True)
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(1e-4))
    model = LlamaLMHeadModel(cfg, device=device, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    tmp = tempfile.mkdtemp(prefix="hetu_tel_")
    telemetry.reset()
    peak = PEAK_FLOPS[torch.bfloat16]
    tr = Trainer(model, opt, strategy, device=device,
                 config=TrainerConfig(
                     precision="bf16", log_every=1, telemetry=True,
                     trace_dir=os.path.join(tmp, "trace"), watchdog=True,
                     slo=True, peak_flops=peak, seq_buckets=LLAMA_BUCKETS))
    try:
        tr.initialize()
        batches = ragged_llama_batches(cfg.vocab_size, RAGGED_BATCHES,
                                       SEED + 7)
        captures, reports, losses = [], [], []
        # ---- the main path: counters zeroed just before, read after ----
        reset_launch_counts()
        for pas in (1, 2):
            before = trace_counts().get("train_step", 0)
            hist = tr.train(iter(batches), steps=RAGGED_BATCHES)
            losses += [r["loss"] for r in hist if "loss" in r]
            captures.append(trace_counts().get("train_step", 0) - before)
            reports.append(tr.goodput.report())
            if pas == 1:
                tr.save(os.path.join(tmp, "ckpt"), wait=True)
        counts = launches_of(launch_counts())
        # ------------------------------------------------------------------
        snap = telemetry.get_registry().snapshot()
        st = tr.bucketer.stats
        # this script's own fits below count into the registry too
        fitter = ShapeBucketer(SeqLenBuckets(sizes=LLAMA_BUCKETS))
        fitted = to_tensors(fitter.fit(batches[0]), device)
        sync_free("llama_train_telemetry",
                  lambda: tr._step_entry_for(fitted)(tr.state, fitted))
        rep = reports[1]
        # this script's MFU from the same tokens/s: bench.py's flops per
        # token at each fitted width, weighted by the tokens it ran
        flops = 0.0
        for b in batches:
            w = int(fitter.fit(b)["input_ids"].shape[1])
            flops += LLAMA_TRAIN_BATCH * w * (
                6.0 * n_params + 6.0 * cfg.num_layers * cfg.hidden_size * w)
        own_mfu = rep.tokens_per_sec * (flops / rep.tokens) / peak
        kinds = sorted({json.loads(x)["kind"] for x in open(os.path.join(
            tmp, "trace", "telemetry.jsonl"))})
        goodput = trace_summary.report_from_records(
            trace_summary.load_records(os.path.join(tmp, "trace",
                                                    "telemetry.jsonl")))
        data = {k: series(snap, k) for k in (
            "data_real_tokens_total", "data_padding_tokens_total",
            "data_raw_tokens_total")}
        want_data = {"data_real_tokens_total": st.real_tokens,
                     "data_padding_tokens_total":
                         st.bucket_tokens - st.real_tokens,
                     "data_raw_tokens_total": st.raw_tokens}
        compiles = {b: series(snap, "data_bucket_compiles_total",
                              bucket=b) for b in LLAMA_BUCKETS}
        writes = sum(series(snap, "checkpoint_write_seconds", mode=m)
                     for m in ("sync", "async"))
        emit(phase="llama_train_telemetry", card=card,
             config="LlamaConfig.llama_7b width, 2 layers",
             seq_buckets=list(LLAMA_BUCKETS), steps=2 * RAGGED_BATCHES,
             losses_bit_equal=losses == off_losses,
             train_step_captures_by_pass=captures,
             goodput=[r.to_record() for r in reports],
             goodput_mfu=rep.mfu, script_mfu=own_mfu,
             data_series=data, bucket_stats=st.to_record(),
             data_bucket_compiles=compiles, checkpoint_writes=writes,
             watchdog_trips=series(snap, "watchdog_trips_total",
                                   name="train"),
             jsonl_kinds=kinds, trace_summary_goodput=goodput.goodput,
             launches=counts, graphs=trainer_graphs(tr),
             seconds=time.perf_counter() - t0)
        check(losses == off_losses,
              f"llama_train_telemetry: losses differ from the telemetry-off "
              f"run: {losses[:3]} against {off_losses[:3]}")
        check(captures == [3, 0], f"llama_train_telemetry: captures by "
                                  f"pass {captures}")
        check(reports[0].components.get("compile", 0.0) > 0
              and "compile" not in reports[1].components,
              f"llama_train_telemetry: compile seconds by pass "
              f"{[r.components.get('compile') for r in reports]}")
        check(all(v == 1 for v in compiles.values()),
              f"llama_train_telemetry: bucket compiles {compiles}")
        check(data == want_data, f"llama_train_telemetry: data series "
                                 f"{data} against {want_data}")
        check(rep.mfu is not None and abs(rep.mfu - own_mfu)
              <= 0.01 * own_mfu,
              f"llama_train_telemetry: goodput MFU {rep.mfu} against "
              f"{own_mfu}")
        check(writes == 1, f"llama_train_telemetry: {writes} checkpoint "
                           f"writes observed")
        check({"goodput", "metrics", "metrics_snapshot", "span"}
              <= set(kinds), f"llama_train_telemetry: records {kinds}")
        check(counts == {k: 2 * RAGGED_BATCHES * cfg.num_layers
                         for k in FLASH},
              f"llama_train_telemetry: launches {counts}")
    finally:
        tr.close()
        shutil.rmtree(tmp, ignore_errors=True)
        telemetry_off()
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


LLAMA_CLASSES = KERNEL_CLASSES + (("nvjet", "matmul"),)


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
    from hetu_tpu_torch.data import to_tensors
    from hetu_tpu_torch.engine import build_train_step
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
    ptxas = check_ptxas(built)

    timer = Timer(device)
    kernels = phase_kernels(device, timer, ops)
    for name, sym in (("flash_fwd", "flash_fwd_tc"),
                      ("flash_bwd_dq", "flash_bwd_dq_tc"),
                      ("flash_bwd_dkv", "flash_bwd_dkv_tc")):
        kernels[name]["ptxas"] = {k: v for k, v in ptxas.items()
                                  if k.startswith(sym)}
    paths = {}
    paths["engine"], gpt2 = phase_engine(device, smi)
    paths["gpt2_telemetry"] = phase_gpt2_telemetry(device, smi, gpt2,
                                                   paths["engine"])
    paths["gpt2_server"] = phase_gpt2_server(device, smi, gpt2)
    paths["gpt2_fleet"], colocated = phase_gpt2_fleet(device, smi, gpt2)
    paths["gpt2_fleet_kill"] = phase_gpt2_fleet_kill(device, smi, gpt2)
    paths["gpt2_fleet_push"] = phase_gpt2_fleet_push(device, smi, gpt2)
    paths["gpt2_fleet_pd"] = phase_gpt2_fleet_pd(device, smi, gpt2,
                                                 colocated)
    paths["gpt2_fleet_server"] = phase_gpt2_fleet_server(device, smi, gpt2)
    del gpt2
    gc.collect()
    release()
    paths["gpt2_rollout"] = phase_gpt2_rollout(device, smi)
    gc.collect()
    release()
    run = phase_train(device, smi)
    paths["train"] = run["counts"]
    phase_train_profile(run)
    batch = run["batch_size"]
    del run
    gc.collect()
    release()
    paths.update(phase_train_capture(device, smi, batch))
    phase_train_kernels(device, timer, ops, batch, kernels)
    kernels.update(phase_fused_kernels(device, ops))
    for name in FUSED:
        kernels[name]["ptxas"] = {
            key: ptxas[key] for key in (*FUSED_TC_INSTANCES,
                                        *FUSED_WIDE_TC_INSTANCES)
            if key.startswith(name + "_")}
    run = phase_train_fused(device, smi)
    paths["train_fused"] = run["counts"]
    batch = run["batch_size"]
    del run
    gc.collect()
    release()
    phase_fused_kernel_times(device, timer, ops, batch, kernels)
    phase_llama_kernels(device, timer, ops, kernels)
    phase_verify_kernels(device, timer, ops, kernels)
    phase_w8a8_gemm(device, timer, smi)
    paths["llama_engine"], model, llama_perf = phase_llama_engine(
        device, smi, timer)
    paths["llama_telemetry"] = phase_llama_telemetry(
        device, smi, model, llama_perf.pop("requests"))
    paths["llama_budget_engine"] = phase_llama_budget_engine(device, smi,
                                                             model)
    paths["llama_preempt"] = phase_llama_preempt(device, smi, model)
    paths["llama_evict_resume"] = phase_llama_evict_resume(device, smi,
                                                           model)
    paths["llama_spec"] = phase_llama_spec(device, smi, model)
    paths["llama_tenancy"] = phase_llama_tenancy(device, smi, model, timer)
    paths["llama_server"] = phase_llama_server(device, smi, model,
                                               llama_perf)
    paths["llama_w8a8"] = phase_llama_w8a8(device, smi, model, llama_perf)
    paths["llama_w8a8_spec"] = phase_llama_w8a8_spec(device, smi, model)
    del model
    gc.collect()
    release()
    phase_llama_lora_train_oracle(device)
    paths["llama_lora_sft"] = phase_llama_lora_sft(device, smi)
    phase_llama_oracle_fp32(device)
    phase_llama_train_oracle(device)
    llama = phase_llama_train(device, smi)
    paths["llama_train"] = llama["counts"]
    chunked_figures = llama["figures"]
    trainer = llama["trainer"]
    phase_train_profile(dict(
        state=trainer.state, batch_size=LLAMA_TRAIN_BATCH,
        step=build_train_step(trainer.model, trainer.opt, trainer.plan),
        batch=to_tensors(llama["batch"], device)),
        phase="llama_train_profile")
    pretrained = trainer.model.state_dict()
    del trainer, llama["trainer"]
    gc.collect()
    release()
    phase_llama_train_kernels(device, timer, ops, llama["batch"], kernels)
    paths["llama_sft"] = phase_llama_sft(device, smi, pretrained)
    del pretrained
    gc.collect()
    release()
    phase_llama_train_oracle(device, fused=True)
    fused = phase_llama_train(device, smi, fused=True, beside=chunked_figures)
    paths["llama_train_fused"] = fused["counts"]
    trainer = fused["trainer"]
    with fused_loss():
        phase_train_profile(dict(
            state=trainer.state, batch_size=LLAMA_TRAIN_BATCH,
            step=build_train_step(trainer.model, trainer.opt, trainer.plan),
            batch=to_tensors(fused["batch"], device)),
            phase="llama_train_fused_profile", fused_lane="tensor_core_wide")
    del trainer, fused
    gc.collect()
    release()
    phase_llama_fused_kernel_times(device, timer, ops, kernels,
                                   paths["llama_train_fused"])
    paths["llama_ckpt"] = phase_llama_ckpt(device, smi)
    paths["llama_train_buckets"], bucket_losses = \
        phase_llama_train_buckets(device, smi)
    paths["llama_train_telemetry"] = phase_llama_train_telemetry(
        device, smi, bucket_losses)
    paths["llama_grad_accum"] = phase_llama_grad_accum(device, smi)
    paths["llama_train_adafactor"] = phase_llama_train_adafactor(device,
                                                                 smi)
    phase_moe_train_oracle(device)
    moe = phase_moe_train(device, smi)
    paths["moe_train"] = moe["counts"]
    trainer = moe["trainer"]
    phase_train_profile(dict(
        state=trainer.state, batch_size=MOE_BATCH,
        step=build_train_step(trainer.model, trainer.opt, trainer.plan),
        batch=to_tensors(moe["batch"], device)), phase="moe_train_profile")
    trainer.close()
    paths["moe_train_telemetry"] = phase_moe_train_telemetry(
        device, smi, trainer.model, moe["batch"], moe["step_ms"])
    del trainer, moe
    gc.collect()
    release()
    paths["moe_engine"] = phase_moe_engine(device, smi)
    paths["moe_w8a8"] = phase_moe_w8a8(device, smi)
    paths["gpt2_spec"] = phase_gpt2_spec(device, smi)
    paths["gpt2_spec_small_draft"] = phase_gpt2_spec_small_draft(device, smi)
    paths["gpt2_tenancy"] = phase_gpt2_tenancy(device, smi)
    del timer
    from hetu_tpu_torch.engine import get_step_cache
    release()
    emit(phase="step_cache", entries_left=len(get_step_cache()),
         stats=get_step_cache().stats(),
         reserved_bytes=torch.cuda.memory_reserved())
    for name, entry in kernels.items():
        entry["launches_by_path"] = {p: c.get(name, 0)
                                     for p, c in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
    order = ("name", "route", "lane", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    line = [{**{k: e.get(k) for k in order},
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
