#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_task_torch``) on one NVIDIA
card: builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version, times it, drives the paged serving engine at the
flagship model's full width (model-dtype and quantized KV pools,
K-token micro-steps, speculative decoding, drain and resume, blocks
imported from the fleet KV plane, the HTTP replica, weight rolls, paged
LoRA adapters, the overlapped loop, the host KV tier, mixture-of-experts
layers, bucketed prefill, tensor- and expert-parallel gangs), and trains the flagship for a few steps, checkpointing, killing
and restoring it, and its mixture-of-experts variant, also sharded over
SPMD ranks, over the sequence and over pipeline stages.

    python3 chip_smoke.py

Phases, each printing one JSON line (with ``t_s``, its seconds since the
start); any failed check raises and the script exits non-zero:

1. device  — the card's name and power limit; TF32 off for the fp32 phases.
2. build   — nvcc for every kernel source, all started together, with
             ptxas's report; then the registers, spills, dynamic shared
             memory and CTAs per SM at d 64 and 128 of the flash forward
             (B1 v3) and of the backward's dq and dk/dv kernels (B2, B3
             v3), all wgmma fed by TMA rings, failing on a spill.
3. kernel  — the paged-decode kernel against its plain version at the
             flagship geometry (kv 2, group 4, d 128, block 16): fragmented
             shuffled tables, ragged depths, inactive rows, fp32 and bf16;
             24 rows of widths 1 and 3 up to depth 2048, and the serve
             runs' 16-row decode and 144-row chunk steps and 16-row
             speculative scoring steps at widths 5 and 4 (tables 72 wide).
             Each case also launches into a NaN-guarded buffer to show the
             kernel writes its output and nothing beside it. Each case is
             then run at forced split counts of the KV walk (1, 2, the
             plan, one per tile) with NaN-filled split states: the output
             against the merge of the plain split states and the plain
             version, the split states against ``paged_split_partials``,
             the combine kernel alone against ``combine_partials``, inputs
             unchanged.
4. timing  — kernel, plain version and SDPA over the gathered view
             (``library_ms``, a yardstick the port never calls) at batch 1,
             16 and 32, depth 1024, and at the serve run's 144-row chunk
             step (ragged depths up to 1151, SDPA masked), beside the
             memory bound, with the split plan and CTAs of each and the
             kernel's time with its walk left whole (``unsplit_ms``, one
             split); the kernel is held against the plain version there
             too. Then, at batch
             16, wrapper calls under ``torch.profiler`` (one split walk and
             one combine each: their device ms and the span between), and
             the combine kernel alone at that shape's split states. Then
             the speculative scoring step (``timing_spec``): the tile
             kernel at 16 rows x w 5 over bf16 pools, the pipelined one at
             16 x w 4 over int8 (its tensor-core path), each beside its
             one-split time, the plain version, SDPA with each query's
             causal mask and the bound.
5. parity  — the engine on the ``tiny`` and ``micro`` presets at fp32:
             greedy and keyed-sampled streams through the kernel equal those
             through the plain version, and greedy ones equal ``generate``;
             prefix cache, chunked prefill and a pool small enough to force
             preemption.
6. serve   — the flagship (vocab 32768, d_model 1024, 8 layers, 8 heads of
             128, 2 kv heads, d_ff 4096, bf16, random weights from a torch
             Generator): after a short warm-up wave, three timed waves of 16
             requests of 256-1024 prompt tokens and 64 new tokens each, 12
             greedy and 4 sampled: tokens/s (each wave and the median), step
             times, and launch counts that prove the fused steps ran the
             kernel (and the combine kernel wherever the plan splits the
             step's shape). Layer 0's attention in the first decode step
             and the
             last chunk step of the first wave is held against the plain
             version on the same inputs. Then the engine publishes every
             hot block of its prefix cache into a temporary bucket (phase
             24).
7. flash kernel — the forward, dq and dk/dv kernels against their plain
             versions: fp32 (2e-5 forward, 5e-5 backward) and bf16 (against
             the plain version in fp32 on the same bf16 values, within
             2^-8 of each element and of the tensor's largest), the flagship
             train shape (b 8, s 1024, h 8, d 128, causal), causal and not,
             sq = sk, sq < sk, q_offset 0 with sq != sk, a negative
             q_offset with rows that see no key, a ragged length, d 64 and
             128, lengths 128 to 2048, the forward's 128-row tile edges
             (sq 1, 127, 129, 257, sk < sq, q_offset -130, d 64 at sq
             384) and the backward's 64-row q stage edges (sq 65 and 193,
             q_offset -64), and the zigzag ring's four block shapes at
             8192 tokens over sp 4 (2048 against 1024 causal at q_offset
             0, 1024 against 1024, and non-causal 2048 x 1024 and 1024 x
             2048). Each case also launches every kernel into NaN-guarded
             buffers. Then the backward fed a folded lse: the ring
             diagonal's first block merged with a second block
             (``flash_kernel_folded_lse``, fp32 and bf16).
8. flash timing — each kernel at the flagship train shape (bf16, held
             against its plain version in phase 7): kernel, plain and bound
             ms, SDPA's forward and backward (``library_ms``, a yardstick
             the port never calls) and the plain-torch delta before the
             backward; then the forward and SDPA's forward, and the
             backward pair and SDPA's backward, at six shapes, with a fit
             of each wgmma kernel's ms as a fixed cost per CTA plus a cost
             per tile step.
9. train parity — small GQA configs with a 256-token sequence, fp32 at d 32
             (the fp32-core kernels) and bf16 at d 128 (the tensor-core
             kernels): three ``make_train_step`` steps through the kernels
             and through the plain versions, from the same weights and
             tokens.
10. train  — the flagship train step (vocab 32768, d_model 1024, 8 layers,
             8 heads of 128, MHA, d_ff 4096, bf16 over fp32 master weights,
             batch 8 x 1024 tokens, random weights from a torch Generator):
             two warm-up steps, the first recorded so that layer 0's
             forward and the last layer's backward are held against the
             plain versions in fp32, then ten timed steps on one batch:
             step ms, tokens/s, MFU, peak memory, one profiled step, and
             launch counts that prove every layer ran the three kernels.
10a. train checkpoint — the flagship state on the card (2,416,128,008
             bytes): two steps, a sync ``save_checkpoint_sharded`` at step
             2, then ``AsyncCheckpointer(keep=2).save`` at steps 4 and 6
             with steps between and after, ``wait()``. The restore of step
             6 into a fresh ``init_state`` equals a device clone of the
             state at step 6 bit for bit; three more steps from it and from
             the original give losses within ``RESUME_LOSS_RTOL``; every
             step runs each flash kernel n_layers times and no plain
             version. Blocked ms a save (sync, async), save →
             ``LATEST_SHARDED`` ms, steps overlapped by the writer against
             steps not, pinned host bytes, the snapshot's device bytes.
10b. train resume process — ``TRAINER_SCRIPT`` as its own process on the
             card (``epoch_batches`` + ``prefetch_to_device`` over seeded
             tokens, ``AsyncCheckpointer``), SIGKILLed once its first
             ``LATEST_SHARDED`` is published, before its last step, and
             started again: it restores that step, runs the rest (saving
             nothing), and its losses are the uninterrupted in-process
             run's within
             ``RESUME_LOSS_RTOL``; the steps lost at the kill and the
             recovery split (restart → imported → CUDA ready → npz read →
             host→device → first step done).
10c. train profile window — ``profiling.step_window`` over two flagship
             steps: two traces, each naming the three wgmma flash kernels;
             ``device_memory_summary()`` is not empty.

11. kernel quant — both paged kernels (``paged_decode.cu``'s int8, fp8 and
             int4 variants; ``paged_decode_pipelined.cu`` over all five
             storage types, on its tensor-core path for bf16 queries at d
             128 and 16 and its scalar path otherwise) against the plain
             version in fp32 on the same codes: the flagship geometry (kv
             2, group 4, d 128, block 16), d 16 at block 8 and d 8 at block
             4, widths 1 and 3, 24 rows of ragged depths up to 2048 with
             inactive rows, and the serve runs' 16-row decode, 144-row
             chunk and 16-row scoring steps (w 5 and 4; the pipelined
             kernel's tensor cores take w 4, w x group 4 <= 16 rows); fp32
             and bf16 queries, phase 3's gates and forced
             splits (each kernel at its own plan), NaN-guarded, inputs
             unchanged.
12. timing quant — both kernels, the plain version and SDPA over the view
             dequantized to bf16 ahead of time (``library_ms``; the
             dequantization is not timed) for each storage type at batch
             1, 16 and 32, depth 1024, and at the 144-row chunk step,
             beside the bytes bound and each kernel's split plan, CTAs and
             ``unsplit_ms``; then the pipelined kernel's int8 batch-16
             calls under ``torch.profiler`` (split walk and combine).
13. parity quant — the engine on ``tiny``, ``micro`` and the INT8_PIN
             geometry of ``tests/test_paged_attention.py`` at fp32, for
             each kv_dtype: greedy and keyed-sampled streams through
             ``"cuda"``, ``"pipelined"`` and ``"reference"`` are equal, with
             the prefix cache, copy-on-write and a pool small enough to
             force preemption.
14. serve quant — the flagship at the serve phase's configuration with
             ``kv_dtype="int8", decode_impl="pipelined"``: a warm-up wave and
             three timed waves of phase 6's traffic (launches must be
             n_layers per fused step through the pipelined kernel, its
             combine after every call the plan splits, 0 through the tile
             kernel and the plain version; layer 0's attention in
             the first decode and last chunk step held against the plain
             version), then one shorter wave each of fp8 and int4 through
             the pipelined kernel and of int8 through the tile kernel, under
             the same gates. The int8 engine publishes its hot blocks
             as phase 6's does.
15. serve micro — the flagship with bf16 pools through the tile kernel
             at ``micro_k`` 1, 4 and 8 (the K-step loop a CUDA graph at K >
             1), each engine after phase 6's warm-up: one timed wave of
             phase 6's traffic each (two before phase 34, three before
             phase 33), with tokens/s, mean chunk-step and
             decode- or micro-step ms, micro-steps, graph captures and
             capture ms, host_gap_frac, dispatches per token and peak
             memory. Every request's stream at K = 4 and 8 must equal K =
             1's token for token, greedy and sampled; launches must be
             n_layers per chunk step and n_layers x K per micro-step (a
             retired slot's iterations run masked), the combine kernel's
             likewise where the plan splits, 0 through the other kernel
             and the plain version.
16. serve trace — one more wave at K = 8, the serve wave's first 4
             requests, under ``torch.profiler`` (CPU and CUDA; the K = 1
             trace went to make room for phase 30, the wave's other
             requests for phases 31 and 32): per chunk step and per
             decode or micro-step the mean wall, device-busy ms and idle
             share, the ten device ops with the most time and the ten host
             ops with the most self time; the paged kernels' launches
             counted by name in the trace must equal the counters.
17. serve micro quant — int8 pools through the pipelined kernel at K = 8,
             one wave against a K = 1 engine of the same configuration,
             under phase 15's gates.
18. parity spec — speculative decoding (``spec_k`` 2) on ``tiny`` and
             ``micro`` at fp32, the target as its own draft and a
             differently seeded model of the preset: streams through the
             kernel equal those through the plain version, greedy ones
             equal ``spec_k = 0``'s and ``generate``'s, launches equal the
             target's layers x (chunk steps + rounds) plus the draft's
             layers x (its decode and catch-up calls), 0 plain; the self
             draft accepts over 90% on the greedy requests alone.
19. serve spec — the flagship with bf16 pools through the tile kernel at
             ``spec_k`` 4 (scoring at w 5): the target as its own draft
             and a random-init 2-layer d_model 512 draft, one timed wave
             of phase 6's traffic each (two before phase 33): tokens/s, decode-phase
             tokens/s (what the rounds commit over their wall), rounds,
             the mean round split into catch-up, proposals, scoring and
             the host's accept, accept rate, tokens a round, launches
             against the calls (counted by wrapping the model functions by
             call site), pool bytes, peak memory, and how many greedy
             streams equal phase 6's (reported; each that differs with its
             first differing position and top-2 logit gap). Layer 0's
             attention in a target scoring, target chunk, draft decode and
             draft catch-up call is held against the fp32 plain version.
20. serve spec quant — int8 pools through the pipelined kernel at
             ``spec_k`` 3 (scoring at w 4 on its tensor cores), the target
             as its own draft, one wave, phase 19's lines and gates.
21. parity resume — drain and resume (``export_inflight`` → ``json`` →
             ``resume_inflight``) on ``micro`` and ``tiny`` at fp32 and int8
             pools, through ``"cuda"``, ``"pipelined"`` and ``"reference"``,
             at K = 1, ``micro_k`` 4 and ``spec_k`` 2 (self draft): a wave
             of greedy and keyed-sampled requests exported once every
             request holds tokens, resumed in a fresh engine whose pool
             preempts a resumed slot. Every resumed stream equals the
             uninterrupted one (a spec engine's sampled streams are held to
             the plain version's resume instead: the token at
             ``len(tokens)`` comes from the chunk step's sampler, as in the
             JAX engine), the preempted resumed requests keep exactly their
             imported tokens, launches are as the calls need them, and the
             resume captures no K-step graph. Then one wave of mixed SLO
             classes and deadlines on ``micro`` into a tight pool, on the
             card and on the CPU: the same admissions and victims in the
             same order, and the same streams.
22. serve resume — the flagship at the serve configuration, bf16 pools
             through the tile kernel and int8 through the pipelined kernel:
             phase 6's first wave exported once half its requests hold
             tokens (export ms, record bytes), resumed in a fresh engine
             after the warm-up under phase 6's launch gates: the
             re-ingest's chunk steps and ms until every request has its
             next token, ``tokens.reingested``, tokens/s, peak memory, and
             how many streams equal the uninterrupted wave's (reported;
             each that differs with its first differing position and top-2
             logit gap). Layer 0's attention in the first re-ingest chunk
             step is held against the fp32 plain version.
23. parity kvfleet — the fleet KV seam on ``micro`` and ``tiny`` at fp32
             and int8 pools, through ``"cuda"``, ``"pipelined"`` and
             ``"reference"``, plus ``micro_k`` 4 (tiny, int8, pipelined)
             and ``spec_k`` 2 (micro, fp32, tile kernel): engine A serves
             a wave of greedy and keyed-sampled requests and publishes
             every hot block into a temporary ``LocalBackend`` bucket, a
             fresh engine B bound to it serves the same wave. B's streams
             equal A's, B's imported blocks read back byte-equal to the
             bucket's payloads, ``hit_blocks`` equals the index's chain
             depths, and B ran its kernel and not the plain version.
24. serve kvfleet — the flagship imports what phases 6 (bf16, tile
             kernel) and 14 (int8, pipelined kernel) published: a fresh
             engine bound to the bucket, after the warm-up, serves the
             publishers' last wave (seed 2) again under phase 6's launch
             gates: blocks, bytes and ms of the publish (stage, read
             back, write), each admission's import ms, ``hit_blocks``
             against the chain depths, chunk steps and ms until every
             request holds its first token against the publisher's,
             tokens/s, launches, and how many streams equal the
             publisher's (reported).
25. parity replica — the HTTP replica (``ReplicaServer``) on ``micro``
             and ``tiny`` at fp32 and int8 pools, through ``"cuda"`` and
             ``"pipelined"``, driven over loopback by
             this script's own ``http.client`` code: a wave of greedy and
             keyed-sampled requests with trace and SLA headers, streamed
             by offset, equals the same engine driven directly; ``/metrics``
             parses and ``/obs`` holds one queue, prefill and decode span
             a request under its header's trace; replica B's ``POST
             /prefetch`` imports the chain A's ship thread published; the
             wave again on A, ``POST /drain`` once every request holds
             tokens, a 429 with ``Retry-After: 0``, and the records
             re-dispatched to B with their tokens and key: the joined
             streams equal the direct ones; two cases take a ``/profile``
             capture that must name their kernel. Then ``python -m
             tpu_task_torch.serve.replica --preset tiny --kv-bucket`` as its
             own process on the card: ``endpoint.json``, a wave served,
             SIGTERM with it twice more in flight, ``inflight.json``, exit
             0, and the records resumed here with equal streams. Gates:
             the engine's kernel ran and nothing else, no ``replica.errors``,
             no drain nobody asked for, no 500.
26. serve replica — the flagship engine of phase 6 (bf16, tile kernel)
             and of phase 14 (int8, pipelined kernel), each with an obs
             handle, warmed up and wrapped in ``ReplicaServer(engine=)``:
             16 client threads submit phase 6's seed-2 wave over HTTP and
             long-poll their streams while a probe times the replica's
             lock every 10 ms: tokens/s against phase 6's (14's) direct
             median, client time to first token and inter-token gap (p50,
             p99), the engine's ``engine.ttft_s`` quantiles from
             ``/metrics``, the lock waits, launches, and how many streams
             equal phase 6's wave (reported). For bf16, first the seed-3
             and seed-4 waves driven directly by the engine and an obs-off
             twin in turns (off, on, on, off). Gates as phase 25's, phase 6's launch
             gates, and every request ends with 64 tokens.
27. serve roll — weight hot-swap on the flagship of phase 6, warmed up:
             bf16 through the tile kernel at K = 1, int8 through the
             pipelined kernel at K = 1, and bf16 at K = 4 (graphs per
             generation). Each serves phase 6's seed-2 wave at 32 and 96
             new tokens in turn, calls ``adopt_params(generation=1)`` with
             weights from another seed once every request holds 8 tokens,
             submits the seed-3 wave and drains. Gates: every request ends
             with its ``max_new_tokens``, a step dispatched two
             generations, one swap, no stale stream and generation 1 alone
             at the end (at K = 4, generation 0's graphs gone), the last
             old stream's retirement frees at least 0.9 of generation 0's
             param bytes (bf16: 377.5 MB), and phase 6's launch gates.
             Reported: adopt and capture ms, tokens/s against phase 6's
             median, the longest step mid-roll, and the streams equal to
             single-generation runs. Then the replica
             roll: ``ReplicaServer(ckpt_dir=, ckpt_poll_s=0.05)`` over the
             bf16 engine while 16 HTTP clients stream the seed-2 wave and
             this script publishes steps 1 and 2; gates: 64 tokens a
             stream, ``/healthz`` generation 2, ``replica.param_rolls``
             2, no error or 500, the launch gates; reported: restore and
             lock-held times, inter-token p99 against phase 26's.
28. serve lora — paged LoRA adapters (rank 16, 8 tenants from seeded
             numpy generators) on the flagship of phase 6: (a) a 65-block
             pool holding the 8 adapters, base traffic alone (phase 6's
             seed-2 wave): streams and kernel and combine launches equal
             phase 6's (the drop rule runs the LoRA-free program); (b) the
             same engine at 25% and 100% adapter traffic, tenants
             round-robin: 64 tokens a request, an adapter stream that
             differs from its base stream, 8 registered, 8 resident, a
             pool high water of 64 blocks, phase 6's launch gates;
             reported: tokens/s against phase 6's median, the LoRA
             branch's device time in a
             100% decode step (traced, and timed alone). (c) and (d) a
             pool of four adapters registered with ``host_copy=False``
             into a local bucket, at K = 1 and 4: tenants 0-3, 4-7, 0-3 on
             the wave's first 8 requests; the third wave equals the first
             token for token, at least 4 evictions and 12 loads, the pool
             never rebound, and at K = 4 the LoRA graphs captured once and
             replayed over the reloaded adapters. (e) int8 pools through
             the pipelined kernel at 100%. (f) ``ReplicaServer`` over a
             fresh engine of (b): four adapters over ``POST /adapter``, 16
             HTTP clients with their ids round-robin; 64 tokens a stream,
             4 registered in ``/stats``, the ``adapters`` series in
             ``/metrics``, no 500. Then ``apply_lora`` at 16 and 144 rows
             (bf16) against float64 (within 2^-6 of its products'
             magnitude; scratch and scale-0 rows exactly 0.0), and the
             tiny preset at fp32 through both kernels and the plain
             version: the 8-adapter mixed wave equals dedicated
             single-adapter engines, and the plain run.
29. serve overlap — the overlapped loop (``ServingConfig(overlap=True)``).
             (a) the tiny preset at fp32 through ``"cuda"``,
             ``"pipelined"`` and ``"reference"`` at K 1 and 4, overlapped
             and synchronous: arrivals between steps (``overlap_arrivals``,
             the preset's pool) and ``OVERLAP_TIGHT``'s pool, each traffic
             twice on one engine, the second pass with every overlapped
             dispatch under ``torch.cuda.set_sync_debug_mode("error")``.
             Gates: streams equal the synchronous engine's token for
             token, equal preemptions, flushes in the tight pool, no sync
             in a dispatch, launches those of the programs through the
             route alone. (b)/(d) the flagship of phase 6 (bf16, the tile
             kernel) overlapped at K 1 and 8 against a synchronous twin,
             both after phase 6's warm-up, on phase 6's seed-2 wave in
             turns (sync, overlap, overlap, sync), every overlapped
             dispatch under the sync debug mode; gates: 64 tokens a
             request, phase 6's launch gates (n_layers a chunk program,
             n_layers x K a micro program), ``overlapped_host_s`` > 0;
             reported: tokens/s and each arm's median, step ms by kind,
             ``host_gap_frac``, the consume edge's wait, dispatches per
             token, captures, the twin's streams (first divergence and
             top-2 gap), and one traced overlapped wave at K 8 (phase
             16's 4 requests; its idle
             share beside phase 16's synchronous one). (c) int8 through
             the pipelined kernel overlapped at K 8, one wave, (b)'s gates.
30. serve tier — the host KV tier (``ServingConfig(host_offload_blocks=
             N)``). (a) the tiny preset at fp32 through ``"cuda"``,
             ``"pipelined"`` and ``"reference"`` at K 1 and 4, synchronous
             and overlapped: 10 multi-turn sessions (every third keyed
             sampled) on an 11-block pool, a fifth of their final
             contexts, under a 64-block tier, from two bases in turn; the
             overlapped engine's second pass runs every dispatch, demote
             pass, force and promotion import under the sync debug mode.
             Gates: streams equal a pressure-free engine's token for
             token, blocks demoted and promoted, each checked method
             moving work with a program in flight, launches those of the
             programs through the route alone. (b) the flagship of phase
             6 (bf16, the tile kernel, K 1) on 32 sessions of 2 turns
             (256-token first prompts, 32 new tokens a turn, 16 appended),
             a pool of 16 x 22 + 1 blocks (46 MB) under a 4096-block tier,
             overlapped and synchronous, beside a no-tier twin of the same
             pool and a pressure-free engine (673 blocks); gates: 32
             tokens a request, phase 6's launch gates, every block the
             synchronous run promotes equal to its tier payload byte for
             byte; reported: streams against the pressure-free engine's
             (first divergence, top-2 gap), resume time to first token
             by residency (HBM hit, host promotion, recompute on the
             twin), tokens/s against the twin, demote and promote MB,
             device GB/s and host ms, launches per demote pass,
             ``host_gap_frac``, ``overlapped_host_s`` and the consume
             edge's wait. (c) int8 through the pipelined kernel,
             overlapped, one pass, (b)'s gates. Then the bus alone: one
             64 MiB copy each way between the card and pinned memory.
31. serve moe — mixture-of-experts layers through the dense dispatch
             (``tpu_task_torch/ml/models/moe.py``). (a) the ``moe`` preset
             (top-1) and a top-2 config of the ``tiny`` geometry at fp32:
             the dispatch on the card against the CPU's (1e-5), then five
             legs (greedy K 1 and 4, sampled K 1, ``spec_k`` 2 with the
             model as its own draft, overlapped K 4 with the dispatch
             region under the sync debug mode), 5 requests each (8
             before phase 34), through ``cuda``
             (fp32 pools) and ``pipelined`` (int8), equal to the plain
             route token for token, launches those of the programs. (b)
             ``FLAGSHIP_MOE`` (phase 6's flagship, 8 experts top-2 on
             every second layer, bf16) on phase 6's configuration at K 1,
             K 8 overlapped and int8 K 8 overlapped, each beside a dense
             twin on phase 6's seed-0 wave: tokens/s, step ms, phase 6's
             launch gates, the dispatch's share of one traced decode
             step and its time alone in a CUDA graph. (c)
             ``TRAIN_FLAGSHIP_MOE`` at batch 8 x 1024: 6 steps after one
             warm-up, finite losses, 8 launches of each flash kernel a
             step; step ms, MFU with top-k experts counted, peak memory,
             one profiled step and the float32 expert products' share.
32. serve bucketed — bucketed prefill (``ServingConfig(prefill=
             "bucketed")``: one program a whole prompt, ``paged_prefill``,
             then the paged kernels decode). (a) the ``tiny`` and ``moe``
             presets at fp32, greedy K 1 and 4, sampled K 1 and ``spec_k``
             2 (the model as its own draft), each through ``cuda`` (fp32
             pools) and ``pipelined`` (int8): streams equal the same
             engine on the CPU's plain route token for token, no chunk
             step, launches those of the decode programs through the
             route alone (and the combine wherever the plan splits). (b)
             the flagship (bf16) on the JAX bench's long-prompt-under-load
             scenario (``bench_serving_long_prompt``: slots 4, block 16,
             160 blocks, max_len 416, buckets 8 and 384, chunk 16, no
             prefix cache; 3 runners of 8-token prompts at 56 new tokens
             admitted, then 6 prompts of 384 tokens at 4 new), chunked and
             bucketed, then bucketed over int8 pools through the pipelined
             kernel: the runners' inter-token p50/p99, the long prompts'
             TTFT p50, the makespan, and the device-busy and wall ms of
             one 384-token prefill by each mode's programs (24 chunk
             programs, or one ``paged_prefill``); gates: every request
             its tokens, every decode step (and chunk step) ran the
             kernel n_layers times and the combine wherever the plan
             splits, nothing else launched.
33. serve mesh — tensor- and expert-parallel serving on gangs of ranks
             (``tpu_task_torch/ml/parallel/gang.py``: every rank a process
             of its own on the one card, gloo between them; each gang
             starts at its turn, ``gang.start``).
             (a) at fp32 against one device on the CPU's plain route,
             token for token: ``micro`` at tp 2 through ``cuda`` and
             ``pipelined`` int8, at K 4, at ``spec_k`` 2 (the model as its
             own draft) and sampled; ``moe`` at ep 2 and tp 2 x ep 2
             (sampled). Gates: every rank's kernel launches those of the
             programs (the combine wherever the plan splits), all ranks
             equal, no graph captured, and each rank's kernel on its own
             kv-head block of layer 0's pools against the plain version.
             (b) phase 6's flagship at tp 2 through ``cuda`` (bf16) and
             ``pipelined`` (int8) and ``FLAGSHIP_MOE`` at ep 2, each on
             the serve wave's 16 requests (every slot live; prompts cut to
             MESH_PROMPT tokens, MESH_NEW new) through one rank's engine
             on the same params, then through the gang's: tokens/s and
             decode and chunk step ms against that one rank's, collectives
             a step by kind with their host ms, each rank's param and pool
             bytes against one device's; gates: the one rank's wave
             passes the serve waves' gates, every rank launched the
             kernel n_layers times a step with a combine in every split
             step, the rank's kernel against the plain version. No follower may outlive its gang.
34. train_mesh — sharded training: one launch of 4 SPMD ranks on
             ``cuda:0`` (``TRAIN_MESH_SCRIPT``, each started with
             ``worker_env`` and ``distributed_init_from_env``, gloo), then
             a second for the restart. (a) Tiny fp32 parity legs, (fsdp
             2, tp 2) and the MoE step on (dp 2, ep 2): three sharded steps
             through the flash kernels, each rank's blocks within 2e-5 of
             the one-process step on the card through the plain route,
             loss and grad norm within 1e-5 of it and of the same step on
             the CPU (the params' gap to the CPU's reported); every rank's
             launches alike. (b) ``TRAIN_FLAGSHIP`` (bf16, batch 8 x 1024)
             on (dp 1, fsdp 2, tp 2): one warm-up step, recorded
             (layer 0's forward and the last layer's backward against the
             plain versions on every rank), then three timed steps: step
             ms on each rank, collectives by kind with their ms, bytes a rank
             against one device, launches 8 a kernel a step and 0 plain,
             losses falling. (c) ``TRAIN_FLAGSHIP_MOE`` on (dp 2, ep 2),
             one warm-up and two timed steps, the same fields. (d) Every
             rank SIGKILLed once all parked after (c); relaunched, each
             restores its blocks of step 2 and runs to step 4 on (b)'s
             batch, losses within ``RESUME_LOSS_RTOL`` of (b)'s, with the
             seconds from the restart to its first step.
35. train_sp — sequence-parallel training, legs of phase 34's first
             launch: ``make_sp_train_step`` on tiny fp32 legs (zigzag on sp
             4, Ulysses on sp 4, zigzag on dp 2 x sp 2; tokens (2, 1025),
             two steps, phase 34's parity gate with the card step held,
             as the CPU one, to twice the one-process card step's own gap
             to the CPU, B1-B3 (sp + 1) x n_layers a step for zigzag and
             n_layers for Ulysses on every rank) and ``TRAIN_FLAGSHIP`` on
             the JAX bench's long-context row, tokens (1, 8193) over sp 4,
             zigzag and Ulysses, one warm-up (recorded as in (b)) and two
             timed steps: step ms on each rank, collectives with calls, ms
             and bytes (``ppermute`` among them), their share, peak memory;
             gates: 40 / 8 launches a kernel a step on every rank, 0
             plain, losses falling, and the first step's loss and grad norm
             within ``TRAIN_SP_RTOL`` of the one-process step on the same
             params and tokens. ``train_sp`` sums the legs' seconds.
36. train_pp — pipeline-parallel training (1F1B), legs of phase 34's
             first launch: ``make_pp_train_step`` on tiny fp32 legs
             (``TRAIN_PP_TINY``: pp 4 at 4 microbatches, dp 2 x pp 2 at 2;
             tokens (8, 257), two steps, phase 34's parity gate with the
             card step held, as the CPU one, to twice the one-process card
             step's own gap to the CPU; B1 2 M x layers a stage and B2, B3
             M x layers a stage a step on every rank, 0 plain) and
             ``TRAIN_FLAGSHIP`` on pp 4 at M 4 (bf16, tokens (8, 1025), 2
             rows a microbatch, 2 layers a stage), one warm-up step
             (recorded as in (b)), one step timed tick by tick (each
             tick's stage compute and hand-off wait after a sync: the
             measured idle share against the bubble's (P - 1) / (M + P -
             1)), then two timed steps: step ms on each rank, collectives
             by kind with calls, ms and bytes (``pipeline_hop``,
             ``pipeline_dx``, ``pipeline_head``), bytes a rank against one
             device, peak memory; gates: 16 / 8 / 8 launches a step on
             every rank, 0 plain, M + 2P - 2 = 10 hops a step, losses
             falling, and the first step's loss and grad norm within
             ``TRAIN_SP_RTOL`` of the one-process step on the same params
             and tokens. ``train_pp`` sums the legs' seconds.

Then the kernel table as one JSON line (the five ported kernels and the
split walk's combine kernel; the three flash rows name their version, v3,
their kernel and its registers, and add their launches in phases 10a-10c;
the paged rows and the combine's add their launches in phases 15, 17, 19,
20, 22, 24, 25, 26, 27, 28, 29, 30, 31 and 32, each rank's in phase 33,
and the scoring step's timing,
the flash rows theirs in phase 31's train steps and each rank's in
phase 34's timed dense steps and phases 35's and 36's timed flagship
steps),
the ``nvidia-smi`` name and power limit, and
last ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout of the repository, it exits non-zero before any result."""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

FLAGSHIP = dict(vocab_size=32768, d_model=1024, n_layers=8, n_heads=8,
                d_head=128, d_ff=4096, n_kv_heads=2)
FP32_ATOL = 2e-5

#: The repository's training flagship (``bench.py``'s ``bench_train_mfu``):
#: MHA, trained at batch 8 on 1025-token rows (a 1024-token sequence).
TRAIN_FLAGSHIP = dict(vocab_size=32768, d_model=1024, n_layers=8, n_heads=8,
                      d_head=128, d_ff=4096)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
FLASH_FWD_ATOL, FLASH_BWD_ATOL = 2e-5, 5e-5


#: The script's start: each phase line carries its seconds since then.
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T0, 3)}),
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def import_port():
    """The port from THIS checkout: a copy installed elsewhere must not
    stand in for it."""
    sys.path.insert(0, str(HERE))
    import tpu_task_torch

    where = Path(tpu_task_torch.__file__).resolve().parent.parent
    if where != HERE:
        raise RuntimeError(
            f"tpu_task_torch imported from {where}, not from this checkout "
            f"({HERE})")


# -- paged-attention inputs and timing ----------------------------------------

def paged_case(gen, depths, *, w=1, h=8, kv=2, d=128, bs=16, max_blocks,
               dtype, device):
    """q, pools, tables, positions for rows at the given depths (None = an
    inactive row: position 0, every table entry the scratch block 0).
    Physical blocks are handed out in a shuffled order, so every row's
    table is fragmented."""
    need = [0 if x is None else (x + w - 1) // bs + 1 for x in depths]
    n_blocks = 1 + sum(need)
    perm = (torch.randperm(n_blocks - 1, generator=gen) + 1).to(torch.int32)
    tables = torch.zeros((len(depths), max_blocks), dtype=torch.int32)
    positions = torch.zeros((len(depths), w), dtype=torch.int32)
    used = 0
    for r, (depth, n) in enumerate(zip(depths, need)):
        if depth is None:
            continue
        tables[r, :n] = perm[used:used + n]
        used += n
        positions[r] = depth + torch.arange(w, dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    tensors = (randn(len(depths), w, h, d), randn(n_blocks, bs, kv, d),
               randn(n_blocks, bs, kv, d), tables, positions)
    return [t.to(device) for t in tensors]


class DeviceTimer:
    """Device time of one call, in ms: each timed launch follows a write of
    a 256 MB buffer (the 50 MB L2 starts cold, as it does for a layer's
    pool in serving), and a spin kernel holds the card while the host
    enqueues, so host overhead stays out of the events."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(50_000_000)
        for start, end in pairs:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def device_events(prof) -> list:
    """(name, start µs, end µs) of each device event a ``torch.profiler``
    run recorded."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def prime_tracer(device) -> None:
    """The first thing inside a ``torch.profiler`` trace that is read: a
    tracer started after others in the process may miss the kernels it is
    given first (seen on the H100: one kernel, and once the first five of
    a loop of wrapper calls). Short kernels, each waited for, and a pause
    take their place."""
    for _ in range(8):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()
    time.sleep(0.05)


def host_ms(fn, iters: int = 20) -> float:
    """Wall time per call of back-to-back calls, host overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# -- phases -------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke run "
                         "needs an NVIDIA card")
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32="off: torch.backends.cuda.matmul.allow_tf32 and "
              "torch.backends.cudnn.allow_tf32 are False, so fp32 products "
              "run in full fp32")
    return smi


def ptxas_report(output: str) -> dict:
    """ptxas's ``-v`` report as {kernel: "registers; stack and spills"},
    the kernel's mangled name cut to its name and template arguments."""
    report, name = {}, None
    for line in output.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
            name = re.sub(r"^_ZN\d+_GLOBAL__N_.*?_cu_[0-9a-f]{8}\d+", "",
                          name)
            name = name[:name.find("EEv") + 2] if "EEv" in name else name
            report[name] = ""
        elif name and "stack frame" in line:
            report[name] = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            report[name] = f"{regs.group(1) if regs else '?'} registers; " \
                           f"{report[name]}"
            name = None
    return report


def phase_build() -> None:
    from tpu_task_torch.ml.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as pool:
        list(pool.map(_build.load, _build.SIGNATURES))
    report = {name: ptxas_report(output)
              for name, output in _build.compiler_output.items()}
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(_build.SIGNATURES), ptxas=report)


def wgmma_build(name: str) -> dict:
    """{d: row} for each instantiation of the wgmma flash kernel ``name``
    ("flash_fwd", "flash_bwd_dq" or "flash_bwd_dkv") in the library's
    ptxas report: registers, stack and spill bytes, its dynamic shared
    memory and the CTAs that fit one SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from tpu_task_torch.ml.ops import _build
    from tpu_task_torch.ml.ops import attention as fa

    kernel = name.rsplit("_", 1)[-1]             # fwd, dq or dkv
    output = _build.compiler_output.get("flash_attention", "")
    rows = {}
    for found_name, text in ptxas_report(output).items():
        found = re.search(name + r"_wgmma_kernelILi(\d+)E", found_name)
        if not found:
            continue
        d = int(found.group(1))
        row = {}
        for key, pattern in (("registers", r"(\d+) registers"),
                             ("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill st"),
                             ("spill_load_bytes", r"(\d+) bytes spill lo")):
            value = re.search(pattern, text)
            row[key] = int(value.group(1)) if value else None
        row.update(smem_bytes=fa.wgmma_smem_bytes(kernel, d),
                   ctas_per_sm=fa.wgmma_ctas_per_sm(kernel, d))
        rows[d] = row
    return rows


def build_ok(rows: dict) -> bool:
    """Both head dims built, no spill, at least one CTA an SM."""
    return sorted(rows) == [64, 128] and all(
        row["spill_store_bytes"] == 0 and row["spill_load_bytes"] == 0
        and row["ctas_per_sm"] >= 1 for row in rows.values())


def ptxas_warnings() -> list:
    from tpu_task_torch.ml.ops import _build

    return [line.strip() for line in
            _build.compiler_output.get("flash_attention", "").splitlines()
            if "warning" in line.lower()]


def phase_flash_fwd_build() -> dict:
    """The wgmma forward's instantiations (d 64 and 128) by
    ``wgmma_build``, with every ptxas warning of the library. Fails on a
    spill or on an instantiation that fits no SM."""
    kernels = wgmma_build("flash_fwd")
    ok = build_ok(kernels)
    emit("flash_fwd_build", ok=ok, kernel="flash_fwd_wgmma_kernel (B1 v3)",
         threads=384, registers_note="ptxas's count is the launch's; "
         "setmaxnreg then gives the producer warpgroup 40 and the two "
         "consumers 232", by_head_dim={str(d): kernels[d]
                                       for d in sorted(kernels)},
         ptxas_warnings=ptxas_warnings())
    if not ok:
        raise AssertionError(f"the wgmma forward's build failed its gates: "
                             f"{kernels}")
    return kernels


def phase_flash_bwd_build() -> dict:
    """The same for the wgmma backward's four instantiations (dq and dk/dv
    at d 64 and 128); returns {"flash_bwd_dq": rows, "flash_bwd_dkv":
    rows}. Fails on a spill or on an instantiation that fits no SM."""
    kernels = {name: wgmma_build(name)
               for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    ok = all(build_ok(rows) for rows in kernels.values())
    emit("flash_bwd_build", ok=ok,
         kernels="flash_bwd_dq_wgmma_kernel (B2 v3), "
                 "flash_bwd_dkv_wgmma_kernel (B3 v3)",
         threads=384, registers_note="ptxas's count is the launch's; "
         "setmaxnreg then gives the producer warpgroup 24 and the two "
         "consumers 240",
         by_kernel={name: {str(d): rows[d] for d in sorted(rows)}
                    for name, rows in kernels.items()},
         ptxas_warnings=ptxas_warnings())
    if not ok:
        raise AssertionError(f"the wgmma backward's build failed its "
                             f"gates: {kernels}")
    return kernels


def against_fp32_plain(got, args) -> dict:
    """Hold a bf16 kernel output to the plain version run in fp32 on the
    same bf16 values. The kernel works in fp32 and rounds only its output
    to bf16, so each element must lie within half an ulp (2^-8 relative)
    of that, plus 1e-5 for fp32 summation order."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q = args[0]
    pools = [p.float() if p.dtype == q.dtype else p for p in args[1:3]]
    exact = pa.paged_reference_attention(q.float(), *pools, *args[3:])
    err = (got.float() - exact).abs()
    excess = (err - 2.0 ** -8 * exact.abs() - 1e-5).max().item()
    return dict(ok=excess <= 0, max_abs_err_vs_fp32=err.max().item(),
                tolerance_vs_fp32="2^-8*|ref| + 1e-5: the output's bf16 "
                                  "rounding")


def guarded_launch(args, want, pipelined: bool = False) -> bool:
    """Launch a paged kernel (uncounted) into the middle of a NaN-filled
    buffer: True if it wrote exactly ``want`` there and nothing on either
    side. ``args`` are the wrapper's, scales last when given."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q, n, pad = args[0], args[0].numel(), 1 << 18
    buf = torch.full((n + 2 * pad,), float("nan"), dtype=q.dtype,
                     device=q.device)
    out = buf[pad:pad + n].view(q.shape)
    pa._launch(*args[:5], out, *args[5:], pipelined=pipelined)
    torch.cuda.synchronize()
    return bool(torch.isnan(buf[:pad]).all() and torch.isnan(buf[-pad:]).all()
                and torch.equal(out, want))


def close_to(got, ref, dtype) -> bool:
    """fp32 within FP32_ATOL of ``ref``; bf16 within its output's rounding
    (2^-8 relative) of ``ref`` plus 1e-5 for fp32 summation order."""
    err = (got.float() - ref).abs()
    if dtype == torch.float32:
        return err.max().item() <= FP32_ATOL
    return bool((err <= 2.0 ** -8 * ref.abs() + 1e-5).all())


def forced_splits(args, pipelined: bool = False) -> list:
    """The split counts a paged kernel is held at: 1, 2, its plan for these
    shapes on this card, and one per tile (stage)."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q, k_pool, tables = args[0], args[1], args[3]
    tiles = pa.n_tiles(tables.shape[1], k_pool.shape[1])
    plan = pa.planned_splits(q, k_pool, tables.shape[1], pipelined=pipelined)
    return sorted({1, min(2, tiles), plan, tiles})


def partial_state_err(got, ref) -> float:
    """How far the kernel's split states are from the plain ones: m
    relative to max(1, |m|), l relative to l, acc relative to l (the scale
    of the output it divides into). Infinite where a state is empty in one
    and not exactly the empty state (m the mask value, l and acc 0) in the
    other."""
    from tpu_task_torch.ml.ops.attention import NEG_INF

    m, l, acc = ref[..., 0], ref[..., 1], ref[..., 2:]
    empty = m <= NEG_INF / 2
    if not torch.equal(empty, got[..., 0] <= NEG_INF / 2) \
            or (got[..., 1:][empty] != 0).any():
        return math.inf
    live = ~empty
    if not live.any():
        return 0.0
    dm = ((got[..., 0] - m).abs() / m.abs().clamp(min=1.0))[live].max()
    dl = ((got[..., 1] - l).abs() / l)[live].max()
    dacc = ((got[..., 2:] - acc).abs() / l[..., None])[live].max()
    return max(dm.item(), dl.item(), dacc.item())


def check_splits(args, pipelined: bool = False) -> dict:
    """A paged kernel (the tile kernel, or the pipelined one) at every
    count of ``forced_splits``, launched
    uncounted into the middle of a NaN-filled buffer with NaN-filled split
    states: its output against the merge of the plain split states
    (``combine_partials(paged_split_partials(...))``, fp32 on the same
    values) and against the plain version, at ``close_to``'s gate; its
    split states against ``paged_split_partials`` (``partial_state_err``
    within FP32_ATOL); the combine kernel alone on the plain states against
    ``combine_partials``; nothing written beside the output, no NaN left in
    it or in the states, the inputs unchanged. Raises on any disagreement;
    returns the split counts and the worst errors."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q = args[0]
    rows, w, h, d = q.shape
    before = [a.clone() for a in args]
    wide = [q.float()] + [p.float() if p.dtype == q.dtype else p
                          for p in args[1:3]] + list(args[3:])
    exact = pa.paged_reference_attention(*wide)
    name = "paged_decode_pipelined" if pipelined else "paged_decode"
    result = dict(splits=forced_splits(args, pipelined),
                  split_max_abs_err=0.0,
                  split_states_max_rel_err=0.0, combine_max_abs_err=0.0)
    for splits in result["splits"]:
        plain = pa.paged_split_partials(*args, splits=splits)
        merged = pa.combine_partials(plain)
        n, pad = q.numel(), 1 << 16
        buf = torch.full((n + 2 * pad,), float("nan"), dtype=q.dtype,
                         device=q.device)
        out = buf[pad:pad + n].view(q.shape)
        states = (torch.full((rows, w, h, splits, pa.PARTIAL_HEAD + d),
                             float("nan"), device=q.device)
                  if splits > 1 else None)
        pa._launch(*args[:5], out, *args[5:], pipelined=pipelined,
                   splits=splits, partials=states)
        torch.cuda.synchronize()
        ok = bool(torch.isnan(buf[:pad]).all() and torch.isnan(buf[-pad:]).all()
                  and not torch.isnan(out).any()
                  and close_to(out, merged, q.dtype)
                  and close_to(out, exact, q.dtype))
        err = (out.float() - merged).abs().max().item()
        result["split_max_abs_err"] = max(result["split_max_abs_err"], err)
        if splits > 1:
            state_err = partial_state_err(states, plain)
            alone = torch.empty_like(q)
            pa._launch_combine(plain, alone, pipelined=pipelined)
            torch.cuda.synchronize()
            want = pa.combine_partials(plain)
            ok = ok and state_err <= FP32_ATOL \
                and close_to(alone, want, q.dtype)
            result["split_states_max_rel_err"] = max(
                result["split_states_max_rel_err"], state_err)
            result["combine_max_abs_err"] = max(
                result["combine_max_abs_err"],
                (alone.float() - want).abs().max().item())
        if not ok:
            raise AssertionError(
                f"{name} at {splits} splits disagrees or writes outside its "
                f"output: {result}, this count's error {err}")
    if not all(same_bytes(a, b) for a, b in zip(before, args)):
        raise AssertionError(f"{name} at forced splits changed its inputs")
    return result


#: Draft tokens a speculative round proposes in the bf16 spec run (through
#: the tile kernel) and in the int8 one (through the pipelined kernel,
#: whose tensor-core path takes at most 16 query rows a CTA: w x group 4).
SPEC_K, SPEC_K_QUANT = 4, 3

#: (what the case stands for, rows, w, deepest position + w, max_blocks).
#: The last four are the flagship serve runs' shapes: the 16-row decode
#: step, the 144-row token-packed chunk step, and the 16-row speculative
#: scoring steps at w 5 and 4, tables of max_len 1152 / 16.
KERNEL_CASES = (("deep", 24, 1, 2048, 128), ("deep", 24, 3, 2048, 128),
                ("decode step", 16, 1, 1152, 72),
                ("chunk step", 144, 1, 1152, 72),
                ("spec scoring", 16, SPEC_K + 1, 1152, 72),
                ("spec scoring", 16, SPEC_K_QUANT + 1, 1152, 72))


def phase_kernel(device) -> tuple:
    """Kernel vs plain version, through the wrapper (its planned splits)
    and at forced split counts (``check_splits``); returns the largest
    error against the plain version run at the kernel's own dtype and the
    combine kernel's largest error against its plain version."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    worst = combine_worst = 0.0
    for case, rows, w, depth, max_blocks in KERNEL_CASES:
        depths = [None if r % 6 == 5 else int(rng.integers(0, depth - w))
                  for r in range(rows)]
        depths[0] = depth - w                     # the deepest row
        for dtype in (torch.float32, torch.bfloat16):
            args = paged_case(gen, depths, w=w, max_blocks=max_blocks,
                              dtype=dtype, device=device)
            before = [a.clone() for a in args]
            got = pa.paged_decode_attention(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(before, args)):
                raise AssertionError("paged_decode changed its inputs")
            guarded = guarded_launch(args, got)
            same = pa.paged_reference_attention(*args)
            err = (got.float() - same.float()).abs().max().item()
            split = check_splits(args)
            worst = max(worst, err, split["split_max_abs_err"]
                        if dtype == torch.float32 else 0.0)
            combine_worst = max(combine_worst, split["combine_max_abs_err"]
                                if dtype == torch.float32 else 0.0)
            line = dict(case=case, w=w, dtype=str(dtype).replace("torch.", ""),
                        rows=rows, max_blocks=max_blocks,
                        inactive_rows=depths.count(None), max_abs_err=err,
                        writes_only_out_and_repeats=guarded,
                        planned_splits=pa.planned_splits(args[0], args[1],
                                                         max_blocks),
                        **split)
            if dtype == torch.float32:
                ok = err <= FP32_ATOL
                line["tolerance"] = (f"{FP32_ATOL}: fp32 sums in another "
                                     "order")
            else:
                line.update(against_fp32_plain(got, args))
                # The plain bf16 version rounds scores and probabilities to
                # 8 bits too, so against it the gate is bf16's resolution
                # at the unit-scale values these inputs give.
                ok = line.pop("ok") and err <= 2e-2
                line["tolerance"] = "vs bf16 plain: 2e-2, its bf16 " \
                                    "probabilities"
            ok = ok and guarded
            emit("kernel", ok=ok, **line)
            if not ok:
                raise AssertionError(f"paged_decode disagrees: {line}")
    return worst, combine_worst


#: Rows of the timed paged shapes, tables 72 wide (the flagship engine's
#: max_len 1152 / block 16): batch 1, 16 and 32 at depth 1024, and the
#: serve run's 144-row token-packed chunk step at ragged depths up to 1151.
TIMED_ROWS = (1, 16, 32, 144)
CHUNK_ROWS = 144


def timed_case(gen, rng, rows: int, kv_dtype, device) -> tuple:
    """bf16-query inputs at one timed shape (flagship geometry), SDPA over
    the gathered live view (dequantized to bf16 ahead of time for a
    quantized pool; masked where depths are ragged) as ``library``, and the
    bytes and flops the function needs: each visible token's K and V row
    once in its storage type, the live blocks' scales and table entries, q
    in and out, the positions."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import flat_pool, gather_kv

    F = torch.nn.functional
    bs, h, kv, d = 16, 8, 2, 128
    depths = ([1151] + [int(x) for x in rng.integers(0, 1152, rows - 1)]
              if rows == CHUNK_ROWS else [1023] * rows)
    args = quant_args(gen, depths, w=1, h=h, kv=kv, d=d, bs=bs, max_blocks=72,
                      q_dtype=torch.bfloat16, kv_dtype=kv_dtype, device=device)
    q, kp, vp, tables, pos = args[:5]
    live = tables[:, :max(depths) // bs + 1]
    if kv_dtype is None:
        kd, vd = (gather_kv(flat_pool(p), live, bs) for p in (kp, vp))
    else:
        kd, vd = (pa.dequantize_view(
            gather_kv(flat_pool(p.view(torch.uint8)), live, bs)
            .view(p.dtype), s, live, bs, torch.bfloat16)
            for p, s in ((kp, args[5]), (vp, args[6])))
    kd, vd = (t.transpose(1, 2).contiguous() for t in (kd, vd))
    qd = q.transpose(1, 2).contiguous()              # (b, h, 1, d)
    if len(set(depths)) == 1:
        def library():
            return F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True)
    else:
        kd, vd = (t.repeat_interleave(h // kv, dim=1) for t in (kd, vd))
        mask = (torch.arange(kd.shape[2], device=device)
                <= pos[:, :, None])[:, None]          # (b, 1, 1, L)

        def library():
            return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
    tokens = sum(x + 1 for x in depths)
    blocks = sum(x // bs + 1 for x in depths)
    n_bytes = (tokens * kv * kp.shape[-1] * kp.element_size() * 2
               + (blocks * kv * 4 * 2 if kv_dtype else 0)
               + 2 * q.numel() * q.element_size() + blocks * 4
               + pos.numel() * 4)
    return args, library, n_bytes, 4 * h * d * tokens


def bound(n_bytes: int, flops: int) -> dict:
    by_bytes, by_flops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return dict(bound_ms=max(by_bytes, by_flops) * 1e3,
                bound_by="bytes" if by_bytes >= by_flops else "operations",
                bytes=n_bytes, flops=flops)


def unsplit_ms(timer, args, pipelined: bool = False) -> float:
    """A paged kernel's device ms with each row's walk left whole: one
    split, one CTA per row and kv head, the grid before split-KV; launched
    uncounted."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    out = torch.empty_like(args[0])
    return timer(lambda: pa._launch(*args[:5], out, *args[5:],
                                    pipelined=pipelined, splits=1))


def shape_name(rows: int) -> str:
    return "chunk step" if rows == CHUNK_ROWS else f"batch {rows}"


def phase_timing(device, smi: str) -> dict:
    """Kernel, plain and SDPA times at the flagship decode shapes and the
    serve run's chunk step, the split plan and CTAs beside each; then, at
    batch 16, wrapper calls traced apart into the split walk and the
    combine, and the combine kernel alone. Returns {rows: row, "combine":
    row}."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    timer = DeviceTimer(device)
    gen = torch.Generator().manual_seed(2)
    rng = np.random.default_rng(2)
    rows_out = {}
    for rows in TIMED_ROWS:
        args, library, n_bytes, flops = timed_case(gen, rng, rows, None,
                                                   device)
        q = args[0]

        def kernel():
            return pa.paged_decode_attention(*args)

        def plain():
            return pa.paged_reference_attention(*args)

        got = kernel()
        check = against_fp32_plain(got, args)
        lib_err = (library().transpose(1, 2).float()
                   - got.float()).abs().max().item()
        if not check.pop("ok") or lib_err > 2e-2:
            raise AssertionError(f"kernel or SDPA yardstick disagrees at "
                                 f"{shape_name(rows)}: {check}, SDPA "
                                 f"{lib_err}")
        splits = pa.planned_splits(q, args[1], args[3].shape[1])
        row = dict(shape=shape_name(rows), batch=rows,
                   depth="ragged up to 1151" if rows == CHUNK_ROWS else 1024,
                   dtype="bfloat16", splits=splits,
                   ctas=rows * args[1].shape[2] * splits,
                   ms=timer(kernel), unsplit_ms=unsplit_ms(timer, args),
                   plain_ms=timer(plain), library_ms=timer(library),
                   **bound(n_bytes, flops),
                   host_ms=host_ms(kernel), plain_host_ms=host_ms(plain),
                   library_max_abs_diff=lib_err, **check, gpu=smi)
        row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
        emit("timing", **row)
        rows_out[rows] = row
        if rows == 16:
            profile_wrapper(timer, kernel, row, smi)
            rows_out["combine"] = time_combine(timer, args, splits, smi)
    return rows_out


def profile_wrapper(timer, kernel, row: dict, smi: str, iters: int = 20,
                    name: str = "paged_decode", warm: int = 2) -> None:
    """``iters`` wrapper calls under ``torch.profiler``, the L2 flushed
    before each as ``DeviceTimer`` does: each call must launch one split
    walk of kernel ``name``, and one combine after it when ``row``'s plan
    splits; prints the mean device ms of each and of the span from the
    walk's start to the combine's end (the gap between the two launches
    included). The trace starts with ``prime_tracer`` and ``warm`` more
    calls that are not read, then reads the last ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    kernel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime_tracer(timer.flush.device)
        for _ in range(warm + iters):
            timer.flush.zero_()
            kernel()
        torch.cuda.synchronize()
    events = sorted((start, end, name)
                    for name, start, end in device_events(prof))
    walk_names = {"paged_decode": ("paged_decode_kernel",),
                  "paged_decode_pipelined": (
                      "paged_decode_pipelined_kernel",
                      "paged_decode_pipelined_mma_kernel")}[name]
    walks = [(s, e) for s, e, ev in events
             if any(w in ev for w in walk_names)]
    combines = [(s, e) for s, e, ev in events
                if "combine_splits_kernel" in ev]
    split = row["splits"] > 1
    seen = (len(walks), len(combines))
    walks, combines = walks[-iters:], combines[-iters:] if split else []
    paired = all(w_end <= c_start and (i + 1 == iters
                                       or c_end <= walks[i + 1][0])
                 for i, ((_, w_end), (c_start, c_end))
                 in enumerate(zip(walks, combines)))
    if not (iters <= seen[0] <= iters + warm and len(walks) == iters
            and seen[1] <= (iters + warm if split else 0)
            and len(combines) == (iters if split else 0) and paired):
        raise AssertionError(
            f"{iters + warm} traced wrapper calls at {row['splits']} splits "
            f"showed {seen[0]} split walks and {seen[1]} combines"
            f"{'' if paired else ', not each combine after its walk'}")
    walk_ms = float(np.mean([e - s for s, e in walks])) / 1e3
    combine_ms = (float(np.mean([e - s for s, e in combines])) / 1e3
                  if combines else 0.0)
    ends = [e for _, e in (combines or walks)]
    span_ms = float(np.mean([e - s for (s, _), e in zip(walks, ends)])) / 1e3
    emit("timing_profile", kernel=name, storage=row.get("storage"),
         batch=row["batch"],
         splits=row["splits"], calls=iters, walk_ms=walk_ms,
         combine_ms=combine_ms, span_ms=span_ms,
         gap_ms=span_ms - walk_ms - combine_ms,
         combine_share_of_span=combine_ms / span_ms,
         timed_ms=row["ms"], gpu=smi)


def time_combine(timer, args, splits: int, smi: str) -> dict:
    """The combine kernel alone on the plain split states of ``args`` at
    ``splits``, against ``combine_partials`` in the same type; its bound
    reads the states once and writes the output once."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    q = args[0]
    states = pa.paged_split_partials(*args, splits=splits)
    out = torch.empty_like(q)

    def kernel():
        pa._launch_combine(states, out)

    def plain():
        return pa.combine_partials(states, q.dtype)

    kernel()
    want = pa.combine_partials(states)
    if not close_to(out, want, q.dtype):
        raise AssertionError("the combine kernel disagrees with "
                             "combine_partials")
    row = dict(kernel="paged_decode_combine", batch=q.shape[0],
               splits=splits, output_rows=q.numel() // q.shape[-1],
               max_abs_err=(out.float() - want).abs().max().item(),
               ms=timer(kernel), plain_ms=timer(plain), library_ms=None,
               **bound(states.numel() * 4 + out.numel() * out.element_size(),
                       0), gpu=smi)
    row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
    emit("timing_combine", **row)
    return row


def _parity_waves(vocab: int, bs: int):
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, vocab, size=n).astype(np.int32)
          for n in (3, 21, 9, 1, 3 * bs + 2, 6)]
    first = [(ps[0], 9, {}), (ps[1], 6, {}), (ps[2], 8, {}),
             (ps[3], 7, {"temperature": 0.8, "top_p": 0.9, "key": [7, 9]}),
             (ps[4], 8, {}), (ps[5], 10, {"temperature": 1.1})]
    shared = np.concatenate([ps[4][:2 * bs], ps[0]])
    second = [(shared, 6, {}), (ps[4][:3 * bs], 4, {}), (ps[1], 5, {})]
    return [first, second]


def phase_parity(device) -> None:
    from tpu_task_torch.ml.models.decoding import generate
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.serve.replica import build_engine

    for preset, small in (("micro", 14), ("tiny", 8)):
        for n_blocks in (None, small):
            outs, stats = {}, {}
            for impl in ("cuda", "reference"):
                serving = {"decode_impl": impl}
                if n_blocks:
                    serving["n_blocks"] = n_blocks
                engine = build_engine(preset, serving=serving, device=device)
                waves = _parity_waves(engine.cfg.vocab_size,
                                      engine.scfg.block_size)
                before = pa.paged_decode_attention.launches
                for wave in waves:
                    for prompt, max_new, kw in wave:
                        engine.submit(prompt, max_new, **kw)
                    outs[impl] = engine.drain(max_steps=5000)
                stats[impl] = engine.stats()
                fused = engine.chunk_steps + engine.decode_steps
                launched = pa.paged_decode_attention.launches - before
                want = engine.cfg.n_layers * fused if impl == "cuda" else 0
                if launched != want or stats[impl]["decode_impl"] != impl:
                    raise AssertionError(
                        f"{preset}/{impl}: {launched} kernel launches, "
                        f"expected {want}")
            if outs["cuda"] != outs["reference"]:
                raise AssertionError(f"{preset}: kernel and plain streams "
                                     "differ")
            greedy = [(rid, prompt, max_new) for rid, (prompt, max_new, kw)
                      in enumerate(w for wave in waves for w in wave)
                      if not kw]
            for rid, prompt, max_new in greedy:
                ref = generate(engine.params, engine.cfg, prompt[None],
                               max_new, device=device)[0].tolist()
                if outs["cuda"][rid] != ref:
                    raise AssertionError(
                        f"{preset}: request {rid} differs from generate")
            s = stats["cuda"]
            pressure = s["recompute_preemptions"] if n_blocks else None
            if n_blocks and not pressure:
                raise AssertionError(f"{preset}: the small pool never "
                                     "preempted")
            if not n_blocks and not s["prefix_cache"]["hit_requests"]:
                raise AssertionError(f"{preset}: no prefix-cache hit")
            emit("parity", ok=True, preset=preset, n_blocks=n_blocks
                 or engine.scfg.n_blocks, requests=len(outs["cuda"]),
                 greedy_vs_generate=len(greedy),
                 preemptions=s["recompute_preemptions"],
                 prefix_hit_requests=s["prefix_cache"]["hit_requests"],
                 cow_copies=s["prefix_cache"]["cow_copies"],
                 chunk_steps=s["chunk_steps"], decode_steps=s["decode_steps"])


class StepRecorder:
    """Stands in for the serving model's ``paged_attention``: passes every
    call through and, while ``armed``, keeps copies of layer 0's inputs and
    output in the first decode step and in the last chunk step, so the
    kernel's work in the run can be held against the plain version after
    it. ``calls`` counts from a step boundary."""

    def __init__(self, fn, n_layers: int, slots: int):
        self.fn, self.n_layers, self.slots = fn, n_layers, slots
        self.calls, self.armed, self.steps = 0, False, {}

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        layer = self.calls % self.n_layers
        self.calls += 1
        if self.armed and layer == 0:
            kind = ("decode step" if args[0].shape[0] == self.slots
                    else "chunk step")
            if kind == "chunk step" or kind not in self.steps:
                self.steps[kind] = ([a.clone() for a in args], out.clone())
        return out


def _wave_requests(vocab: int, seed: int):
    """The serve wave's 16 requests as (prompt, sampling kwargs): 256-1024
    prompt tokens, 12 greedy, 4 sampled at temperature 0.8 / top_p 0.9
    with raw keys."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(256, 1025, size=16)
    wave = []
    for i, n in enumerate(lengths):
        prompt = rng.integers(0, vocab, size=int(n))
        kw = ({"temperature": 0.8, "top_p": 0.9,
               "key": np.array([1000 + 100 * seed + i, i], np.uint32)}
              if i % 4 == 3 else {})
        wave.append((prompt, kw))
    return wave


def _submit_wave(engine, seed: int, max_new: int = 64,
                 requests: int = 16):
    """The serve wave (``_wave_requests``), its first ``requests``, with
    ``max_new`` new tokens."""
    wave = _wave_requests(engine.cfg.vocab_size, seed)[:requests]
    rids = [engine.submit(prompt, max_new, **kw) for prompt, kw in wave]
    return rids, sum(len(prompt) for prompt, _ in wave)


def _timed_drain(engine, seed: int, max_new: int = 64,
                 step_range=contextlib.nullcontext, load=None) -> dict:
    """One wave through the engine, its launch counts and goodput meter set
    to 0 just before and read just after; ``step_range()`` wraps each step
    (a profiler range). ``load()`` puts the wave in the queue and returns
    (its ids, its prompt tokens): ``_submit_wave`` by default, a resume of
    exported records in phase 22. ``kernel_launches`` counts the kernel
    the engine resolved (``decode_impl``); ``other_kernel_launches`` the
    other one. A micro-step (``micro_k`` > 1) makes ``micro_k``
    decode-shape calls a layer, a retired slot's masked iterations
    included. ``step_kinds`` says which steps were chunk steps ("c") and
    which decode or micro steps ("d"), in order; ``all_next_token_ms``
    and ``all_next_token_chunk_steps`` are the wall and chunk steps until
    every request of the wave had emitted a token in this engine."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    engine.goodput.reset()
    rids, prompt_tokens = (load or (
        lambda: _submit_wave(engine, seed, max_new)))()
    chunk0, decode0 = engine.chunk_steps, engine.decode_steps
    micro0, preempt0 = engine.micro_steps, engine.preemption_count
    captures0 = engine.stats()["step_graph"]["captures"]
    decode_ms, chunk_ms, kinds = [], [], []
    decode_tokens = 0
    waiting = [engine.request(rid) for rid in rids]
    next_token_ms = next_token_chunks = None
    pa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work:
        chunks, s0 = engine.chunk_steps, time.perf_counter()
        emitted = engine.goodput.tokens_emitted
        with step_range():
            engine.step()
        chunk = engine.chunk_steps > chunks
        (chunk_ms if chunk else decode_ms).append(
            (time.perf_counter() - s0) * 1e3)
        kinds.append("c" if chunk else "d")
        if not chunk:
            decode_tokens += engine.goodput.tokens_emitted - emitted
        waiting = [r for r in waiting if len(r.tokens) <= r.resume_from]
        if not waiting and next_token_ms is None:
            next_token_ms = (time.perf_counter() - t0) * 1e3
            next_token_chunks = engine.chunk_steps - chunk0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = {"cuda": pa.paged_decode_attention,
               "pipelined": pa.paged_decode_pipelined_attention}
    kernel = kernels.pop(engine.decode_impl)
    launches, combines = kernel.launches, kernel.combine_launches
    other = sum(fn.launches + fn.combine_launches for fn in kernels.values())
    plain = pa.paged_reference_attention.launches
    plans = step_splits(engine)
    results = [engine.request(rid) for rid in rids]
    # tokens this engine generated (a resumed prefix was generated before)
    generated = sum(len(r.tokens) - r.resume_from for r in results)
    chunk_steps = engine.chunk_steps - chunk0
    micro_steps = engine.micro_steps - micro0
    # decode-shape calls a layer: one a plain decode step, K a micro-step
    decode_calls = (engine.decode_steps - decode0 - micro_steps
                    + engine.scfg.micro_k * micro_steps)
    goodput = engine.stats()["goodput"]
    return dict(
        seed=seed, requests=len(results), prompt_tokens=prompt_tokens,
        generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        prompt_and_generated_tokens_per_s=(generated + prompt_tokens) / wall,
        decode_steps=engine.decode_steps - decode0,
        chunk_steps=chunk_steps, micro_k=engine.scfg.micro_k,
        micro_steps=micro_steps,
        mean_decode_step_ms=float(np.mean(decode_ms)) if decode_ms else None,
        mean_chunk_step_ms=float(np.mean(chunk_ms)),
        # the tokens of the decode (or micro-) steps over their wall
        decode_phase_tokens=decode_tokens,
        decode_phase_tokens_per_s=(decode_tokens / sum(decode_ms) * 1e3
                                   if decode_ms else None),
        kernel=engine.decode_impl, kernel_launches=launches,
        other_kernel_launches=other, plain_launches=plain,
        expected_launches=engine.cfg.n_layers * (chunk_steps + decode_calls),
        step_splits=plans, combine_launches=combines,
        expected_combine_launches=engine.cfg.n_layers * (
            decode_calls * (plans["decode"] > 1)
            + chunk_steps * (plans["chunk"] > 1)),
        all_finished=all(r.status == "done" and len(r.tokens) == max_new
                         for r in results),
        preemptions=engine.preemption_count - preempt0,
        host_gap_frac=goodput["host_gap_frac"],
        dispatches_per_token=goodput["dispatches_per_token"],
        goodput_tokens=goodput["tokens"],
        graph_captures=engine.stats()["step_graph"]["captures"] - captures0,
        all_next_token_ms=next_token_ms,
        all_next_token_chunk_steps=next_token_chunks,
        rids=rids, step_kinds="".join(kinds))


def step_splits(engine) -> dict:
    """The split plan of the engine's kernel at its decode and chunk
    steps (on each rank of a gang: every rank's block has the same
    shape)."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    cfg, scfg = engine.cfg, engine.scfg
    pool = engine.pools[0]["k"]
    plans = {}
    for step, rows in (("decode", scfg.slots),
                       ("chunk", scfg.slots + scfg.chunk_tokens)):
        # A gang's rank holds n_heads / tp query heads over its kv heads.
        q = torch.empty((rows, 1, cfg.n_heads // engine.tp, cfg.d_head),
                        dtype=cfg.dtype, device=pool.device)
        plans[step] = pa.planned_splits(
            q, pool, scfg.max_blocks_per_slot,
            pipelined=engine.decode_impl == "pipelined")
    return plans


#: The flagship serve engine's configuration (phases 6 and 14).
SERVE_KNOBS = dict(slots=16, block_size=16, chunk_tokens=128, max_len=1152,
                   n_blocks=16 * 72 + 1)


def flagship_model(device):
    from tpu_task_torch.ml.models import transformer

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    params = transformer.init(
        torch.Generator(device=device).manual_seed(0), cfg)
    return cfg, params


def warm_up(engine) -> None:
    """bf16 GEMMs at the chunk and decode row counts, both samplers, the
    allocator's growth and, at ``micro_k`` > 1, the capture of both
    K-step graphs (a decode step with a sampled request, then one with a
    greedy request alone), outside the timed waves."""
    rng = np.random.default_rng(99)
    vocab = engine.cfg.vocab_size
    engine.submit(rng.integers(0, vocab, size=300), 4)
    engine.submit(rng.integers(0, vocab, size=200), 4, temperature=0.8,
                  top_p=0.9, key=np.array([5, 6], np.uint32))
    engine.drain()
    engine.submit(rng.integers(0, vocab, size=100), 4)
    engine.drain()


def serve_flagship(device, smi: str, phase: str, **serving) -> tuple:
    """A flagship engine with ``serving`` over SERVE_KNOBS: a warm-up wave,
    then three timed waves of fresh prompts, gated. Returns (the engine,
    its kernel's launch count over the timed waves, the phase line, each
    wave's streams by seed, each wave's ``_timed_drain`` result)."""
    from tpu_task_torch.ml.serving import model as serving_model
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg, params = flagship_model(device)
    n_params = sum(p.numel() for p in params.values() if torch.is_tensor(p))
    n_params += sum(p.numel() for layer in params["layers"]
                    for p in layer.values())
    scfg = ServingConfig(**SERVE_KNOBS, **serving)
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(params, cfg, scfg, device=device)
    warm_up(engine)

    # Every fused step's logits must be finite: checked on the card, with
    # no host sync, by wrapping the step the engine's samplers call.
    finite = torch.ones((), dtype=torch.bool, device=device)
    step_fn, attn_fn = serving_model.paged_decode_step, \
        serving_model.paged_attention
    recorder = StepRecorder(attn_fn, cfg.n_layers, scfg.slots)

    def checked_step(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        logits = out[0] if isinstance(out, tuple) else out
        finite.logical_and_(torch.isfinite(logits).all())
        return out

    serving_model.paged_decode_step = checked_step
    serving_model.paged_attention = recorder
    runs, streams = [], {}
    try:
        for seed in range(3):
            recorder.armed = seed == 0
            runs.append(_timed_drain(engine, seed))
            streams[seed] = [engine.request(rid).tokens
                             for rid in runs[-1]["rids"]]
    finally:
        serving_model.paged_decode_step = step_fn
        serving_model.paged_attention = attn_fn
    for run in runs:
        emit(f"{phase}_wave", **run, gpu=smi)

    # The kernel's output in the run against the plain version.
    steps_ok = True
    for kind, (args, out) in sorted(recorder.steps.items()):
        pos = args[4]
        check = against_fp32_plain(out, args)
        steps_ok = steps_ok and check["ok"]
        emit(f"{phase}_step_check", step=kind, layer=0,
             rows=int(pos.shape[0]), deepest_position=int(pos.max()), **check)
    checked = sorted(recorder.steps)
    recorder.steps.clear()               # its copies stay out of later peaks
    launches = sum(r["kernel_launches"] for r in runs)
    line = dict(
        params=n_params, waves=len(runs), kv_dtype=scfg.kv_dtype or "bfloat16",
        decode_impl=engine.decode_impl,
        tokens_per_s_median=float(np.median(
            [r["tokens_per_s"] for r in runs])),
        tokens_per_s_runs=[r["tokens_per_s"] for r in runs],
        mean_decode_step_ms_median=float(np.median(
            [r["mean_decode_step_ms"] for r in runs])),
        mean_chunk_step_ms_median=float(np.median(
            [r["mean_chunk_step_ms"] for r in runs])),
        kernel_launches=launches,
        other_kernel_launches=sum(r["other_kernel_launches"] for r in runs),
        plain_launches=sum(r["plain_launches"] for r in runs),
        step_splits=runs[0]["step_splits"],
        combine_launches=sum(r["combine_launches"] for r in runs),
        kv_pool_bytes=engine.stats()["kv_pool_bytes"],
        steps_checked=checked, logits_finite=bool(finite),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    emit(phase, **line)
    if not (bool(finite) and steps_ok and len(checked) == 2
            and all(wave_ok(r) for r in runs)):
        raise AssertionError(f"flagship serving run ({phase}) failed its "
                             f"gates: {line}")
    return engine, launches, line, streams, runs


def phase_serve(device, smi: str, bucket: str) -> tuple:
    """The main path: the flagship with bf16 pools through the tile
    kernel; then the engine publishes its hot blocks into ``bucket`` for
    phase 24. Returns the kernel's and the combine kernel's launch counts
    over the timed waves, the waves' streams by seed, the publisher's
    numbers (``publish_hot``), the waves' median tokens/s and the seed-2
    wave's ``_timed_drain`` result (phase 28 holds its launches)."""
    engine, launches, line, streams, runs = serve_flagship(device, smi,
                                                           "serve")
    published = publish_hot(engine, bucket, "serve", runs[KVFLEET_SEED])
    return (launches, line["combine_launches"], streams, published,
            line["tokens_per_s_median"], runs[KVFLEET_SEED])


def phase_serve_quant(device, smi: str, bucket: str) -> tuple:
    """The quantized path: the flagship with int8 pools through the
    pipelined kernel (three timed waves; then the engine publishes its hot
    blocks into ``bucket``), then one shorter wave each of fp8 and int4
    through the pipelined kernel and int8 through the tile kernel. Returns
    the pipelined kernel's and its combine kernel's launch counts over the
    three timed int8 waves, those waves' streams by seed, the publisher's
    numbers and the waves' median tokens/s."""
    from tpu_task_torch.ml.serving.cache import ServingConfig, \
        paged_cache_bytes
    from tpu_task_torch.ml.serving.engine import ServingEngine

    engine, launches, line, streams, runs = serve_flagship(
        device, smi, "serve_quant", kv_dtype="int8", decode_impl="pipelined")
    published = publish_hot(engine, bucket, "serve_quant",
                            runs[KVFLEET_SEED])
    bf16_pool = paged_cache_bytes(engine.cfg, ServingConfig(**SERVE_KNOBS),
                                  SERVE_KNOBS["n_blocks"])
    params, cfg = engine.params, engine.cfg
    del engine
    short = []
    for kv_dtype, impl in (("fp8", "pipelined"), ("int4", "pipelined"),
                           ("int8", "cuda")):
        engine = ServingEngine(params, cfg,
                               ServingConfig(**SERVE_KNOBS, kv_dtype=kv_dtype,
                                             decode_impl=impl),
                               device=device)
        run = _timed_drain(engine, 3, max_new=16)
        run.update(kv_dtype=kv_dtype,
                   kv_pool_bytes=engine.stats()["kv_pool_bytes"])
        emit("serve_quant_short_wave", **run, gpu=smi)
        short.append(run)
        del engine
    emit("serve_quant_pool", bf16_kv_pool_bytes=bf16_pool,
         int8_kv_pool_bytes=line["kv_pool_bytes"],
         int8_over_bf16=line["kv_pool_bytes"] / bf16_pool,
         short_waves={f"{r['kv_dtype']}/{r['kernel']}": r["kv_pool_bytes"]
                      for r in short})
    if not all(wave_ok(r) for r in short):
        raise AssertionError(f"a short quantized wave failed its gates: "
                             f"{short}")
    return (launches, line["combine_launches"], streams, published,
            line["tokens_per_s_median"])


def wave_ok(run: dict) -> bool:
    """A serve wave's gates: every request done, every fused step through
    the engine's kernel once per layer, nothing through the other kernel
    (nor its combine) or the plain version, and the combine kernel after
    every call whose step shape the plan splits."""
    return (run["all_finished"] and run["plain_launches"] == 0
            and run["other_kernel_launches"] == 0
            and run["kernel_launches"] == run["expected_launches"] > 0
            and run["combine_launches"] == run["expected_combine_launches"])


# -- K-token micro-steps --------------------------------------------------------

MICRO_KS = (1, 4, 8)


def serve_micro(device, smi: str, phase: str, ks, seeds,
                keep=(), **serving) -> tuple:
    """For each K of ``ks``: a flagship engine with ``serving`` over
    SERVE_KNOBS at ``micro_k`` K, the serve phase's warm-up, then one timed
    wave per seed, gated as the serve waves are (launches counted K a
    micro-step). Every request's stream at each K must equal the first
    K's, token for token. Returns (the phase line of each K, the engines
    of the Ks in ``keep``, kept for the trace)."""
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg, params = flagship_model(device)
    streams, lines, kept = {}, {}, {}
    for k in ks:
        torch.cuda.reset_peak_memory_stats()
        engine = ServingEngine(params, cfg, ServingConfig(
            **SERVE_KNOBS, micro_k=k, **serving), device=device)
        warm_up(engine)
        runs = []
        for seed in seeds:
            run = _timed_drain(engine, seed)
            streams[k, seed] = [engine.request(rid).tokens
                                for rid in run["rids"]]
            emit(f"{phase}_wave", **run, gpu=smi)
            runs.append(run)
        graphs = engine.stats()["step_graph"]

        def median(key):
            return float(np.median([r[key] for r in runs]))

        lines[k] = line = dict(
            micro_k=k, kv_dtype=engine.scfg.kv_dtype or "bfloat16",
            decode_impl=engine.decode_impl, waves=len(runs),
            tokens_per_s_runs=[r["tokens_per_s"] for r in runs],
            tokens_per_s_median=median("tokens_per_s"),
            mean_chunk_step_ms_median=median("mean_chunk_step_ms"),
            mean_decode_or_micro_step_ms_median=median(
                "mean_decode_step_ms"),
            decode_phase_tokens_per_s_runs=[r["decode_phase_tokens_per_s"]
                                            for r in runs],
            chunk_steps=sum(r["chunk_steps"] for r in runs),
            decode_steps=sum(r["decode_steps"] for r in runs),
            micro_steps=sum(r["micro_steps"] for r in runs),
            graph_captures=graphs["captures"],
            graph_captures_in_waves=sum(r["graph_captures"] for r in runs),
            capture_ms=graphs["capture_ms"], graph_replays=graphs["replays"],
            host_gap_frac_runs=[r["host_gap_frac"] for r in runs],
            dispatches_per_token_runs=[r["dispatches_per_token"]
                                       for r in runs],
            kernel_launches=sum(r["kernel_launches"] for r in runs),
            combine_launches=sum(r["combine_launches"] for r in runs),
            other_kernel_launches=sum(r["other_kernel_launches"]
                                      for r in runs),
            plain_launches=sum(r["plain_launches"] for r in runs),
            step_splits=runs[0]["step_splits"],
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
        same = all(streams[k, seed] == streams[ks[0], seed]
                   for seed in seeds)
        line["streams_equal_micro_k_%d" % ks[0]] = same
        emit(phase, **line)
        if not (same and all(wave_ok(r) for r in runs)
                and (k == 1 or line["micro_steps"] > 0)):
            raise AssertionError(f"{phase} at micro_k {k} failed its gates: "
                                 f"{line}")
        if k in keep:
            kept[k] = engine
        del engine
    return lines, kept


def phase_serve_micro(device, smi: str) -> tuple:
    """The micro-step path: the flagship with bf16 pools through the tile
    kernel at K = 1, 4 and 8, one timed wave each (two before phase 34,
    three before phase 33). Returns the K lines and the K = 8 engine (for
    the trace; the K = 1 trace, about a minute of post-processing, made
    room for phase 30)."""
    return serve_micro(device, smi, "serve_micro", MICRO_KS, (0,),
                       keep=(MICRO_KS[-1],))


def phase_serve_micro_quant(device, smi: str) -> dict:
    """int8 pools through the pipelined kernel at K = 8, one wave against
    a K = 1 engine of the same configuration. Returns the K lines."""
    lines, _ = serve_micro(device, smi, "serve_micro_quant",
                           (1, MICRO_KS[-1]), (0,), kv_dtype="int8",
                           decode_impl="pipelined")
    return lines


#: Device kernel names of the paged kernels' split walks and their combine.
WALK_NAMES = {"cuda": ("paged_decode_kernel",),
              "pipelined": ("paged_decode_pipelined_kernel",
                            "paged_decode_pipelined_mma_kernel")}
COMBINE_NAME = "combine_splits_kernel"


#: Requests of a traced wave: the serve wave's first 4 (the profiler's
#: post-processing time grows with the wave's chunk steps; phase 32's time
#: came out of these two traces).
TRACE_REQUESTS = 4


def trace_wave(engine, seed: int, smi: str,
               phase: str = "serve_trace") -> dict:
    """One wave of TRACE_REQUESTS requests under ``torch.profiler`` (CPU
    and CUDA): per fused step kind the mean wall, device-busy ms and idle share (device events
    assigned to the step whose host range holds their start: every step
    ends in a readback), the ten device ops with the most time, the ten
    host ops with the most self time (``serve_step`` is the step's own
    Python), and the paged kernels' launches counted by name in the trace,
    which must equal the wrappers' counters."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime_tracer(engine.device)
        run = _timed_drain(
            engine, seed, step_range=lambda: record_function("serve_step"),
            load=lambda: _submit_wave(engine, seed,
                                      requests=TRACE_REQUESTS))
    steps = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name == "serve_step"
                   and e.device_type == torch.autograd.DeviceType.CPU)
    # The step ranges also show on the device timeline: leave them out.
    events = sorted((start, end, name)
                    for name, start, end in device_events(prof)
                    if name != "serve_step")
    kinds = run["step_kinds"]
    if len(steps) != len(kinds):
        raise AssertionError(f"the trace holds {len(steps)} step ranges for "
                             f"{len(kinds)} steps")
    per = {kind: {"steps": 0, "wall_ms": 0.0, "busy_ms": 0.0}
           for kind in "cd"}
    i, by_name = 0, {}
    for (start, end), kind in zip(steps, kinds):
        busy, last = 0.0, -math.inf
        while i < len(events) and events[i][0] < end:
            d_start, d_end, name = events[i]
            by_name[name] = by_name.get(name, 0.0) + (d_end - d_start) / 1e3
            if d_start >= start and d_end > last:  # union of intervals
                busy += d_end - max(d_start, last)
                last = d_end
            i += 1
        row = per[kind]
        row["steps"] += 1
        row["wall_ms"] += (end - start) / 1e3
        row["busy_ms"] += busy / 1e3
    walk_names = WALK_NAMES[engine.decode_impl]
    walks = sum(any(w in name for w in walk_names)
                for _, _, name in events)
    combines = sum(COMBINE_NAME in name for _, _, name in events)
    steps_out = {}
    for kind, label in (("c", "chunk_step"), ("d", "decode_or_micro_step")):
        row = per[kind]
        n = max(1, row["steps"])
        steps_out[label] = dict(
            steps=row["steps"], mean_wall_ms=row["wall_ms"] / n,
            mean_device_busy_ms=row["busy_ms"] / n,
            device_idle_share=(1 - row["busy_ms"] / row["wall_ms"]
                               if row["wall_ms"] else None))
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    line = dict(
        micro_k=engine.scfg.micro_k, kernel=engine.decode_impl,
        traced_tokens_per_s=run["tokens_per_s"],
        chunk_steps=run["chunk_steps"], decode_steps=run["decode_steps"],
        micro_steps=run["micro_steps"], **steps_out,
        wave_device_busy_ms=sum(r["busy_ms"] for r in per.values()),
        wave_wall_ms=sum(r["wall_ms"] for r in per.values()),
        top_device_ops_ms=[(name[:90], ms) for name, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        top_host_ops_self_ms=[(e.key[:90], e.self_cpu_time_total / 1e3,
                               e.count) for e in host[:10]],
        traced_walks=walks, traced_combines=combines,
        kernel_launches=run["kernel_launches"],
        combine_launches=run["combine_launches"], gpu=smi)
    line["wave_device_idle_share"] = (
        1 - line["wave_device_busy_ms"] / line["wave_wall_ms"])
    emit(phase, **line)
    if not (wave_ok(run) and walks == run["kernel_launches"]
            and combines == run["combine_launches"]):
        raise AssertionError(f"serve trace at micro_k "
                             f"{engine.scfg.micro_k}: the trace's paged "
                             f"kernels differ from the counters or the wave "
                             f"failed its gates: {line}")
    return line


def phase_serve_trace(engines: dict, smi: str) -> dict:
    """One wave at each kept K (K = 8) under the profiler (seed 3, a wave
    none of the timed ones was)."""
    return {k: trace_wave(engine, 3, smi) for k, engine in engines.items()}


# -- flash attention ------------------------------------------------------------

#: (b, h, sq, sk, d, causal, q_offset): the flagship train step's own shape
#: first, then sq = sk, sq < sk, ring attention's q_offset 0 with sq != sk,
#: a negative offset whose first 96 rows see no key, ragged lengths the
#: 64-row tiles mask, and non-causal pairs; then the forward's 128-row tile
#: edges: sq 1, 127, 129 and 257, sk < sq (causal rows that see nothing,
#: and a non-causal pair), a q_offset of -130 (a whole tile that sees
#: nothing) and d 64 at sq 384; then the backward's 64-row q stage edges:
#: sq 65 and 193 (one row into a stage, at d 128 and 64) and a q_offset of
#: -64 (a whole stage that sees nothing); last the train flagship's zigzag
#: ring at sp 4 on 8192 tokens (stripes of c = 1024): the diagonal's first
#: block, causal with 2c query rows against c keys at q_offset 0 (rows c..
#: 2c-1 see every key), its second, a past chunk's block (2c against c)
#: and a future one's (c against 2c).
FLASH_CASES = (
    (8, 8, 1024, 1024, 128, True, None),
    (2, 4, 128, 128, 64, True, None),
    (2, 4, 128, 128, 128, False, None),
    (1, 8, 512, 2048, 128, True, None),
    (1, 8, 2048, 2048, 128, True, None),
    (2, 2, 256, 512, 64, True, 0),
    (2, 2, 256, 256, 128, True, -96),
    (1, 4, 200, 328, 128, False, None),
    (1, 4, 200, 328, 64, True, None),
    (2, 2, 1, 1, 128, True, None),
    (1, 2, 1, 300, 64, True, None),
    (2, 2, 127, 127, 128, True, None),
    (1, 2, 129, 129, 128, True, None),
    (1, 2, 257, 300, 128, True, None),
    (1, 2, 257, 129, 128, True, None),
    (1, 2, 300, 200, 64, False, None),
    (2, 2, 256, 256, 128, True, -130),
    (1, 4, 384, 384, 64, True, None),
    (2, 2, 65, 65, 128, True, None),
    (1, 2, 193, 193, 128, True, None),
    (1, 4, 193, 300, 64, True, None),
    (2, 2, 256, 256, 128, True, -64),
    (1, 8, 2048, 1024, 128, True, 0),
    (1, 8, 1024, 1024, 128, True, 0),
    (1, 8, 2048, 1024, 128, False, None),
    (1, 8, 1024, 2048, 128, False, None),
)

#: The folded-lse backward check: the zigzag diagonal's first block (b, h,
#: sq, sk, d), its backward fed the lse and delta of the whole ring row.
FOLDED_CASE = (1, 8, 2048, 1024, 128)


def nan_guarded(launch, wants) -> bool:
    """Run an uncounted ``launch(*outs)`` whose outputs are views into the
    middle of NaN-filled buffers: True if it wrote exactly ``wants`` there
    and nothing on either side."""
    pad = 1 << 16
    bufs, outs = [], []
    for want in wants:
        buf = torch.full((want.numel() + 2 * pad,), float("nan"),
                         dtype=want.dtype, device=want.device)
        bufs.append(buf)
        outs.append(buf[pad:pad + want.numel()].view(want.shape))
    launch(*outs)
    torch.cuda.synchronize()
    return all(bool(torch.isnan(buf[:pad]).all())
               and bool(torch.isnan(buf[-pad:]).all())
               and torch.equal(out, want)
               for buf, out, want in zip(bufs, outs, wants))


def flash_gate(got, exact, atol: float) -> bool:
    """fp32: within ``atol`` of the plain version (sums in another order).
    bf16: within 2^-8 |ref| + 2^-8 max|ref| + ``atol`` of the plain version
    run in fp32 on the same bf16 values: the output's bf16 rounding, plus
    the bf16 rounding of the weights (p, and ds in the backward) before the
    tensor-core products, which the TPU kernels round too; each such
    rounding moves a sum by at most 2^-9 of its terms' magnitude, bounded
    by the tensor's scale."""
    err = (got.float() - exact.float()).abs()
    if got.dtype == torch.float32:
        return bool(err.max() <= atol)
    scale = exact.float().abs()
    return bool((err <= 2.0 ** -8 * (scale + scale.max()) + atol).all())


def phase_flash_kernel(device) -> dict:
    """The three flash kernels against their plain versions; returns each
    kernel's largest error against the plain version at its own type."""
    from tpu_task_torch.ml.ops import attention as fa

    gen = torch.Generator().manual_seed(3)
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for b, h, sq, sk, d, causal, q_offset in FLASH_CASES:
        off = sk - sq if q_offset is None else q_offset
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(shape, generator=gen).to(dtype)
                           .to(device) for shape in
                           ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                            (b, sq, h, d)))
            before = [t.clone() for t in (q, k, v, do)]
            o, lse = fa.flash_attention(q, k, v, causal, q_offset=q_offset,
                                        return_lse=True)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                 q_offset=q_offset)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                      q_offset=q_offset)
            torch.cuda.synchronize()
            unchanged = all(torch.equal(x, y)
                            for x, y in zip(before, (q, k, v, do)))
            guarded = (
                nan_guarded(lambda o_, l_: fa._launch_fwd(
                    q, k, v, causal, off, o_, l_), (o, lse))
                and nan_guarded(lambda dq_: fa._launch_dq(
                    q, k, v, do, lse, delta, causal, off, dq_), (dq,))
                and nan_guarded(lambda dk_, dv_: fa._launch_dkv(
                    q, k, v, do, lse, delta, causal, off, dk_, dv_),
                    (dk, dv)))
            same_o, same_lse = fa.flash_attention_reference(q, k, v, causal,
                                                            q_offset)
            same = fa.flash_bwd_reference(q, k, v, do, lse, delta, causal,
                                          q_offset)
            wide = [t.float() for t in (q, k, v, do)]
            ex_o, ex_lse = fa.flash_attention_reference(*wide[:3], causal,
                                                        q_offset)
            exact = fa.flash_bwd_reference(*wide, lse, delta, causal,
                                           q_offset)
            errs, ok = {}, unchanged and guarded
            for name, got, plain, ref, atol in (
                    ("o", o, same_o, ex_o, FLASH_FWD_ATOL),
                    ("lse", lse, same_lse, ex_lse, FLASH_FWD_ATOL),
                    ("dq", dq, same[0], exact[0], FLASH_BWD_ATOL),
                    ("dk", dk, same[1], exact[1], FLASH_BWD_ATOL),
                    ("dv", dv, same[2], exact[2], FLASH_BWD_ATOL)):
                errs[name] = (got.float() - plain.float()).abs().max().item()
                errs[name + "_vs_fp32"] = (got.float() - ref).abs().max() \
                    .item()
                ok = ok and flash_gate(got, ref, atol)
            hidden = max(0, -off) if causal else 0
            if hidden:                 # rows that see no key: JAX's values
                ok = ok and bool((o[:, :hidden] == 0).all()) and bool(
                    (lse[:, :, :hidden] == fa.NEG_INF).all())
            worst["flash_fwd"] = max(worst["flash_fwd"], errs["o"],
                                     errs["lse"])
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"],
                                         errs["dv"])
            line = dict(b=b, h=h, sq=sq, sk=sk, d=d, causal=causal,
                        q_offset=off, rows_seeing_no_key=hidden,
                        dtype=str(dtype).replace("torch.", ""),
                        inputs_unchanged=unchanged,
                        writes_only_out_and_repeats=guarded,
                        max_abs_err=errs,
                        tolerance=(f"fp32: {FLASH_FWD_ATOL} forward, "
                                   f"{FLASH_BWD_ATOL} backward"
                                   if dtype == torch.float32 else
                                   "bf16: 2^-8*(|fp32 ref| + max|fp32 "
                                   "ref|) + the fp32 tolerance"))
            emit("flash_kernel", ok=ok, **line)
            if not ok:
                raise AssertionError(f"flash kernels disagree: {line}")
    folded = flash_folded_lse(device, gen)
    for name, err in folded.items():
        worst[name] = max(worst[name], err)
    return worst


def flash_folded_lse(device, gen) -> dict:
    """The backward pair fed an lse larger than the block's own, as every
    ring block's backward is: the zigzag diagonal's first block (causal,
    2c rows against c keys at q_offset 0) folded with a second,
    non-causal block of c other keys (``ring_attention._fold``, the
    port's), then dq and dk/dv of the first block from the folded lse and
    the delta of the folded output, against the plain backward on the
    same lse and delta, at fp32 and bf16. Returns each kernel's largest
    error against the plain version."""
    from tpu_task_torch.ml.ops import attention as fa
    from tpu_task_torch.ml.parallel.ring_attention import _fold

    b, h, sq, sk, d = FOLDED_CASE
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, k2, v2, do = (
            torch.randn(shape, generator=gen).to(dtype).to(device)
            for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                          (b, sk, h, d), (b, sk, h, d), (b, sq, h, d)))
        o1, lse1 = fa.flash_attention(q, k, v, True, q_offset=0,
                                      return_lse=True)
        o2, lse2 = fa.flash_attention(q, k2, v2, False, q_offset=0,
                                      return_lse=True)
        o, lse = _fold(o1.float(), lse1, o2, lse2)
        delta = (do.float() * o.to(dtype).float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, q_offset=0)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, q_offset=0)
        torch.cuda.synchronize()
        same = fa.flash_bwd_reference(q, k, v, do, lse, delta, True, 0)
        exact = fa.flash_bwd_reference(q.float(), k.float(), v.float(),
                                       do.float(), lse, delta, True, 0)
        above = bool((lse > lse1).all())
        ok, errs = above, {}
        for name, got, plain, ref in (("dq", dq, same[0], exact[0]),
                                      ("dk", dk, same[1], exact[1]),
                                      ("dv", dv, same[2], exact[2])):
            errs[name] = (got.float() - plain.float()).abs().max().item()
            errs[name + "_vs_fp32"] = (got.float() - ref).abs().max().item()
            ok = ok and flash_gate(got, ref, FLASH_BWD_ATOL)
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"],
                                     errs["dv"])
        line = dict(b=b, h=h, sq=sq, sk=sk, d=d, causal=True, q_offset=0,
                    dtype=str(dtype).replace("torch.", ""),
                    lse_above_block_own=above,
                    mean_lse_gap=(lse - lse1).mean().item(),
                    max_abs_err=errs,
                    tolerance=(f"fp32: {FLASH_BWD_ATOL}" if dtype ==
                               torch.float32 else "bf16: 2^-8*(|fp32 ref| "
                               "+ max|fp32 ref|) + the fp32 tolerance"))
        emit("flash_kernel_folded_lse", ok=ok, **line)
        if not ok:
            raise AssertionError(f"flash backward on a folded lse: {line}")
    return worst


def visible_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the mask lets through: the score entries a kernel
    that skips masked tiles must still compute."""
    if not causal:
        return sq * sk
    return sum(max(0, min(sk, q_offset + i + 1)) for i in range(sq))


def phase_flash_timing(device, smi: str) -> dict:
    """Each flash kernel, its plain version and SDPA at the flagship train
    shape; returns one row per kernel."""
    from tpu_task_torch.ml.ops import attention as fa

    F = torch.nn.functional
    timer = DeviceTimer(device)
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, TRAIN_FLAGSHIP["n_heads"], \
        TRAIN_FLAGSHIP["d_head"]
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, True, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    # SDPA wants (b, h, s, d): the yardstick's own layout, made once.
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lq, lk, lv = (t.clone().requires_grad_(True) for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_err = (lib_out.detach().transpose(1, 2).float()
               - o.float()).abs().max().item()
    if lib_err > 2e-2:
        raise AssertionError(f"SDPA yardstick disagrees with the kernel: "
                             f"{lib_err}")

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (lq, lk, lv), dot,
                                   retain_graph=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
        return torch.autograd.grad(out, (lq, lk, lv), dot)

    sdpa = dict(fwd=timer(sdpa_fwd), bwd=timer(sdpa_bwd),
                fwd_bwd=timer(sdpa_fwd_bwd))
    # delta = rowsum(dO * O), the plain torch before the backward pair
    # (flash_attention_bwd).
    delta_ms = timer(lambda: (do.float() * o.float()).sum(-1)
                     .transpose(1, 2).contiguous())
    pairs = visible_pairs(s, s, True, 0) * b * h
    tensor = b * s * h * d * q.element_size()     # one (b, s, h, d) tensor
    stats = b * h * s * 4                         # one (b, h, s) f32 array
    kernels = {
        # name: (kernel, plain, FLOPs, bytes). Products of the executed
        # (visible) score entries; each input read once, each output
        # written once.
        "flash_fwd": (
            lambda: fa.flash_attention(q, k, v, True, return_lse=True),
            lambda: fa.flash_attention_reference(q, k, v, True),
            2 * 2 * pairs * d, 4 * tensor + stats, sdpa["fwd"]),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, True),
            3 * 2 * pairs * d, 5 * tensor + 2 * stats, sdpa["bwd"]),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, True),
            4 * 2 * pairs * d, 6 * tensor + 2 * stats, sdpa["bwd"]),
    }
    rows = {}
    for name, (kernel, plain, flops, n_bytes, lib_ms) in kernels.items():
        t_ops, t_bytes = flops / BF16_FLOPS, n_bytes / HBM_BYTES_PER_S
        row = dict(kernel=name, b=b, s=s, h=h, d=d, dtype="bfloat16",
                   causal=True, ms=timer(kernel), plain_ms=timer(plain),
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   flops=flops, bytes=n_bytes, library_ms=lib_ms, gpu=smi)
        row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / row["ms"] / 1e9
        emit("flash_timing", **row)
        rows[name] = row
    emit("flash_timing_sdpa", sdpa_fwd_ms=sdpa["fwd"],
         sdpa_bwd_ms=sdpa["bwd"], sdpa_fwd_bwd_ms=sdpa["fwd_bwd"],
         kernels_fwd_bwd_ms=sum(r["ms"] for r in rows.values()),
         kernels_bwd_ms=rows["flash_bwd_dq"]["ms"]
         + rows["flash_bwd_dkv"]["ms"], delta_ms=delta_ms,
         sdpa_max_abs_diff=lib_err, gpu=smi,
         note="library_ms of dq and dk/dv is SDPA's one backward call, "
              "which computes dq, dk and dv together; delta_ms is the "
              "plain-torch rowsum(dO * O) the kernels' backward runs first")
    return rows


#: (b, h, s, d, causal) of the forward's extra timings: the flagship's
#: non-causal twin, longer and shorter causal rows at the same tokens, and
#: d 64.
FWD_SHAPES = ((8, 8, 1024, 128, True), (8, 8, 1024, 128, False),
              (2, 8, 4096, 128, True), (4, 8, 2048, 128, True),
              (16, 8, 512, 128, True), (8, 16, 1024, 64, True))


def fwd_shape_times(device) -> list:
    """The flash forward and SDPA's forward at FWD_SHAPES, one row each.
    It calls only the port's public wrapper, so ``chip_ab.py`` times
    another checkout's forward with it too."""
    from tpu_task_torch.ml.ops import attention as fa

    F = torch.nn.functional
    timer = DeviceTimer(device)
    gen = torch.Generator(device=device).manual_seed(8)
    rows = []
    for b, h, s, d, causal in FWD_SHAPES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows.append(dict(
            b=b, h=h, s=s, d=d, causal=causal,
            ms=timer(lambda: fa.flash_attention(q, k, v, causal,
                                                return_lse=True)),
            sdpa_ms=timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))))
    return rows


def phase_flash_fwd_shapes(device, smi: str) -> None:
    """``fwd_shape_times`` with the CTAs and kv tile steps of the wgmma
    forward's schedule (``flash_fwd_tiles``), then a least-squares fit of
    the kernel's ms as a fixed cost per CTA plus a cost per tile step,
    each spread over the card's SMs (one CTA an SM)."""
    from tpu_task_torch.ml.ops import attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = fwd_shape_times(device)
    for row in rows:
        tiles = fa.flash_fwd_tiles(row["s"], row["s"], row["causal"], 0)
        heads = row["b"] * row["h"]
        row.update(ctas=len(tiles) * heads,
                   tile_steps=sum(t.n for t in tiles) * heads)
    d128 = [r for r in rows if r["d"] == 128]
    a = np.array([[r["ctas"] / sms, r["tile_steps"] / sms] for r in d128])
    us = np.array([r["ms"] * 1e3 for r in d128])
    (per_cta, per_step), *_ = np.linalg.lstsq(a, us, rcond=None)
    emit("flash_fwd_shapes", shapes=rows, sms=sms,
         fit_d128=dict(per_cta_us=float(per_cta),
                       per_tile_step_us=float(per_step),
                       worst_rel_err=float(np.max(np.abs(a @ [per_cta,
                                                               per_step]
                                                          - us) / us))),
         note="fit: ms x 1e3 = per_cta_us x ctas / sms + per_tile_step_us "
              "x tile_steps / sms over the d 128 shapes; one tile step is "
              "the two 128 x 128 x 128 products of both consumers, 1.12 us "
              "at 989 TFLOP/s over 132 SMs",
         gpu=smi)


def bwd_shape_times(device) -> list:
    """The flash backward pair (dq, then dk/dv) and SDPA's backward at
    FWD_SHAPES, one row each: the pair's ms, each kernel's, and SDPA's one
    backward call (dq, dk and dv). It calls only the port's public
    wrappers, so ``chip_ab.py`` times another checkout's pair with it
    too."""
    from tpu_task_torch.ml.ops import attention as fa

    F = torch.nn.functional
    timer = DeviceTimer(device)
    gen = torch.Generator(device=device).manual_seed(9)
    rows = []
    for b, h, s, d, causal in FWD_SHAPES:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                   device=device, dtype=torch.bfloat16)
                       for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()

        def dq():
            return fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)

        def dkv():
            return fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)

        rows.append(dict(
            b=b, h=h, s=s, d=d, causal=causal,
            ms=timer(lambda: (dq(), dkv())), dq_ms=timer(dq),
            dkv_ms=timer(dkv),
            sdpa_bwd_ms=timer(lambda: torch.autograd.grad(
                out, (lq, lk, lv), dot, retain_graph=True))))
        del out
    return rows


def phase_flash_bwd_shapes(device, smi: str) -> None:
    """``bwd_shape_times`` with the CTAs and tile steps of each wgmma
    backward kernel's schedule (``flash_bwd_tiles``: dq's 128-row kv
    stages, dk/dv's 64-row q stages), then for each kernel a least-squares
    fit of its ms as a fixed cost per CTA plus a cost per tile step over
    the d 128 shapes, each spread over the card's SMs (one CTA an SM)."""
    from tpu_task_torch.ml.ops import attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = bwd_shape_times(device)
    for row in rows:
        tiles = fa.flash_bwd_tiles(row["s"], row["s"], row["causal"], 0)
        heads = row["b"] * row["h"]
        row.update(dq_ctas=len(tiles.dq) * heads,
                   dq_tile_steps=sum(t.n for t in tiles.dq) * heads,
                   dkv_ctas=len(tiles.dkv) * heads,
                   dkv_tile_steps=sum(t.end - t.begin for t in tiles.dkv)
                   * heads)
    d128 = [r for r in rows if r["d"] == 128]
    fits = {}
    for kernel in ("dq", "dkv"):
        a = np.array([[r[kernel + "_ctas"] / sms,
                       r[kernel + "_tile_steps"] / sms] for r in d128])
        us = np.array([r[kernel + "_ms"] * 1e3 for r in d128])
        (per_cta, per_step), *_ = np.linalg.lstsq(a, us, rcond=None)
        fits[kernel] = dict(
            per_cta_us=float(per_cta), per_tile_step_us=float(per_step),
            worst_rel_err=float(np.max(np.abs(a @ [per_cta, per_step] - us)
                                       / us)))
    emit("flash_bwd_shapes", shapes=rows, sms=sms, fit_d128=fits,
         note="fit: ms x 1e3 = per_cta_us x ctas / sms + per_tile_step_us "
              "x tile_steps / sms over the d 128 shapes; a dq tile step is "
              "both consumers' three 64 x 128 x 128 products (1.68 us at "
              "989 TFLOP/s over 132 SMs), a dk/dv step their four 64 x 64 "
              "x 128 products (1.12 us)",
         gpu=smi)


def flash_counts() -> dict:
    from tpu_task_torch.ml.ops import attention as fa

    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
            "plain_fwd": fa.flash_attention_reference.launches,
            "plain_bwd": fa.flash_bwd_reference.launches,
            "plain_mha": fa.mha_reference.launches}


class PlainFlash(torch.autograd.Function):
    """``FlashAttention``'s wiring over the plain versions, on any device:
    the reference path of the train-parity phase."""

    @staticmethod
    def forward(ctx, q, k, v):
        from tpu_task_torch.ml.ops import attention as fa

        o, lse = fa.flash_attention_reference(q, k, v, True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        from tpu_task_torch.ml.ops import attention as fa

        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        return fa.flash_bwd_reference(q, k, v, do, lse, delta, True)


#: (dtype, config, params' abs tolerance, loss and grad norm's relative
#: tolerance). fp32 at d 32 takes the fp32-core kernels: after three AdamW
#: steps (lr 3e-4) the parameters may differ by the last-bit gradient
#: differences of fp32 sums in another order, scaled by lr: 2e-5, as in the
#: CPU tests against JAX. bf16 at d 128 takes the tensor-core kernels, which
#: round p and ds to bf16 where the plain version keeps fp32: loss and grad
#: norm within 2^-10 relative (an all-bf16 attention and an fp32 one differ
#: by 3.3e-5 at this config on the CPU). Its parameters are not held element
#: by element: AdamW's first steps move a parameter whose gradient is near 0
#: by about lr whichever way that gradient's sign falls, so two right paths
#: differ there by up to 2 lr a step.
PARITY_TRAIN = (
    (torch.float32, dict(vocab_size=1024, d_model=256, n_layers=2,
                         n_heads=8, d_head=32, d_ff=512, n_kv_heads=4),
     2e-5, 1e-5),
    (torch.bfloat16, dict(vocab_size=1024, d_model=512, n_layers=2,
                          n_heads=4, d_head=128, d_ff=1024, n_kv_heads=2),
     None, 2.0 ** -10),
)


def phase_train_parity(device) -> None:
    from tpu_task_torch.ml import train
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.ops import attention as fa

    for dtype, config, param_atol, rtol in PARITY_TRAIN:
        cfg = transformer.TransformerConfig(dtype=dtype, **config)
        tokens = torch.randint(0, cfg.vocab_size, (4, 257),
                               generator=torch.Generator().manual_seed(5))
        tokens = tokens.to(device)

        def plain_attn(q, k, v):
            return PlainFlash.apply(q, transformer.expand_kv(k, cfg.n_heads),
                                    transformer.expand_kv(v, cfg.n_heads))

        runs = {}
        for path, attn_fn in (("kernels", None), ("plain", plain_attn)):
            state = train.init_state(torch.Generator().manual_seed(6), cfg,
                                     device=device)
            step = train.make_train_step(cfg, attn_fn=attn_fn)
            fa.reset_launch_counts()
            metrics = []
            for _ in range(3):
                state, m = step(state, tokens)
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
            runs[path] = dict(metrics=metrics, counts=flash_counts(),
                              params=[p.detach().clone() for p in
                                      train._leaves(state.params)])
        kern, plain = runs["kernels"], runs["plain"]
        n = 3 * cfg.n_layers
        param_err = max((a - b).abs().max().item()
                        for a, b in zip(kern["params"], plain["params"]))
        rel = max(abs(a - b) / abs(b) for x, y in zip(kern["metrics"],
                                                      plain["metrics"])
                  for a, b in zip(x, y))
        ok = ((param_atol is None or param_err <= param_atol)
              and rel <= rtol
              and all(kern["counts"][name] == n for name in
                      ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
              and kern["counts"]["plain_fwd"] == kern["counts"]["plain_bwd"]
              == kern["counts"]["plain_mha"] == 0
              and plain["counts"]["flash_fwd"] == 0)
        emit("train_parity", ok=ok, config=config, tokens=[4, 257],
             dtype=str(dtype).replace("torch.", ""), steps=3,
             kernels_metrics=kern["metrics"], plain_metrics=plain["metrics"],
             max_param_abs_diff=param_err, max_metric_rel_diff=rel,
             kernel_counts=kern["counts"], plain_counts=plain["counts"],
             tolerance=(f"loss and grad norm {rtol} rel"
                        + ("" if param_atol is None
                           else f", params {param_atol} abs")))
        if not ok:
            raise AssertionError(f"{dtype} train step through the kernels "
                                 "differs from the plain versions")


class FlashRecorder:
    """Stands in for the flash kernels' uncounted launchers in
    ``tpu_task_torch.ml.ops.attention`` for one train step: passes every
    launch through and keeps a copy of the first launch's arguments of
    each kernel, outputs included (the forward of layer 0, the backward of
    the last layer), so the kernels' work in the step can be held against
    the plain versions after it."""

    NAMES = ("_launch_fwd", "_launch_dq", "_launch_dkv")

    def __init__(self, fa):
        self.fa, self.calls = fa, {}

    def __enter__(self):
        self.saved = {name: getattr(self.fa, name) for name in self.NAMES}
        for name, fn in self.saved.items():
            setattr(self.fa, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.fa, name, fn)

    def _wrap(self, name, fn):
        def recorded(*args):
            fn(*args)
            if name not in self.calls:
                self.calls[name] = [a.clone() if torch.is_tensor(a) else a
                                    for a in args]
        return recorded


def check_recorded(calls) -> dict:
    """Each recorded kernel output against the plain version run in fp32 on
    the same inputs, under phase 7's bf16 gate with its fp32 term scaled
    down to a tensor whose largest value is below 1 (the gradients of a
    token-mean loss are far below 1; at unit scale the term would pass
    anything)."""
    from tpu_task_torch.ml.ops import attention as fa

    q, k, v, causal, off, o, lse = calls["_launch_fwd"]
    ex_o, ex_lse = fa.flash_attention_reference(q.float(), k.float(),
                                                v.float(), causal, off)
    q, k, v, do, blse, delta, causal, off, dq = calls["_launch_dq"]
    dk, dv = calls["_launch_dkv"][-2:]
    exact = fa.flash_bwd_reference(q.float(), k.float(), v.float(),
                                   do.float(), blse, delta, causal, off)
    out = {}
    for name, got, ref, atol in (
            ("o", o, ex_o, FLASH_FWD_ATOL),
            ("lse", lse, ex_lse, FLASH_FWD_ATOL),
            ("dq", dq, exact[0], FLASH_BWD_ATOL),
            ("dk", dk, exact[1], FLASH_BWD_ATOL),
            ("dv", dv, exact[2], FLASH_BWD_ATOL)):
        big = ref.float().abs().max().item()
        out[name] = dict(ok=flash_gate(got, ref, atol * min(big, 1.0)),
                         max_abs_err_vs_fp32=(got.float() - ref)
                         .abs().max().item(),
                         max_abs_fp32=big)
    return out


def train_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one optimizer step with the attention term
    causal-halved: the first convention of ``bench.py``'s
    ``_train_flops_per_step``, copied (matmuls forward x3; attention
    scaled by (s + 1) / 2s, the score entries a causal kernel executes).
    The matmul parameters are the goodput model's: a MoE layer counts its
    router and top-k experts, a dense config the same count as bench.py's."""
    from tpu_task_torch.obs.goodput import matmul_params

    mm_fwd = 2.0 * batch * seq * matmul_params(cfg)
    attn_fwd = cfg.n_layers * 4.0 * batch * seq * seq * cfg.d_attn
    return 3.0 * (mm_fwd + attn_fwd * (seq + 1) / (2.0 * seq))


def profile_step(step, state, tokens, wall_ms: float) -> dict:
    """One step under ``torch.profiler``: device time by kernel name (the
    top ten) and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for name, start, end in device_events(prof):
        spans.append((start, end))
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    busy, last = 0.0, -math.inf
    for start, end in sorted(spans):            # union of kernel intervals
        if end > last:
            busy += end - max(start, last)
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(profiled_step_wall_ms=wall, device_events=len(spans),
                device_busy_ms=busy / 1e3,
                device_idle_share=(1 - busy / 1e3 / wall) if spans else None,
                top_kernels_ms=[(name[:90], ms) for name, ms in top],
                timed_step_median_ms=wall_ms)


def phase_train(device, smi: str) -> dict:
    """The train path: the flagship at full width and depth, two warm-up
    steps, then ten timed steps on one batch, the flash launch counts set
    to 0 just before them and read just after."""
    from tpu_task_torch.ml import train
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.ops import attention as fa

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16,
                                        **TRAIN_FLAGSHIP)
    state = train.init_state(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    n_params = sum(p.numel() for p in train._leaves(state.params))
    tokens = torch.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    step = train.make_train_step(cfg)
    losses = []
    # The first warm-up step is recorded: layer 0's forward and the last
    # layer's backward are held against the plain versions after it.
    with FlashRecorder(fa) as recorder:
        state, m = step(state, tokens)
    losses.append(m["loss"])
    state, m = step(state, tokens)                            # warm-up
    losses.append(m["loss"])
    torch.cuda.synchronize()
    recorded = check_recorded(recorder.calls)
    recorder.calls.clear()                 # its copies stay out of the peak
    emit("train_step_check", ok=all(c["ok"] for c in recorded.values()),
         step=1, forward_layer=0, backward_layer=cfg.n_layers - 1,
         outputs=recorded,
         tolerance="2^-8*(|fp32 ref| + max|fp32 ref|) + the fp32 tolerance "
                   "x min(1, max|fp32 ref|)")
    if not all(c["ok"] for c in recorded.values()):
        raise AssertionError(f"flash kernels in the flagship train step "
                             f"disagree with the plain versions: {recorded}")
    step_ms, per_step = [], []
    # Peak memory of the timed steps, not of the check above.
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    for _ in range(10):
        before = flash_counts()
        t0 = time.perf_counter()
        state, m = step(state, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = flash_counts()
        per_step.append({key: after[key] - before[key] for key in after})
        losses.append(m["loss"])
    counts = flash_counts()
    losses = [x.item() for x in losses]
    median_ms = float(np.median(step_ms))
    flops = train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "plain_fwd": 0, "plain_bwd": 0,
            "plain_mha": 0}
    line = dict(
        params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype="bfloat16",
        master_weights="float32", warmup_steps=2, timed_steps=len(step_ms),
        step_ms=step_ms, step_ms_median=median_ms,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / median_ms * 1e3,
        flops_per_step=flops,
        mfu=flops / (median_ms / 1e3) / BF16_FLOPS,
        mfu_peak="989 TFLOP/s dense bf16 (H100 SXM data sheet)",
        losses=losses, launches_per_step=per_step[0],
        launches_every_step_as_expected=all(p == want for p in per_step),
        launches=counts,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    emit("train", **line)
    finite = all(math.isfinite(x) for x in losses)
    if not (finite and losses[-1] < losses[0]
            and line["launches_every_step_as_expected"]):
        raise AssertionError(f"flagship train run failed its gates: {line}")
    emit("train_profile", **profile_step(step, state, tokens, median_ms),
         gpu=smi)
    return counts


# -- checkpoint, restore and the input pipeline ---------------------------------

#: Losses of a restored run against the original's, relative: the embed
#: backward's ``index_add_`` adds atomically on CUDA, so the fp32 sums of
#: repeated tokens' rows come out in another order from run to run, and
#: AdamW moves the master weights by about lr x that last-bit difference.
RESUME_LOSS_RTOL = 1e-4

#: The task script of phase 10b (and of ``tests/test_torch_train_resume.py``
#: on the CPU at a tiny size): a trainer that imports only tpu_task_torch,
#: restores its newest published checkpoint when there is one, and feeds
#: seeded token data through ``epoch_batches`` + ``prefetch_to_device``,
#: checkpointing through ``AsyncCheckpointer``. Its one argument is a JSON
#: config; it prints one JSON line an event, each with its wall time.
TRAINER_SCRIPT = r'''
import json, os, sys, time

config = json.loads(sys.argv[1])
sys.path.insert(0, config["repo"])
import numpy as np
import torch

from tpu_task_torch.ml import AsyncCheckpointer, restore_checkpoint_sharded
from tpu_task_torch.ml import train
from tpu_task_torch.ml.data import epoch_batches, prefetch_to_device
from tpu_task_torch.ml.models import transformer
from tpu_task_torch.ml.ops import attention
from tpu_task_torch.ml.tree import leaves, tree_map


def log(event, **fields):
    print(json.dumps({"event": event, "t": time.time(), **fields}),
          flush=True)


log("imported")
device = torch.device(config["device"])
if device.type == "cuda":
    torch.empty(1, device=device)
    torch.cuda.synchronize()
log("device_ready")
cfg = transformer.TransformerConfig(dtype=getattr(torch, config["dtype"]),
                                    **config["model"])
state = train.init_state(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
tokens = np.random.default_rng(config["seed"]).integers(
    0, cfg.vocab_size, size=(config["rows"], config["seq"] + 1))
if os.path.exists(os.path.join("checkpoints", "LATEST_SHARDED")):
    t0 = time.perf_counter()
    host = restore_checkpoint_sharded("checkpoints", tree_map(
        lambda t: torch.empty_like(t, device="cpu")
        if torch.is_tensor(t) else t, state))
    t1 = time.perf_counter()
    state = tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t,
                     host)
    if device.type == "cuda":
        torch.cuda.synchronize()
    log("restored", step=state.step, read_s=t1 - t0,
        host_to_device_s=time.perf_counter() - t1,
        bytes=sum(t.numel() * t.element_size() for t in leaves(state)
                  if torch.is_tensor(t)))
step_fn = train.make_train_step(cfg)
batches = prefetch_to_device(
    epoch_batches(tokens, None, config["batch"], seed=config["seed"],
                  start_step=state.step), device)
attention.reset_launch_counts()
with AsyncCheckpointer("checkpoints", keep=2) as saver:
    while state.step < config["steps"]:
        state, metrics = step_fn(state, next(batches))
        log("step", step=state.step, loss=metrics["loss"].item())
        if state.step % config["save_every"] == 0:
            saver.save(state.step, state)
log("done", step=state.step, launches={
    "flash_fwd": attention.flash_attention.launches,
    "flash_bwd_dq": attention.flash_bwd_dq.launches,
    "flash_bwd_dkv": attention.flash_bwd_dkv.launches,
    "plain_fwd": attention.flash_attention_reference.launches,
    "plain_bwd": attention.flash_bwd_reference.launches,
    "plain_mha": attention.mha_reference.launches})
'''


def trainer_events(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith("{")]


def run_trainer(workdir: Path, config: dict, log_name: str, *,
                kill_after_publish: bool = False, timeout_s: float = 600):
    """The trainer as its own process in ``workdir``: (events, the spawn's
    wall time, the LATEST_SHARDED step when it was killed or None). With
    ``kill_after_publish`` it is SIGKILLed as soon as its first
    LATEST_SHARDED exists."""
    import signal

    script = workdir / "train_task.py"
    script.write_text(TRAINER_SCRIPT)
    log_path = workdir / log_name
    pointer = workdir / "checkpoints" / "LATEST_SHARDED"
    killed_at = None
    with open(log_path, "w") as out:
        t_spawn = time.time()
        proc = subprocess.Popen(
            [sys.executable, str(script), json.dumps(config)], cwd=workdir,
            stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + timeout_s
            while proc.poll() is None and time.monotonic() < deadline:
                if kill_after_publish and pointer.exists():
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    killed_at = json.loads(pointer.read_text())["step"]
                    break
                time.sleep(0.01)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if killed_at is None and proc.returncode != 0:
        raise AssertionError(f"trainer exited {proc.returncode}: "
                             f"{log_path.read_text()[-4000:]}")
    return trainer_events(log_path), t_spawn, killed_at


def train_tokens(cfg, device, step: int) -> torch.Tensor:
    """Phase 10a's batch for ``step``: seeded, one a step."""
    return torch.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(100 + step))


def state_leaves(state) -> list:
    from tpu_task_torch.ml.tree import leaves

    return leaves(state)


def phase_train_checkpoint(device, smi: str, root: Path) -> dict:
    """The flagship state on the card saved synchronously at step 2 and
    asynchronously at steps 4 and 6 with steps between, restored, and run
    on; the flash launch counts set to 0 just before the first step and
    read after the last."""
    from tpu_task_torch.ml import (AsyncCheckpointer,
                                   restore_checkpoint_sharded,
                                   save_checkpoint_sharded, train)
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.ops import attention as fa

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16,
                                        **TRAIN_FLAGSHIP)
    state = train.init_state(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    state_bytes = sum(
        t.numel() * t.element_size() if torch.is_tensor(t) else 4
        for t in state_leaves(state))
    step = train.make_train_step(cfg)
    directory = root / "ckpt"
    meta = directory / "ckpt-6.meta"
    per_step, losses = [], {}

    def run(state, index: int, key: str, times: list):
        before = flash_counts()
        t0 = time.perf_counter()
        state, m = step(state, train_tokens(cfg, device, index))
        loss = m["loss"].item()
        times.append(((time.perf_counter() - t0) * 1e3, not meta.exists()))
        after = flash_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.setdefault(key, []).append(loss)
        return state

    fa.reset_launch_counts()
    warm, plain, overlap, restored_times = [], [], [], []
    for i in (1, 2):
        state = run(state, i, "original", warm)
    t0 = time.perf_counter()
    save_checkpoint_sharded(directory, 2, state)
    sync_ms = (time.perf_counter() - t0) * 1e3
    saver = AsyncCheckpointer(directory, keep=2)
    for i in (3, 4):
        state = run(state, i, "original", plain)
    blocked, saved_at, snapshot_bytes = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    peak_before = torch.cuda.max_memory_allocated()
    for save_step, follow in ((4, (5, 6)), (6, (7, 8, 9))):
        in_use = torch.cuda.memory_allocated()
        saved_at[save_step] = time.time()
        t0 = time.perf_counter()
        saver.save(save_step, state)
        blocked[save_step] = (time.perf_counter() - t0) * 1e3
        snapshot_bytes[save_step] = torch.cuda.memory_allocated() - in_use
        if save_step == 6:
            # Gate 1's reference, outside the timed steps.
            reference = [t.clone() if torch.is_tensor(t) else t
                         for t in state_leaves(state)]
            torch.cuda.synchronize()
        for i in follow:
            state = run(state, i, "original", overlap)
    overlap_peak = torch.cuda.max_memory_allocated()
    saver.wait()
    durable_ms = {s: (os.path.getmtime(directory / f"ckpt-{s}.meta")
                      - saved_at[s]) * 1e3 for s in saved_at}
    pinned = saver.pinned_bytes
    saver.close()
    t0 = time.perf_counter()
    restored = restore_checkpoint_sharded(directory, train.init_state(
        torch.Generator(device=device).manual_seed(3), cfg, device=device))
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    got = state_leaves(restored)
    bit_equal = restored.step == 6 and len(got) == len(reference) and all(
        (torch.is_tensor(a) and a.device == b.device and a.dtype == b.dtype
         and torch.equal(a, b)) or (not torch.is_tensor(a) and a == b)
        for a, b in zip(got, reference))
    del reference
    for i in (7, 8, 9):
        restored = run(restored, i, "restored", restored_times)
    counts = flash_counts()
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "plain_fwd": 0, "plain_bwd": 0,
            "plain_mha": 0}
    after = losses["original"][-3:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["restored"], after))
    overlapped = [ms for ms, busy in overlap if busy]
    line = dict(
        ok=bit_equal and rel <= RESUME_LOSS_RTOL
        and all(p == want for p in per_step),
        state_bytes=state_bytes, leaves=len(got), sync_save_ms=sync_ms,
        async_blocked_ms=blocked, save_to_latest_sharded_ms=durable_ms,
        restore_ms=restore_ms, plain_step_ms=[ms for ms, _ in plain],
        overlapped_step_ms=overlapped,
        steps_after_publish_ms=[ms for ms, busy in overlap if not busy],
        restored_step_ms=[ms for ms, _ in restored_times],
        step_ms_median={"plain": float(np.median([ms for ms, _ in plain]
                                                 + [ms for ms, _ in
                                                    restored_times])),
                        "overlapped": float(np.median(overlapped))
                        if overlapped else None},
        pinned_host_bytes=pinned, snapshot_device_bytes=snapshot_bytes,
        peak_memory_gb={"before_saves": peak_before / 1e9,
                        "overlapped": overlap_peak / 1e9},
        restored_bit_equal=bit_equal, losses=losses,
        first_restored_loss_bit_equal=losses["restored"][0] == after[0],
        max_loss_rel_diff=rel, tolerance=f"losses {RESUME_LOSS_RTOL} rel",
        launches_every_step_as_expected=all(p == want for p in per_step),
        launches=counts, gpu=smi)
    emit("train_checkpoint", **line)
    if not line["ok"]:
        raise AssertionError(f"checkpoint phase failed its gates: {line}")
    return counts


#: Phase 10b's run: a save every 4 steps of 20. The writer takes the step-4
#: save; saves 8 and 12 queue (``max_pending`` 2), and the one at step 16
#: waits until the writer has published step 4 and taken step 8. So the
#: kill, as soon as ``LATEST_SHARDED`` names step 4, lands inside the
#: loop, at step 16 or 17 of 20, however long the writer takes.
RESUME_STEPS, RESUME_SAVE_EVERY = 20, 4


def trainer_config(device: str, model: dict, dtype: str, batch: int,
                   seq: int, steps: int, save_every: int) -> dict:
    """``TRAINER_SCRIPT``'s argument: one epoch of ``steps`` batches."""
    return dict(repo=str(HERE), device=device, model=model, dtype=dtype,
                batch=batch, seq=seq, rows=batch * steps, steps=steps,
                save_every=save_every, seed=11)


def uninterrupted_losses(device, config: dict) -> list:
    """The trainer's loop in this process, without checkpoints: the loss
    of every step."""
    from tpu_task_torch.ml import train
    from tpu_task_torch.ml.data import epoch_batches, prefetch_to_device
    from tpu_task_torch.ml.models import transformer

    cfg = transformer.TransformerConfig(dtype=getattr(torch,
                                                      config["dtype"]),
                                        **config["model"])
    state = train.init_state(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    tokens = np.random.default_rng(config["seed"]).integers(
        0, cfg.vocab_size, size=(config["rows"], config["seq"] + 1))
    batches = prefetch_to_device(epoch_batches(
        tokens, None, config["batch"], seed=config["seed"]), device)
    step, out = train.make_train_step(cfg), []
    for _ in range(config["steps"]):
        state, m = step(state, next(batches))
        out.append(m["loss"].item())
    return out


def phase_train_resume_process(device, smi: str, root: Path) -> dict:
    """The trainer as its own process on the card: SIGKILLed once its first
    LATEST_SHARDED is published, which must come before its last step,
    started again; it must restore that step and continue the
    uninterrupted run's losses."""
    workdir = root / "resume"
    workdir.mkdir()
    config = trainer_config(device.type, TRAIN_FLAGSHIP, "bfloat16",
                            TRAIN_BATCH, TRAIN_SEQ, RESUME_STEPS,
                            RESUME_SAVE_EVERY)
    reference = uninterrupted_losses(device, config)
    torch.cuda.empty_cache()
    first, _, killed_at = run_trainer(workdir, config, "first.log",
                                      kill_after_publish=True)
    # The restarted trainer saves nothing: its loop and restore are what
    # is checked, and four more 2.4 GB writes held its exit ~15 s.
    second, t_spawn, _ = run_trainer(
        workdir, dict(config, save_every=RESUME_STEPS + 1), "second.log")
    at = {e["event"]: e for e in reversed(second)}
    steps = [e for e in second if e["event"] == "step"]
    restored = at.get("restored", {})
    start = restored.get("step")
    rel = max((abs(e["loss"] - reference[e["step"] - 1])
               / abs(reference[e["step"] - 1]) for e in steps),
              default=math.inf)
    n_steps = len(steps)
    killed_after = max((e["step"] for e in first if e["event"] == "step"),
                       default=None)
    launches = at.get("done", {}).get("launches", {})
    want = {name: n_steps * TRAIN_FLAGSHIP["n_layers"] for name in
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    line = dict(
        ok=killed_at is not None and killed_after is not None
        and killed_at <= killed_after < RESUME_STEPS
        and start == killed_at
        and [e["step"] for e in steps] == list(range(start + 1,
                                                     RESUME_STEPS + 1))
        and rel <= RESUME_LOSS_RTOL
        and all(launches.get(k) == v for k, v in want.items())
        and all(launches.get(k) == 0 for k in
                ("plain_fwd", "plain_bwd", "plain_mha")),
        steps=RESUME_STEPS, save_every=RESUME_SAVE_EVERY,
        killed_after_step=killed_after, published_at_kill=killed_at,
        steps_lost=None if None in (killed_after, killed_at)
        else killed_after - killed_at, restored_from=start,
        recovery_s=dict(
            to_imported=at["imported"]["t"] - t_spawn,
            to_device_ready=at["device_ready"]["t"] - t_spawn,
            npz_read=restored.get("read_s"),
            host_to_device=restored.get("host_to_device_s"),
            to_restored=restored["t"] - t_spawn if restored else None,
            to_first_step_done=steps[0]["t"] - t_spawn if steps else None),
        restored_bytes=restored.get("bytes"),
        losses=[e["loss"] for e in steps], uninterrupted_losses=reference,
        max_loss_rel_diff=rel, tolerance=f"losses {RESUME_LOSS_RTOL} rel",
        launches=launches, gpu=smi)
    emit("train_resume_process", **line)
    if not line["ok"]:
        raise AssertionError(f"resumed trainer failed its gates: {line}")
    return launches


FLASH_KERNEL_NAMES = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                      "flash_bwd_dkv_wgmma_kernel")


def phase_train_profile_window(device, smi: str, root: Path) -> dict:
    """``profiling.step_window`` over flagship steps 1 and 2 of 0-3: one
    trace a step, each naming the three flash kernels."""
    from tpu_task_torch.ml import profiling, train
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.ops import attention as fa

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16,
                                        **TRAIN_FLAGSHIP)
    state = train.init_state(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    step = train.make_train_step(cfg)
    log_dir = root / "profile"
    fa.reset_launch_counts()
    for i in range(4):
        with profiling.step_window(i, start=1, stop=3, log_dir=str(log_dir)):
            with profiling.annotate(f"train-step-{i}"):
                prime_tracer(device)
                state, _ = step(state, train_tokens(cfg, device, i))
                torch.cuda.synchronize()
    counts = flash_counts()
    traces = sorted(log_dir.glob("trace-*-cuda.json"))
    found = []
    for path in traces:
        events = json.loads(path.read_text()).get("traceEvents", [])
        kernels = [e.get("name", "") for e in events
                   if e.get("cat") == "kernel"]
        found.append({
            "kernels": len(kernels),
            "flash": {n: sum(n in k for k in kernels)
                      for n in FLASH_KERNEL_NAMES},
            "annotated": sorted({e["name"] for e in events
                                 if str(e.get("name", "")).startswith(
                                     "train-step-")})})
    summary = profiling.device_memory_summary()
    line = dict(
        ok=len(traces) == 2 and bool(summary) and all(
            f["flash"][n] >= cfg.n_layers for f in found
            for n in FLASH_KERNEL_NAMES),
        traces=[p.name for p in traces], per_trace=found,
        device_memory_summary=summary, launches=counts, gpu=smi)
    emit("train_profile_window", **line)
    if not line["ok"]:
        raise AssertionError(f"profile window failed its gates: {line}")
    return counts


# -- quantized KV: both paged kernels ------------------------------------------

#: (name, geometry) of the kernel_quant cases: the flagship's, and the head
#: dims and block sizes of the tiny and micro presets.
QUANT_GEOMETRIES = (("flagship", dict(h=8, kv=2, d=128, bs=16)),
                    ("d16", dict(h=8, kv=4, d=16, bs=8)),
                    ("d8", dict(h=4, kv=2, d=8, bs=4)))
#: Pool storage types; None is the model dtype (q's own).
KV_STORAGE = (None, "int8", "fp8", "int4")
PAGED_KERNELS = ("paged_decode", "paged_decode_pipelined")


def quant_args(gen, depths, *, w, h, kv, d, bs, max_blocks, q_dtype,
               kv_dtype, device) -> list:
    """``paged_case``'s inputs in fp32, the pools turned into ``kv_dtype``
    codes and scales by the port's ``quantize_blocks`` (None: pools in q's
    dtype, no scales), q in ``q_dtype``."""
    from tpu_task_torch.ml.serving import cache

    q, kp, vp, tables, pos = paged_case(
        gen, depths, w=w, h=h, kv=kv, d=d, bs=bs, max_blocks=max_blocks,
        dtype=torch.float32, device=device)
    if kv_dtype is None:
        return [q.to(q_dtype), kp.to(q_dtype), vp.to(q_dtype), tables, pos]
    code = cache.kv_code_dtype(kv_dtype)
    (kc, ks), (vc, vs) = (cache.quantize_blocks(p, code) for p in (kp, vp))
    return [q.to(q_dtype), kc, vc, tables, pos, ks, vs]


def paged_kernel(name: str):
    from tpu_task_torch.ml.ops import paged_attention as pa

    return {"paged_decode": pa.paged_decode_attention,
            "paged_decode_pipelined": pa.paged_decode_pipelined_attention}[name]


def same_bytes(a, b) -> bool:
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def storage_name(kv_dtype, q_dtype) -> str:
    return kv_dtype or str(q_dtype).replace("torch.", "")


def phase_kernel_quant(device) -> dict:
    """Both paged kernels against the plain version on the same codes, each
    also at forced split counts (``check_splits``): the tile kernel's
    quantized variants (its model-dtype ones are phase 3's) and the
    pipelined kernel over every storage type, its tensor-core path (bf16
    queries, d 128 and 16) and its scalar one (fp32 queries, d 8). One line
    per (kernel, storage, q dtype); returns each kernel's largest fp32
    error, the combine kernel's under ``"paged_decode_combine"``."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    flagship = QUANT_GEOMETRIES[0][1]
    cases = [(name, geo, 24, w, 2048, 2048 // geo["bs"])
             for name, geo in QUANT_GEOMETRIES for w in (1, 3)]
    cases += [(case, flagship, rows, w, depth, max_blocks)
              for case, rows, w, depth, max_blocks in KERNEL_CASES
              if case != "deep"]
    worst = {name: 0.0 for name in PAGED_KERNELS + ("paged_decode_combine",)}
    summary = {}
    for case, geo, rows, w, depth, max_blocks in cases:
        depths = [None if r % 6 == 5 else int(rng.integers(0, depth - w))
                  for r in range(rows)]
        depths[0] = depth - w                     # the deepest row
        for q_dtype in (torch.float32, torch.bfloat16):
            for kv_dtype in KV_STORAGE:
                args = quant_args(gen, depths, w=w, max_blocks=max_blocks,
                                  q_dtype=q_dtype, kv_dtype=kv_dtype,
                                  device=device, **geo)
                before = [a.clone() for a in args]
                same = pa.paged_reference_attention(*args)
                for kernel in PAGED_KERNELS:
                    if kernel == "paged_decode" and kv_dtype is None:
                        continue                  # phase 3's cases
                    got = paged_kernel(kernel)(*args)
                    torch.cuda.synchronize()
                    unchanged = all(same_bytes(a, b)
                                    for a, b in zip(before, args))
                    guarded = guarded_launch(
                        args, got, pipelined=kernel != "paged_decode")
                    err = (got.float() - same.float()).abs().max().item()
                    split = check_splits(args, kernel != "paged_decode")
                    line = dict(kernel=kernel, case=case, w=w, rows=rows,
                                storage=storage_name(kv_dtype, q_dtype),
                                q_dtype=str(q_dtype).replace("torch.", ""),
                                max_abs_err=err, inputs_unchanged=unchanged,
                                writes_only_out_and_repeats=guarded, **split)
                    if q_dtype == torch.float32:
                        ok = err <= FP32_ATOL
                        worst[kernel] = max(worst[kernel], err,
                                            split.get("split_max_abs_err", 0))
                        worst["paged_decode_combine"] = max(
                            worst["paged_decode_combine"],
                            split.get("combine_max_abs_err", 0))
                    else:
                        line.update(against_fp32_plain(got, args))
                        ok = line.pop("ok") and err <= 2e-2
                    ok = ok and unchanged and guarded
                    if not ok:
                        emit("kernel_quant", ok=False, **line)
                        raise AssertionError(f"{kernel} disagrees: {line}")
                    key = (kernel, line["storage"], line["q_dtype"])
                    agg = summary.setdefault(key, dict(
                        cases=0, max_abs_err=0.0, max_abs_err_vs_fp32=0.0,
                        stage_math=[]))
                    agg["cases"] += 1
                    if kernel == "paged_decode_pipelined":
                        path = (f"{case} w{w}: tensor cores"
                                if pa.pipelined_uses_tensor_cores(*args[:2])
                                else f"{case} w{w}: scalar")
                        if path not in agg["stage_math"]:
                            agg["stage_math"].append(path)
                    agg["max_abs_err"] = max(agg["max_abs_err"], err)
                    agg["max_abs_err_vs_fp32"] = max(
                        agg["max_abs_err_vs_fp32"],
                        line.get("max_abs_err_vs_fp32", err))
                    agg["splits_checked"] = sorted(
                        set(agg.get("splits_checked", []))
                        | set(split["splits"]))
                    for name in ("split_max_abs_err",
                                 "split_states_max_rel_err",
                                 "combine_max_abs_err"):
                        agg[name] = max(agg.get(name, 0.0), split[name])
    for (kernel, storage, q_dtype), agg in summary.items():
        emit("kernel_quant", ok=True, kernel=kernel, storage=storage,
             q_dtype=q_dtype, **agg,
             geometries=[name for name, _ in QUANT_GEOMETRIES],
             widths=[1, 3],
             serve_steps=["decode step", "chunk step",
                          f"spec scoring w{SPEC_K + 1}",
                          f"spec scoring w{SPEC_K_QUANT + 1}"],
             tolerance=(f"{FP32_ATOL} vs the fp32 plain version"
                        if q_dtype == "float32" else
                        "2^-8*|fp32 ref| + 1e-5, and 2e-2 vs the bf16 plain "
                        "version"),
             writes_only_out_and_repeats=True, inputs_unchanged=True)
    return worst


def phase_timing_quant(device, smi: str) -> dict:
    """Both paged kernels over each storage type at the flagship decode
    shape (bf16 queries, depth 1024, tables 72 wide) at batch 1, 16 and 32
    and at the serve run's 144-row chunk step, beside the plain version,
    SDPA over the view dequantized to bf16 ahead of time (the
    dequantization is not in ``library_ms``), the bytes bound, each
    kernel's split plan and CTAs and its time at one split
    (``unsplit_ms``); then the pipelined kernel's int8 batch-16 wrapper
    calls traced apart into the split walk and the combine. Returns
    {kernel: {storage: {rows: row}}}."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    timer = DeviceTimer(device)
    gen = torch.Generator().manual_seed(6)
    rng = np.random.default_rng(6)
    out = {name: {} for name in PAGED_KERNELS}
    for kv_dtype in KV_STORAGE:
        storage = storage_name(kv_dtype, torch.bfloat16)
        for rows in TIMED_ROWS:
            args, library, n_bytes, flops = timed_case(gen, rng, rows,
                                                       kv_dtype, device)

            def plain():
                return pa.paged_reference_attention(*args)

            plain_ms, library_ms = timer(plain), timer(library)
            row_common = dict(
                shape=shape_name(rows), batch=rows,
                depth="ragged up to 1151" if rows == CHUNK_ROWS else 1024,
                q_dtype="bfloat16", storage=storage, plain_ms=plain_ms,
                library_ms=library_ms,
                library_note="SDPA over the gathered view already "
                             "dequantized to bf16; the dequantization is "
                             "not timed",
                **bound(n_bytes, flops), gpu=smi)
            for kernel in PAGED_KERNELS:
                fn = paged_kernel(kernel)
                got = fn(*args)
                check = against_fp32_plain(got, args)
                lib_err = (library().transpose(1, 2).float()
                           - got.float()).abs().max().item()
                if not check.pop("ok") or lib_err > 2e-2:
                    raise AssertionError(
                        f"{kernel} or SDPA yardstick disagrees at {storage} "
                        f"{shape_name(rows)}: {check}, SDPA {lib_err}")
                pipelined = kernel == "paged_decode_pipelined"
                splits = pa.planned_splits(args[0], args[1], args[3].shape[1],
                                           pipelined=pipelined)
                row = dict(kernel=kernel, splits=splits,
                           ctas=rows * args[1].shape[2] * splits,
                           ms=timer(lambda: fn(*args)),
                           unsplit_ms=unsplit_ms(timer, args, pipelined),
                           host_ms=host_ms(lambda: fn(*args)),
                           library_max_abs_diff=lib_err, **check,
                           **row_common)
                if pipelined:
                    row["tensor_cores"] = pa.pipelined_uses_tensor_cores(
                        *args[:2])
                row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
                emit("timing_quant", **row)
                out[kernel].setdefault(storage, {})[rows] = row
                if pipelined and rows == 16 and kv_dtype == "int8":
                    profile_wrapper(timer, lambda: fn(*args), row, smi,
                                    name=kernel)
    return out


#: The INT8_PIN geometry of ``tests/test_paged_attention.py``: its model
#: and engine configuration.
INT8_PIN = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=4,
                d_head=16, d_ff=256, n_kv_heads=2)
INT8_PIN_SERVING = dict(slots=3, block_size=4, n_blocks=32, max_len=48,
                        chunk_tokens=6)


def parity_engines(preset: str, serving: dict, device):
    """An fp32 engine of a preset (``build_engine``) or of the INT8_PIN
    geometry (random weights from a seeded torch Generator)."""
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.serve.replica import build_engine

    if preset != "int8_pin":
        return build_engine(preset, serving=serving, device=device)
    cfg = transformer.TransformerConfig(dtype=torch.float32, **INT8_PIN)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    return ServingEngine(params, cfg,
                         ServingConfig(**{**INT8_PIN_SERVING, **serving}),
                         device=device)


def phase_parity_quant(device) -> None:
    """For each kv_dtype, the engine's streams through both kernels and
    the plain version are equal, with the prefix cache, copy-on-write and
    (with the small pool) preemption; each fused step launches its
    kernel once per layer and nothing else."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    for preset, small in (("micro", 14), ("tiny", 8), ("int8_pin", 12)):
        for kv_dtype in ("int8", "fp8", "int4"):
            for n_blocks in (None, small):
                outs, stats = {}, {}
                for impl in ("cuda", "pipelined", "reference"):
                    serving = {"decode_impl": impl, "kv_dtype": kv_dtype}
                    if n_blocks:
                        serving["n_blocks"] = n_blocks
                    engine = parity_engines(preset, serving, device)
                    waves = _parity_waves(engine.cfg.vocab_size,
                                          engine.scfg.block_size)
                    pa.reset_launch_counts()
                    for wave in waves:
                        for prompt, max_new, kw in wave:
                            engine.submit(prompt, max_new, **kw)
                        outs[impl] = engine.drain(max_steps=5000)
                    stats[impl] = s = engine.stats()
                    fused = engine.chunk_steps + engine.decode_steps
                    want = {name: 0 for name in s["attention_launches"]}
                    want[impl] = engine.cfg.n_layers * fused
                    if s["attention_launches"] != want:
                        raise AssertionError(
                            f"{preset}/{kv_dtype}/{impl}: launches "
                            f"{s['attention_launches']}, expected {want}")
                if not outs["cuda"] == outs["pipelined"] == outs["reference"]:
                    raise AssertionError(f"{preset}/{kv_dtype}: streams differ "
                                         "between the kernels and the plain "
                                         "version")
                s = stats["pipelined"]
                if n_blocks and not s["recompute_preemptions"]:
                    raise AssertionError(f"{preset}/{kv_dtype}: the small "
                                         "pool never preempted")
                if not n_blocks and not s["prefix_cache"]["cow_copies"]:
                    raise AssertionError(f"{preset}/{kv_dtype}: no "
                                         "copy-on-write")
                emit("parity_quant", ok=True, preset=preset,
                     kv_dtype=kv_dtype,
                     n_blocks=n_blocks or engine.scfg.n_blocks,
                     requests=len(outs["cuda"]),
                     impls=["cuda", "pipelined", "reference"],
                     preemptions=s["recompute_preemptions"],
                     prefix_hit_requests=s["prefix_cache"]["hit_requests"],
                     cow_copies=s["prefix_cache"]["cow_copies"],
                     quantized_block_writes=s["kv_quant"][
                         "quantized_block_writes"],
                     chunk_steps=s["chunk_steps"],
                     decode_steps=s["decode_steps"])


# -- speculative decoding -------------------------------------------------------

#: The random-init draft of the ``half`` serve_spec run, the accept floor:
#: ``bench.py``'s ``half`` draft at the flagship's vocab, 2 layers of d_model
#: 512 (4 heads of 128 over 1 kv head, d_ff 2048).
HALF_DRAFT = dict(vocab_size=32768, d_model=512, n_layers=2, n_heads=4,
                  d_head=128, d_ff=2048, n_kv_heads=1)
SPEC_KINDS = ("target chunk", "target scoring", "draft decode",
              "draft catch-up")


class SpecProbe:
    """For one speculative engine, wraps the model functions its steps call
    (as ``checked_step`` does) and the serving model's ``paged_attention``,
    keyed by call site: a target chunk step, the target's scoring step, a
    draft decode step, a draft catch-up. Counts each site's calls, times
    each round's catch-up, proposals and scoring (every one ends in a
    readback; the scoring is synchronized here), checks every step's
    features and logits finite on the card without a host sync, sums the
    combine launches the split plan predicts for every attention call,
    and, while ``armed``, keeps layer 0's attention inputs and output of
    the first call of each site (of the last target chunk step) to hold
    against the fp32 plain version. Use as a context manager."""

    def __init__(self, engine):
        self.engine = engine
        self.kind, self.layer, self.armed = None, 0, False
        self.steps = {}
        self.finite = torch.ones((), dtype=torch.bool, device=engine.device)
        self.reset()

    def reset(self) -> None:
        self.calls = dict.fromkeys(SPEC_KINDS, 0)
        self.attn_calls = dict.fromkeys(SPEC_KINDS, 0)
        self.expected_combines = 0
        self.rounds = []               # per round: ms of each part, tokens
        self._part = None

    def __enter__(self):
        from tpu_task_torch.ml.serving import engine as serving_engine
        from tpu_task_torch.ml.serving import model as serving_model

        eng = self.engine
        self._saved = []

        def patch(module, name, wrapper):
            self._saved.append((module, name, getattr(module, name)))
            setattr(module, name, wrapper(getattr(module, name)))

        def site(kind_of, timed=None):
            def wrap(fn):
                def call(*args, **kwargs):
                    kind = kind_of(args)
                    self.kind, self.layer = kind, 0
                    self.calls[kind] += 1
                    t0 = time.perf_counter()
                    try:
                        out = fn(*args, **kwargs)
                        if timed and self._part is not None:
                            torch.cuda.synchronize()
                            self._part[timed] += \
                                (time.perf_counter() - t0) * 1e3
                        return out
                    finally:
                        self.kind = None
                return call
            return wrap

        def finite(fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                t = out[0] if isinstance(out, tuple) else out
                self.finite.logical_and_(torch.isfinite(t).all())
                return out
            return call

        patch(serving_engine, "greedy_decode_step", site(
            lambda a: ("draft decode" if a[6] is eng._draft_pools
                       else "target chunk")))
        patch(serving_engine, "decode_and_sample",
              site(lambda a: "target chunk"))
        patch(serving_engine, "chunked_step_greedy",
              site(lambda a: "draft catch-up"))
        for name in ("spec_score_greedy", "spec_score_probs"):
            patch(serving_engine, name,
                  site(lambda a: "target scoring", timed="scoring"))
        for name in ("_multitoken_features", "paged_decode_step",
                     "paged_multitoken_logits"):
            patch(serving_model, name, finite)
        patch(serving_model, "paged_attention", self._attention)
        for name, part in (("_draft_catchup", "catch-up"),
                           ("_draft_propose", "propose")):
            setattr(eng, name, self._timed_part(getattr(eng, name), part))
        eng._spec_step = self._timed_round(eng._spec_step)
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        for name in ("_draft_catchup", "_draft_propose", "_spec_step"):
            delattr(self.engine, name)
        return False

    def _attention(self, fn):
        from tpu_task_torch.ml.ops import paged_attention as pa

        def call(q, k_pool, v_pool, tables, pos, *scales, impl, **kwargs):
            out = fn(q, k_pool, v_pool, tables, pos, *scales, impl=impl,
                     **kwargs)
            kind, layer = self.kind, self.layer
            self.layer += 1
            self.attn_calls[kind] += 1
            if impl != "reference":
                self.expected_combines += pa.planned_splits(
                    q, k_pool, tables.shape[1],
                    pipelined=impl == "pipelined") > 1
            if self.armed and layer == 0 and (
                    kind not in self.steps or kind == "target chunk"):
                args = (q, k_pool, v_pool, tables, pos) + tuple(
                    s for s in scales if s is not None)
                self.steps[kind] = ([a.clone() for a in args], out.clone())
            return out
        return call

    def _timed_part(self, fn, part):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            if self._part is not None:
                self._part[part] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    def _timed_round(self, fn):
        eng = self.engine

        def call(finished):
            self._part = dict.fromkeys(("catch-up", "propose", "scoring"),
                                       0.0)
            rounds, emitted = eng.spec_rounds, eng.goodput.tokens_emitted
            live = sum(r is not None and not eng._prefilling(i)
                       for i, r in enumerate(eng._slots))
            t0 = time.perf_counter()
            try:
                fn(finished)
            finally:
                wall = (time.perf_counter() - t0) * 1e3
                part, self._part = self._part, None
            if eng.spec_rounds > rounds:
                self.rounds.append(dict(
                    wall_ms=wall, tokens=eng.goodput.tokens_emitted - emitted,
                    live_slots=live, **part))
        return call


def attention_launches() -> dict:
    from tpu_task_torch.ml.ops import paged_attention as pa

    return {"cuda": (pa.paged_decode_attention.launches,
                     pa.paged_decode_attention.combine_launches),
            "pipelined": (pa.paged_decode_pipelined_attention.launches,
                          pa.paged_decode_pipelined_attention
                          .combine_launches),
            "reference": (pa.paged_reference_attention.launches, 0)}


def spec_launch_check(engine, probe, chunk_steps: int, rounds: int) -> dict:
    """The launches since the last ``reset_launch_counts`` against what the
    run's calls need: the engine's paged attention once a layer of every
    target chunk and scoring step and of every draft decode and catch-up
    call, its combine wherever the plan splits that call, and nothing
    through the other kernel or the plain version (or, for the plain
    version, nothing through either kernel)."""
    counts = attention_launches()
    launches, combines = counts.pop(engine.decode_impl)
    other = sum(n + c for n, c in counts.values())
    expected = (engine.cfg.n_layers * (chunk_steps + rounds)
                + engine.draft_cfg.n_layers * (probe.calls["draft decode"]
                                               + probe.calls["draft catch-up"]))
    return dict(
        kernel=engine.decode_impl, kernel_launches=launches,
        expected_launches=expected, combine_launches=combines,
        expected_combine_launches=probe.expected_combines,
        other_kernel_launches=other,
        draft_decode_calls=probe.calls["draft decode"],
        draft_catchup_calls=probe.calls["draft catch-up"],
        target_attention_calls=probe.attn_calls["target chunk"]
        + probe.attn_calls["target scoring"],
        draft_attention_calls=probe.attn_calls["draft decode"]
        + probe.attn_calls["draft catch-up"],
        launches_ok=(launches == expected > 0 and other == 0
                     and combines == probe.expected_combines
                     and probe.calls["target chunk"] == chunk_steps
                     and probe.calls["target scoring"] == rounds))


def spec_engine(params, cfg, scfg, device, draft):
    from tpu_task_torch.ml import random as jrandom
    from tpu_task_torch.ml.serving.engine import ServingEngine

    draft_cfg, draft_params = draft
    return ServingEngine(params, cfg, scfg, rng=jrandom.PRNGKey(0),
                         device=device, draft_params=draft_params,
                         draft_cfg=draft_cfg)


def phase_parity_spec(device) -> None:
    """The spec engine on ``micro`` and ``tiny`` at fp32, ``spec_k`` 2, with
    the target as its own draft and with a differently seeded model of the
    same preset: streams through the kernel equal those through the plain
    version, greedy ones equal ``spec_k = 0``'s and ``generate``'s, the
    launches match what the run's calls need (0 plain), and the self
    draft accepts over 90% of its proposals on the waves' greedy
    requests."""
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.models.decoding import generate
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.serve.replica import SERVING_PRESETS, build_engine

    for preset in ("micro", "tiny"):
        base = build_engine(preset, device=device)
        cfg, params = base.cfg, base.params
        waves = _parity_waves(cfg.vocab_size, base.scfg.block_size)
        for wave in waves:
            for prompt, max_new, kw in wave:
                base.submit(prompt, max_new, **kw)
            plain = base.drain(max_steps=5000)
        greedy = [(rid, prompt, max_new) for rid, (prompt, max_new, kw)
                  in enumerate(w for wave in waves for w in wave) if not kw]
        for rid, prompt, max_new in greedy:
            ref = generate(params, cfg, prompt[None], max_new,
                           device=device)[0].tolist()
            if plain[rid] != ref:
                raise AssertionError(f"{preset}: spec_k 0 request {rid} "
                                     f"differs from generate")
        seeded = transformer.params_to(transformer.init(
            torch.Generator().manual_seed(1), cfg), device)
        for name, draft in (("self", (cfg, params)), ("seeded",
                                                      (cfg, seeded))):
            outs, lines = {}, {}
            for impl in ("cuda", "reference"):
                scfg = ServingConfig(**{**SERVING_PRESETS[preset],
                                        "decode_impl": impl, "spec_k": 2})
                engine = spec_engine(params, cfg, scfg, device, draft)
                pa.reset_launch_counts()
                with SpecProbe(engine) as probe:
                    for wave in waves:
                        for prompt, max_new, kw in wave:
                            engine.submit(prompt, max_new, **kw)
                        outs[impl] = engine.drain(max_steps=5000)
                s = engine.stats()
                lines[impl] = check = spec_launch_check(
                    engine, probe, engine.chunk_steps, engine.spec_rounds)
                if not (check["launches_ok"] and bool(probe.finite)
                        and s["draft_decode_impl"] == impl):
                    raise AssertionError(f"{preset}/{name}/{impl}: launches "
                                         f"or logits fail: {check}")
            if outs["cuda"] != outs["reference"]:
                raise AssertionError(f"{preset}/{name}: kernel and plain "
                                     "spec streams differ")
            if any(outs["cuda"][rid] != plain[rid] for rid, _, _ in greedy):
                raise AssertionError(f"{preset}/{name}: a greedy spec stream "
                                     "differs from spec_k 0's")
            line = dict(preset=preset, draft=name, spec_k=2,
                        requests=len(outs["cuda"]),
                        greedy_vs_spec_off_and_generate=len(greedy),
                        spec=s["spec"], chunk_steps=s["chunk_steps"],
                        **{f"{key}_{impl}": check[key]
                           for impl, check in lines.items()
                           for key in ("kernel_launches",
                                       "expected_launches",
                                       "combine_launches",
                                       "other_kernel_launches",
                                       "draft_decode_calls",
                                       "draft_catchup_calls")})
            if name == "self":
                # The waves' greedy requests alone: a draft that is the
                # target should agree with nearly every proposal.
                scfg = ServingConfig(**{**SERVING_PRESETS[preset],
                                        "decode_impl": "cuda", "spec_k": 2})
                engine = spec_engine(params, cfg, scfg, device, draft)
                for _, prompt, max_new in greedy:
                    engine.submit(prompt, max_new)
                engine.drain(max_steps=5000)
                line["greedy_only_accept_rate"] = rate = \
                    engine.stats()["spec"]["accept_rate"]
                if not rate > 0.9:
                    raise AssertionError(f"{preset}: the self draft accepts "
                                         f"{rate} of its greedy proposals")
            emit("parity_spec", ok=True, **line)


def pool_bytes(pools) -> int:
    return sum(t.numel() * t.element_size() for layer in pools
               for t in layer.values())


def top2_gap(engine, req, upto: int) -> float:
    """The target's top-2 logit gap after the prompt and ``upto`` tokens
    of ``req``'s stream: a plain forward of the context (``transformer.
    apply``'s), whose every layer adds ``apply_lora`` of its input when the
    request decodes under an adapter."""
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.serving.lora import apply_lora

    cfg, params = engine.cfg, engine.params
    ids = np.concatenate([req.prompt, np.asarray(req.tokens[:upto],
                                                 np.int32)])
    entry = engine._adapters.get(req.adapter_id) if req.adapter_id else None

    def attn_fn(q, k, v):
        return transformer.dot_product_attention(
            q, transformer.expand_kv(k, cfg.n_heads),
            transformer.expand_kv(v, cfg.n_heads), True)

    with torch.no_grad():
        x = transformer.embed_lookup(
            params["embed"].to(cfg.dtype),
            torch.as_tensor(ids, device=engine.device)[None])
        for i, layer in enumerate(params["layers"]):
            x_in = x
            x, _aux = transformer._block(x, layer, cfg, attn_fn)
            if entry is not None:
                x = x + apply_lora(
                    x_in, engine._lora_pool,
                    torch.tensor([entry["blocks"][i]], device=engine.device),
                    torch.tensor([entry["scale"]], device=engine.device))
        x = transformer._rmsnorm(x, params["final_norm"])
        logits = (x @ params["unembed"].to(cfg.dtype)).to(
            torch.float32)[0, -1]
    top = logits.topk(2).values
    return float(top[0] - top[1])


def spec_wave(engine, probe, seed: int, reference: dict) -> dict:
    """One wave of ``_submit_wave``'s traffic through a spec engine, its
    launch counts and goodput meter set to 0 just before and read just
    after. ``reference`` holds the non-spec serve engine's streams by
    seed: greedy streams equal to them are counted, and each that differs
    gives its first differing position and the top-2 logit gap there
    (reported, not gated: bf16 scoring at 80 rows rounds apart from 16-row
    decode steps)."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    rids, prompt_tokens = _submit_wave(engine, seed)
    chunk0, rounds0 = engine.chunk_steps, engine.spec_rounds
    proposed0, accepted0 = engine.spec_proposed, engine.spec_accepted
    preempt0 = engine.preemption_count
    probe.reset()
    engine.goodput.reset()
    pa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work:
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results = [engine.request(rid) for rid in rids]
    generated = sum(len(r.tokens) for r in results)
    chunk_steps = engine.chunk_steps - chunk0
    rounds = engine.spec_rounds - rounds0
    proposed = engine.spec_proposed - proposed0
    accepted = engine.spec_accepted - accepted0
    check = spec_launch_check(engine, probe, chunk_steps, rounds)
    walls = [r["wall_ms"] for r in probe.rounds]
    parts = {part: float(np.mean([r[part] for r in probe.rounds]))
             for part in ("catch-up", "propose", "scoring")}
    round_tokens = sum(r["tokens"] for r in probe.rounds)
    same, differ = 0, []
    for i, req in enumerate(results):
        if req.temperature or seed not in reference:
            continue
        want = reference[seed][i]
        if req.tokens == want:
            same += 1
            continue
        at = next(j for j, (a, b) in enumerate(zip(req.tokens, want))
                  if a != b)
        differ.append(dict(request=i, first_differing_position=at,
                           top2_logit_gap=top2_gap(engine, req, at)))
    goodput = engine.stats()["goodput"]
    return dict(
        seed=seed, requests=len(results), prompt_tokens=prompt_tokens,
        generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        decode_phase_tokens=round_tokens,
        decode_phase_tokens_per_s=round_tokens / sum(walls) * 1e3,
        spec_rounds=rounds, chunk_steps=chunk_steps,
        mean_round_ms=float(np.mean(walls)),
        mean_round_catchup_ms=parts["catch-up"],
        mean_round_propose_ms=parts["propose"],
        mean_round_scoring_ms=parts["scoring"],
        mean_round_host_accept_ms=float(np.mean(walls)) - sum(parts.values()),
        proposed=proposed, accepted=accepted,
        accept_rate=accepted / proposed if proposed else 0.0,
        emitted_per_round=round_tokens / rounds if rounds else 0.0,
        # tokens a round commits for each slot it scored
        emitted_per_slot_round=round_tokens / max(
            1, sum(r["live_slots"] for r in probe.rounds)),
        **check, plain_launches=attention_launches()["reference"][0],
        all_finished=all(r.status == "done" and len(r.tokens) == 64
                         for r in results),
        preemptions=engine.preemption_count - preempt0,
        greedy_streams_equal_spec_off=same if seed in reference else None,
        greedy_streams_differing=differ,
        host_gap_frac=goodput["host_gap_frac"],
        goodput_ratio=goodput["ratio"],
        dispatches_per_token=goodput["dispatches_per_token"])


def serve_spec(device, smi: str, phase: str, draft_name: str, draft, seeds,
               reference: dict, **serving) -> dict:
    """A flagship spec engine with ``serving`` over SERVE_KNOBS and
    ``draft`` ((cfg, params); None: the target itself): the serve phase's
    warm-up, then one timed wave per seed, gated: every request done,
    every step's logits finite, layer 0's attention of a target scoring,
    target chunk, draft decode and draft catch-up call held against the
    fp32 plain version, the launches as the run's calls need them, and for
    the ``self`` draft more tokens accepted than rounds. Returns the phase
    line."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig

    cfg, params = flagship_model(device)
    torch.cuda.reset_peak_memory_stats()
    engine = spec_engine(params, cfg, ServingConfig(**SERVE_KNOBS, **serving),
                         device, draft or (cfg, params))
    warm_up(engine)
    runs = []
    with SpecProbe(engine) as probe:
        for seed in seeds:
            probe.armed = seed == seeds[0]
            runs.append(spec_wave(engine, probe, seed, reference))
            emit(f"{phase}_wave", draft=draft_name, **runs[-1], gpu=smi)
    steps_ok = True
    for kind, (args, out) in sorted(probe.steps.items()):
        check = against_fp32_plain(out, args)
        steps_ok = steps_ok and check["ok"]
        emit(f"{phase}_step_check", draft=draft_name, step=kind, layer=0,
             rows=int(args[0].shape[0]), w=int(args[0].shape[1]),
             deepest_position=int(args[4].max()), **check)
    checked = sorted(probe.steps)
    probe.steps.clear()
    stats = engine.stats()

    def median(key):
        return float(np.median([r[key] for r in runs]))

    line = dict(
        draft=draft_name, spec_k=engine.scfg.spec_k,
        kv_dtype=engine.scfg.kv_dtype or "bfloat16",
        decode_impl=engine.decode_impl,
        draft_decode_impl=stats["draft_decode_impl"], waves=len(runs),
        draft_layers=engine.draft_cfg.n_layers,
        draft_d_model=engine.draft_cfg.d_model,
        tokens_per_s_runs=[r["tokens_per_s"] for r in runs],
        tokens_per_s_median=median("tokens_per_s"),
        decode_phase_tokens_per_s_runs=[r["decode_phase_tokens_per_s"]
                                        for r in runs],
        mean_round_ms_median=median("mean_round_ms"),
        round_split_ms_median={
            part: median(f"mean_round_{part}_ms")
            for part in ("catchup", "propose", "scoring", "host_accept")},
        accept_rate_runs=[r["accept_rate"] for r in runs],
        emitted_per_round_runs=[r["emitted_per_round"] for r in runs],
        emitted_per_slot_round_runs=[r["emitted_per_slot_round"]
                                     for r in runs],
        spec_rounds=sum(r["spec_rounds"] for r in runs),
        chunk_steps=sum(r["chunk_steps"] for r in runs),
        kernel_launches=sum(r["kernel_launches"] for r in runs),
        combine_launches=sum(r["combine_launches"] for r in runs),
        other_kernel_launches=sum(r["other_kernel_launches"] for r in runs),
        plain_launches=sum(r["plain_launches"] for r in runs),
        greedy_streams_equal_spec_off=[r["greedy_streams_equal_spec_off"]
                                       for r in runs],
        target_kv_pool_bytes=stats["kv_pool_bytes"],
        draft_kv_pool_bytes=pool_bytes(engine._draft_pools),
        steps_checked=checked, logits_finite=bool(probe.finite),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    if engine.decode_impl == "pipelined":
        q = torch.empty((1, engine.scfg.spec_k + 1, cfg.n_heads, cfg.d_head),
                        dtype=cfg.dtype, device=device)
        line["scoring_uses_tensor_cores"] = pa.pipelined_uses_tensor_cores(
            q, engine.pools[0]["k"])
    emit(phase, **line)
    ok = (bool(probe.finite) and steps_ok
          and checked == sorted(SPEC_KINDS)
          and all(r["all_finished"] and r["launches_ok"]
                  and r["plain_launches"] == 0 for r in runs)
          and (draft_name != "self"
               or all(r["accepted"] > r["spec_rounds"] for r in runs)))
    if not ok:
        raise AssertionError(f"{phase} ({draft_name} draft) failed its "
                             f"gates: {line}")
    return line


#: Phase 18's timed waves a draft (one since phase 33 took their time).
SPEC_SEEDS = (0,)


def phase_serve_spec(device, smi: str, reference: dict) -> dict:
    """bf16 pools through the tile kernel at ``spec_k`` SPEC_K: the target
    as its own draft (the accept ceiling) and the random-init HALF_DRAFT
    (the accept floor), a timed wave each (SPEC_SEEDS). Returns the
    lines by draft."""
    from tpu_task_torch.ml.models import transformer

    half_cfg = transformer.TransformerConfig(dtype=torch.bfloat16,
                                             **HALF_DRAFT)
    half = (half_cfg, transformer.init(
        torch.Generator(device=device).manual_seed(1), half_cfg))
    return {"self": serve_spec(device, smi, "serve_spec", "self", None,
                               SPEC_SEEDS, reference, spec_k=SPEC_K),
            "half": serve_spec(device, smi, "serve_spec", "half", half,
                               SPEC_SEEDS, reference, spec_k=SPEC_K)}


def phase_serve_spec_quant(device, smi: str, reference: dict) -> dict:
    """int8 pools through the pipelined kernel at ``spec_k`` SPEC_K_QUANT
    (its scoring step on the tensor cores), the target as its own draft,
    one timed wave."""
    return serve_spec(device, smi, "serve_spec_quant", "self", None, (0,),
                      reference, spec_k=SPEC_K_QUANT, kv_dtype="int8",
                      decode_impl="pipelined")


def spec_timed_case(gen, w: int, kv_dtype, device) -> tuple:
    """The flagship scoring step's attention: 16 rows of w queries at
    positions 1024-w .. 1023 (bf16 queries, tables 72 wide), SDPA over the
    gathered view (dequantized to bf16 ahead of time for a quantized pool)
    with each query's causal mask as ``library``, and the bytes and flops
    the function needs: each row's K and V up to its last query once, the
    live blocks' scales and table entries, q in and out, the positions."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import flat_pool, gather_kv

    F = torch.nn.functional
    rows, bs, h, kv, d = 16, 16, 8, 2, 128
    args = quant_args(gen, [1024 - w] * rows, w=w, h=h, kv=kv, d=d, bs=bs,
                      max_blocks=72, q_dtype=torch.bfloat16,
                      kv_dtype=kv_dtype, device=device)
    q, kp, vp, tables, pos = args[:5]
    live = tables[:, :1024 // bs]
    if kv_dtype is None:
        kd, vd = (gather_kv(flat_pool(p), live, bs) for p in (kp, vp))
    else:
        kd, vd = (pa.dequantize_view(
            gather_kv(flat_pool(p.view(torch.uint8)), live, bs)
            .view(p.dtype), s, live, bs, torch.bfloat16)
            for p, s in ((kp, args[5]), (vp, args[6])))
    kd, vd = (t.transpose(1, 2).repeat_interleave(h // kv, dim=1)
              .contiguous() for t in (kd, vd))
    qd = q.transpose(1, 2).contiguous()              # (rows, h, w, d)
    mask = (torch.arange(kd.shape[2], device=device)
            <= pos[:, :, None])[:, None]              # (rows, 1, w, L)

    def library():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)

    blocks = rows * (1024 // bs)
    n_bytes = (rows * 1024 * kv * kp.shape[-1] * kp.element_size() * 2
               + (blocks * kv * 4 * 2 if kv_dtype else 0)
               + 2 * q.numel() * q.element_size() + blocks * 4
               + pos.numel() * 4)
    return args, library, n_bytes, 4 * h * d * int((pos + 1).sum())


def phase_timing_spec(device, smi: str) -> dict:
    """The scoring step's attention timed: the tile kernel at 16 rows x w
    SPEC_K + 1 over bf16 pools, the pipelined kernel at 16 x SPEC_K_QUANT
    + 1 over int8 (its tensor-core path), each beside its one-split time,
    the plain version, SDPA (``library_ms``) and the bound, held against
    the plain version in fp32. Returns {kernel: row}."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    timer = DeviceTimer(device)
    gen = torch.Generator().manual_seed(8)
    out = {}
    for kernel, w, kv_dtype in (("paged_decode", SPEC_K + 1, None),
                                ("paged_decode_pipelined", SPEC_K_QUANT + 1,
                                 "int8")):
        args, library, n_bytes, flops = spec_timed_case(gen, w, kv_dtype,
                                                        device)
        fn = paged_kernel(kernel)
        pipelined = kernel == "paged_decode_pipelined"
        got = fn(*args)
        check = against_fp32_plain(got, args)
        lib_err = (library().transpose(1, 2).float()
                   - got.float()).abs().max().item()
        if not check.pop("ok") or lib_err > 2e-2:
            raise AssertionError(f"{kernel} or SDPA disagrees at the scoring "
                                 f"step: {check}, SDPA {lib_err}")
        splits = pa.planned_splits(args[0], args[1], 72, pipelined=pipelined)
        row = dict(kernel=kernel, shape=f"spec scoring 16 x w{w}",
                   storage=storage_name(kv_dtype, torch.bfloat16), w=w,
                   splits=splits, ctas=16 * 2 * splits,
                   ms=timer(lambda: fn(*args)),
                   unsplit_ms=unsplit_ms(timer, args, pipelined),
                   plain_ms=timer(lambda: pa.paged_reference_attention(*args)),
                   library_ms=timer(library), **bound(n_bytes, flops),
                   library_max_abs_diff=lib_err, **check, gpu=smi)
        if pipelined:
            row["tensor_cores"] = pa.pipelined_uses_tensor_cores(*args[:2])
        row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
        emit("timing_spec", **row)
        out[kernel] = row
    return out


# -- drain and resume ---------------------------------------------------------

#: The paths phase 21 resumes through: K = 1, the K = 4 micro-step graphs
#: and speculative decoding at spec_k 2 with the target as its own draft.
RESUME_PATHS = (("k1", {}), ("micro_k4", {"micro_k": 4}),
                ("spec_k2", {"spec_k": 2}))

#: Per preset, the exporting engine's knobs and the resuming engine's pool:
#: small enough that a resumed slot is preempted (found on the CPU with the
#: plain version; the schedule is host logic, the same on the card).
RESUME_KNOBS = {"micro": (dict(slots=6, max_len=40), 12),
                "tiny": (dict(slots=6, block_size=4, max_len=48), 12)}


def _resume_wave(vocab: int):
    """Greedy and keyed-sampled requests for phase 21: 7-17 prompt tokens
    and 14 new tokens each, one greedy request with an eos token."""
    rng = np.random.default_rng(21)
    wave = []
    for i in range(6):
        kw = ({"temperature": 0.9, "top_p": 0.85, "key": [70 + i, 3]}
              if i % 2 else {})
        if i == 4:
            kw["eos_token"] = 5
        wave.append((rng.integers(0, vocab, size=7 + 2 * i), 14, kw))
    return wave


class Preemptions:
    """Wraps an engine's ``_preempt``: each victim's id, its imported
    prefix length and its tokens just after the rollback, and, when
    given, one ("victim", rid) event in ``events``."""

    def __init__(self, engine, events=None):
        self.victims = []
        inner = engine._preempt

        def preempt(slot):
            req = engine._slots[slot]
            inner(slot)
            self.victims.append((req.rid, req.resume_from, list(req.tokens)))
            if events is not None:
                events.append(("victim", req.rid))

        engine._preempt = preempt


def resume_engine(preset: str, serving: dict, device):
    """An fp32 engine of ``preset`` with ``serving``; at ``spec_k`` > 0 the
    target drafts for itself."""
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.serve.replica import SERVING_PRESETS, build_engine

    if not serving.get("spec_k"):
        return build_engine(preset, serving=serving, device=device)
    base = build_engine(preset, device=device)
    return spec_engine(base.params, base.cfg, ServingConfig(
        **{**SERVING_PRESETS[preset], **serving}), device,
        (base.cfg, base.params))


def export_part_way(preset: str, serving: dict, device) -> dict:
    """Phase 21's wave through an engine with ``serving`` until every
    request holds tokens, then an export across ``json``; the engine then
    drains on, which gives the uninterrupted streams."""
    first = resume_engine(preset, serving, device)
    wave = _resume_wave(first.cfg.vocab_size)
    rids = [first.submit(p, n, **kw) for p, n, kw in wave]
    while not all(first.request(r).tokens for r in rids):
        first.step()
    records = json.loads(json.dumps(first.export_inflight()))
    out = first.drain(max_steps=5000)
    return dict(rids=rids, records=records,
                uninterrupted=[out[r] for r in rids],
                sampled=[i for i, (_, _, kw) in enumerate(wave)
                         if "temperature" in kw])


def parity_resume_run(preset: str, serving: dict, n_blocks: int, device,
                      export: dict) -> dict:
    """``export``'s records resumed through one configuration: a fresh
    engine with ``serving`` and ``n_blocks`` (at ``micro_k`` > 1 after one
    warm-up request per program, so its K-step graphs exist before the
    resume). Launches are counted over the resume and its drain: the
    engine's paged attention once a layer of every fused call (a spec
    engine's calls counted by ``SpecProbe``), its combine where the plan
    splits, nothing through the other kernel or the plain version.
    Returns the streams and the gates' numbers."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    rids, records = export["rids"], export["records"]
    second = resume_engine(preset, {**serving, "n_blocks": n_blocks}, device)
    if second.scfg.micro_k > 1:           # capture both K-step programs
        second.submit([4, 5], 6, temperature=0.8, key=[1, 1])
        second.drain()
        second.submit([1, 2, 3], 6)
        second.drain()
    captures0 = second.stats()["step_graph"]["captures"]
    preempts = Preemptions(second)
    chunk0, decode0, micro0 = (second.chunk_steps, second.decode_steps,
                               second.micro_steps)
    rounds0 = second.spec_rounds
    pa.reset_launch_counts()
    spec = second.scfg.spec_k > 0
    probe = SpecProbe(second) if spec else contextlib.nullcontext()
    with probe:
        mapping = second.resume_inflight(records)
        out = second.drain(max_steps=5000)
    resumed = [out[mapping[r]] if r in mapping else done
               for r, done in zip(rids, export["uninterrupted"])]
    chunk_steps = second.chunk_steps - chunk0
    impl = second.decode_impl
    if spec:
        check = spec_launch_check(second, probe, chunk_steps,
                                  second.spec_rounds - rounds0)
    else:
        micro = second.micro_steps - micro0
        calls = chunk_steps + (second.decode_steps - decode0 - micro
                               + second.scfg.micro_k * micro)
        counts = attention_launches()
        launches, combines = counts.pop(impl)
        other = sum(n + c for n, c in counts.values())
        plans = step_splits(second) if impl != "reference" else {}
        want = second.cfg.n_layers * calls
        check = dict(kernel=impl, kernel_launches=launches,
                     expected_launches=want, other_kernel_launches=other,
                     combine_launches=combines,
                     launches_ok=launches == want > 0 and other == 0)
        if impl != "reference":
            decode_calls = calls - chunk_steps
            check["expected_combine_launches"] = expected = \
                second.cfg.n_layers * (decode_calls * (plans["decode"] > 1)
                                       + chunk_steps * (plans["chunk"] > 1))
            check["launches_ok"] &= combines == expected
    by_len = {len(r["tokens"]): r["tokens"] for r in records}
    kept = [(floor, tokens) for _, floor, tokens in preempts.victims
            if floor]
    return dict(
        uninterrupted=export["uninterrupted"], resumed=resumed,
        sampled=export["sampled"], records=len(records),
        exported_tokens=sum(len(r["tokens"]) for r in records),
        preemptions=len(preempts.victims), resumed_preemptions=len(kept),
        rollback_kept_prefix=bool(kept) and all(
            tokens == by_len[floor] for floor, tokens in kept),
        reingested=second.stats()["goodput"]["tokens"]["reingested"],
        recaptures=second.stats()["step_graph"]["captures"] - captures0,
        finite=bool(probe.finite) if spec else True, **check)


def sla_wave(engine) -> tuple:
    """Mixed classes and deadlines through ``engine``: the events in
    order, ("admit", rid) from each step's admissions and ("victim", rid)
    from each preemption, and the streams."""
    events = []
    Preemptions(engine, events)
    rng = np.random.default_rng(5)
    sla = ({"slo_class": "best_effort"},
           {"slo_class": "premium", "deadline_s": 90.0},
           {"deadline_s": 30.0}, {"slo_class": "premium"},
           {"slo_class": "best_effort", "deadline_s": 5.0},
           {"deadline_s": 60.0}, {},
           {"slo_class": "premium", "deadline_s": 45.0})
    rids = []
    for i, extra in enumerate(sla):
        kw = {"temperature": 0.8, "key": [i, 3]} if i % 3 == 1 else {}
        rids.append(engine.submit(rng.integers(0, 64, size=6 + i), 10,
                                  **kw, **extra))
    while engine.has_work:
        events += [("admit", rid) for rid in engine.step()["admitted"]]
    return events, [engine.result(r) for r in rids]


def phase_parity_resume(device, impls=("cuda", "pipelined", "reference"),
                        presets=("micro", "tiny")) -> None:
    """Drain and resume on ``micro`` and ``tiny`` at fp32 and int8 pools,
    at K = 1, ``micro_k`` 4 and ``spec_k`` 2: one export through the first
    of ``impls``, resumed through each of them. Every resumed stream
    equals the uninterrupted one (a spec engine's
    sampled streams excepted: JAX's resumed spec engine draws the token
    at ``len(tokens)`` with the chunk step's sampler, so there the
    kernels' resumed streams are held to the plain version's), a resumed
    slot is preempted and keeps exactly its imported prefix, the launches
    are as the run's calls need them, and a resume captures no graph.
    Then one SLA wave on ``micro`` on the card and on the CPU: the same
    admissions and victims in the same order, and the same streams."""
    from tpu_task_torch.serve.replica import build_engine

    for preset in presets:
        knobs, tight = RESUME_KNOBS[preset]
        for kv_dtype in (None, "int8"):
            for path, extra in RESUME_PATHS:
                serving = {**knobs, **extra}
                if kv_dtype:
                    serving["kv_dtype"] = kv_dtype
                export = export_part_way(
                    preset, {**serving, "decode_impl": impls[0]}, device)
                runs = {impl: parity_resume_run(
                            preset, {**serving, "decode_impl": impl}, tight,
                            device, export)
                        for impl in impls}
                base = runs[impls[-1]]
                line = dict(preset=preset, kv_dtype=kv_dtype or "float32",
                            path=path, impls=list(impls),
                            records=base["records"],
                            exported_tokens=base["exported_tokens"],
                            preemptions=base["preemptions"],
                            resumed_preemptions=base["resumed_preemptions"],
                            reingested=base["reingested"],
                            **{f"{key}_{impl}": run[key]
                               for impl, run in runs.items()
                               for key in ("kernel_launches",
                                           "expected_launches",
                                           "combine_launches",
                                           "other_kernel_launches")})
                failures = []
                for impl, run in runs.items():
                    for i, (got, want) in enumerate(
                            zip(run["resumed"], run["uninterrupted"])):
                        if got != want and not (extra.get("spec_k")
                                                and i in run["sampled"]):
                            failures.append(f"{impl}: stream {i} differs "
                                            "from the uninterrupted one")
                    if run["resumed"] != base["resumed"]:
                        failures.append(f"{impl}: resumed streams differ "
                                        "from the plain version's")
                    if not (run["launches_ok"] and run["finite"]):
                        failures.append(f"{impl}: launches or logits fail")
                    if not (run["resumed_preemptions"]
                            and run["rollback_kept_prefix"]):
                        failures.append(f"{impl}: no resumed preemption, or "
                                        "a rollback past resume_from")
                    if run["recaptures"] or run["reingested"] != \
                            run["exported_tokens"]:
                        failures.append(f"{impl}: the resume recaptured a "
                                        "graph or miscounted reingest")
                emit("parity_resume", ok=not failures, **line,
                     failures=failures)
                if failures:
                    raise AssertionError(
                        f"{preset}/{kv_dtype}/{path}: {failures}")
    card = sla_wave(build_engine("micro", serving={"n_blocks": 12},
                                 device=device))
    host = sla_wave(build_engine("micro", serving={"n_blocks": 12},
                                 device="cpu"))
    victims = sum(kind == "victim" for kind, _ in card[0])
    same = card == host
    emit("parity_resume_sla", ok=same and victims > 0,
         events=len(card[0]), victims=victims,
         admission_order=[rid for kind, rid in card[0] if kind == "admit"],
         victim_order=[rid for kind, rid in card[0] if kind == "victim"],
         card_equals_cpu=same)
    if not (same and victims):
        raise AssertionError(f"the SLA wave's schedule or streams differ "
                             f"between the card and the CPU: {card} {host}")


def export_wave(engine) -> tuple:
    """Phase 6's seed-0 wave through ``engine`` until at least half its
    requests hold tokens, then one timed export. Returns the records, the
    export's ms, its JSON bytes and the wave's ids."""
    rids, _ = _submit_wave(engine, 0)
    while sum(bool(engine.request(r).tokens) for r in rids) < len(rids) // 2:
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = engine.export_inflight()
    export_ms = (time.perf_counter() - t0) * 1e3
    blob = json.dumps(records)
    return json.loads(blob), export_ms, len(blob.encode()), rids


def serve_resume(device, smi: str, phase: str, reference: dict,
                 **serving) -> dict:
    """The flagship at SERVE_KNOBS with ``serving``: one engine (after the
    serve warm-up) exports phase 6's seed-0 wave part-way, a fresh engine
    (after the warm-up) resumes the records and drains them under
    ``_timed_drain``'s gates, with layer 0's attention in the first
    re-ingest chunk step held against the fp32 plain version. Streams
    equal to ``reference`` (the uninterrupted wave's) are counted, not
    gated; each that differs gives its first differing position and the
    top-2 logit gap there. Returns the phase line."""
    from tpu_task_torch.ml.serving import model as serving_model
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg, params = flagship_model(device)
    scfg = ServingConfig(**SERVE_KNOBS, **serving)
    first = ServingEngine(params, cfg, scfg, device=device)
    warm_up(first)
    records, export_ms, record_bytes, wave_rids = export_wave(first)
    del first
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(params, cfg, scfg, device=device)
    warm_up(engine)
    attn_fn = serving_model.paged_attention
    recorder = StepRecorder(attn_fn, cfg.n_layers, scfg.slots)
    recorder.armed = True

    def first_step_only(*args, **kwargs):
        out = recorder(*args, **kwargs)
        if recorder.calls == cfg.n_layers:
            recorder.armed = False
        return out

    def load():
        mapping = engine.resume_inflight(records)
        return list(mapping.values()), sum(
            len(r["prompt"]) + len(r["tokens"]) for r in records)

    serving_model.paged_attention = first_step_only
    try:
        run = _timed_drain(engine, 0, load=load)
    finally:
        serving_model.paged_attention = attn_fn
    checks = []
    for kind, (args, out) in sorted(recorder.steps.items()):
        checks.append(dict(step=kind, rows=int(args[4].shape[0]),
                           deepest_position=int(args[4].max()),
                           **against_fp32_plain(out, args)))
    recorder.steps.clear()
    want = reference[0]
    same, differ = 0, []
    for record, rid in zip(records, run["rids"]):
        req, i = engine.request(rid), wave_rids.index(record["rid"])
        if req.tokens == want[i]:
            same += 1
            continue
        at = next(j for j, (a, b) in enumerate(zip(req.tokens, want[i]))
                  if a != b)
        differ.append(dict(request=i, sampled=bool(req.temperature),
                           first_differing_position=at,
                           resumed_from=req.resume_from,
                           top2_logit_gap=top2_gap(engine, req, at)))
    line = dict(
        kv_dtype=scfg.kv_dtype or "bfloat16", decode_impl=engine.decode_impl,
        records=len(records), record_bytes=record_bytes,
        export_ms=export_ms,
        exported_tokens=sum(len(r["tokens"]) for r in records),
        requests_holding_tokens=sum(bool(r["tokens"]) for r in records),
        reingest_chunk_steps=run["all_next_token_chunk_steps"],
        reingest_ms=run["all_next_token_ms"],
        reingested=run["goodput_tokens"]["reingested"],
        tokens_per_s=run["tokens_per_s"], wall_s=run["wall_s"],
        generated_tokens=run["generated_tokens"],
        chunk_steps=run["chunk_steps"], decode_steps=run["decode_steps"],
        mean_chunk_step_ms=run["mean_chunk_step_ms"],
        mean_decode_step_ms=run["mean_decode_step_ms"],
        kernel=run["kernel"], kernel_launches=run["kernel_launches"],
        expected_launches=run["expected_launches"],
        combine_launches=run["combine_launches"],
        expected_combine_launches=run["expected_combine_launches"],
        other_kernel_launches=run["other_kernel_launches"],
        plain_launches=run["plain_launches"], step_splits=run["step_splits"],
        preemptions=run["preemptions"], step_checks=checks,
        streams_equal_uninterrupted=same, streams_compared=len(records),
        streams_differing=differ,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    emit(phase, **line)
    ok = (wave_ok(run) and len(checks) == 1 and checks[0]["ok"]
          and checks[0]["step"] == "chunk step"
          and line["reingested"] == line["exported_tokens"]
          and line["requests_holding_tokens"] >= len(records) // 2)
    if not ok:
        raise AssertionError(f"{phase} failed its gates: {line}")
    return line


def phase_serve_resume(device, smi: str, serve_streams: dict,
                       quant_streams: dict) -> dict:
    """Drain and resume at the flagship: bf16 pools through the tile
    kernel against phase 6's wave, int8 through the pipelined kernel
    against phase 14's. Returns both phase lines."""
    return {"bf16": serve_resume(device, smi, "serve_resume",
                                 serve_streams),
            "int8": serve_resume(device, smi, "serve_resume_quant",
                                 quant_streams, kv_dtype="int8",
                                 decode_impl="pipelined")}


# -- the fleet KV seam --------------------------------------------------------

#: The serve phases' last timed wave: its blocks are the hottest in the
#: publisher's prefix cache, and phase 24 serves it again from the bucket.
KVFLEET_SEED = 2

#: Phase 23's configurations: (preset, kv_dtype, decode_impl, path knobs).
#: K = 1 through each attention for both presets and pool types, plus one
#: micro-step and one spec case.
KVFLEET_CASES = tuple(
    (preset, kv_dtype, impl, "k1", {})
    for preset in ("micro", "tiny") for kv_dtype in (None, "int8")
    for impl in ("cuda", "pipelined", "reference")) + (
    ("tiny", "int8", "pipelined", "micro_k4", {"micro_k": 4}),
    ("micro", None, "cuda", "spec_k2", {"spec_k": 2}))


def publish_hot(engine, bucket: str, source: str, wave: dict) -> dict:
    """Every hot block of ``engine``'s prefix cache into ``bucket`` through
    the port's fleet client: staged on the device, read back, written.
    Returns the blocks and bytes, each part's ms and ``wave``'s numbers
    (the publisher's own run of the wave phase 24 repeats)."""
    from tpu_task_torch.ml.serving.cache import staged_block_to_bytes
    from tpu_task_torch.serve.kvfleet import FleetKvClient
    from tpu_task_torch.storage.backends import LocalBackend

    client = FleetKvClient(LocalBackend(bucket), source)
    client.bind(engine.cfg, engine.scfg)
    hot = len(engine._pcache.hot_entries())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = client.stage(engine, limit=hot)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    payloads = [(h, staged_block_to_bytes(s)) for h, s in staged]
    t2 = time.perf_counter()
    client.ship_bytes(payloads)
    t3 = time.perf_counter()
    del staged
    return dict(
        blocks=client.published_blocks, bytes=client.bytes_shipped,
        payload_bytes=len(payloads[0][1]) if payloads else 0,
        stage_ms=(t1 - t0) * 1e3, force_ms=(t2 - t1) * 1e3,
        write_ms=(t3 - t2) * 1e3, publish_ms=(t3 - t0) * 1e3,
        namespace=client.index.namespace,
        wave=dict(streams=[engine.request(r).tokens for r in wave["rids"]],
                  prompts=[engine.request(r).prompt for r in wave["rids"]],
                  **{key: wave[key] for key in (
                      "chunk_steps", "all_next_token_ms", "tokens_per_s",
                      "wall_s")}))


def _kvfleet_wave(vocab: int, bs: int):
    """Phase 23's wave: greedy and keyed-sampled requests, two sharing a
    three-block prefix, one prompt of exactly two blocks."""
    rng = np.random.default_rng(23)
    shared = rng.integers(0, vocab, size=3 * bs)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, size=2)]),
               rng.integers(0, vocab, size=2 * bs + 3),
               np.concatenate([shared, rng.integers(0, vocab, size=bs + 1)]),
               rng.integers(0, vocab, size=2 * bs),
               rng.integers(0, vocab, size=5)]
    return [(p, 10, {"temperature": 0.9, "top_p": 0.85, "key": [60 + i, 2]}
             if i % 2 else {}) for i, p in enumerate(prompts)]


def kvfleet_engine(preset: str, serving: dict, device, client):
    """A ``preset`` engine (JAX's weights) with ``serving`` and the fleet
    client ``client``; at ``spec_k`` > 0 the target drafts for itself."""
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.serve.replica import SERVING_PRESETS, build_engine

    base = build_engine(preset, serving={"n_blocks": 2}, device=device)
    spec = serving.get("spec_k", 0) > 0
    return ServingEngine(
        base.params, base.cfg,
        ServingConfig(**{**SERVING_PRESETS[preset], **serving}),
        device=device, kv_fleet=client,
        draft_params=base.params if spec else None,
        draft_cfg=base.cfg if spec else None)


def expected_imports(index, wave, bs: int) -> int:
    """The blocks an importer of ``wave`` takes from the fleet: each
    request's chain depth in ``index`` past what an earlier request of
    the wave already brought into the local cache."""
    from tpu_task_torch.ml.serving.cache import chain_block_hashes

    local, hits = set(), 0
    for prompt, _, _ in wave:
        chain = [h.hex() for h in chain_block_hashes(prompt, bs)]
        have = 0
        while have < len(chain) and chain[have] in local:
            have += 1
        depth = index.chain_depth(chain[have:])
        hits += depth
        local.update(chain[:have + depth])
    return hits


def parity_kvfleet_run(preset: str, kv_dtype, impl: str, path: str,
                       extra: dict, device) -> dict:
    """Engine A serves phase 23's wave and publishes every hot block into
    a fresh bucket; a fresh engine B, bound to it, serves the same wave.
    Returns the gates' numbers: B's streams against A's (A imported
    nothing: its bucket was empty), B's imported blocks read back against
    the bucket's payloads, ``hit_blocks`` against the index's chain
    depths, and B's launches."""
    import tempfile

    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import (
        chain_block_hashes,
        export_block_bytes,
    )
    from tpu_task_torch.serve.kvfleet import FleetKvClient
    from tpu_task_torch.storage.backends import LocalBackend

    serving = {**extra, "decode_impl": impl}
    if kv_dtype:
        serving["kv_dtype"] = kv_dtype
    with tempfile.TemporaryDirectory(prefix="kvfleet-") as bucket:
        backend = LocalBackend(bucket)
        pub = FleetKvClient(backend, "a", refresh_interval=0.0)
        first = kvfleet_engine(preset, serving, device, pub)
        bs = first.scfg.block_size
        wave = _kvfleet_wave(first.cfg.vocab_size, bs)
        rids = [first.submit(p, n, **kw) for p, n, kw in wave]
        out = first.drain(max_steps=5000)
        unshared = [out[r] for r in rids]
        published = pub.publish(first, limit=10_000)
        client = FleetKvClient(backend, "b", refresh_interval=0.0)
        second = kvfleet_engine(preset, serving, device, client)
        client.index.refresh(force=True)
        predicted = expected_imports(client.index, wave, bs)
        pa.reset_launch_counts()
        rids = [second.submit(p, n, **kw) for p, n, kw in wave]
        out = second.drain(max_steps=5000)
        counts = attention_launches()
        torch.cuda.synchronize()
        imported = bytes_equal = 0
        for h in {h for prompt, _, _ in wave
                  for h in chain_block_hashes(prompt, bs)}:
            block = second._pcache.cached_block(h)
            if block is None or h.hex() not in client.index:
                continue
            imported += 1
            bytes_equal += export_block_bytes(second.pools, block) == \
                backend.read(client.index.block_key(h.hex()))
        fleet = second.stats()["kvfleet"]
    launches, combines = counts.pop(second.decode_impl)
    other = sum(n + c for n, c in counts.values())
    plain = counts.get("reference", (0, 0))[0]
    return dict(
        preset=preset, kv_dtype=kv_dtype or "float32", impl=impl,
        path=path, published_blocks=published,
        hit_blocks=fleet["hit_blocks"], expected_hit_blocks=predicted,
        import_requests=fleet["import_requests"],
        bytes_fetched=fleet["bytes_fetched"],
        imported_blocks_read_back=imported,
        imported_blocks_byte_equal=bytes_equal,
        streams_equal_unshared=sum(
            out[r] == want for r, want in zip(rids, unshared)),
        streams=len(rids), kernel_launches=launches,
        combine_launches=combines, other_kernel_launches=other,
        plain_launches=plain if impl != "reference" else 0,
        micro_steps=second.micro_steps, spec_rounds=second.spec_rounds)


def phase_parity_kvfleet(device) -> None:
    """The fleet KV seam on ``micro`` and ``tiny`` (JAX's weights) at fp32
    and int8 pools, through ``"cuda"``, ``"pipelined"`` and
    ``"reference"``, plus one ``micro_k`` 4 and one ``spec_k`` 2 case.
    Gates, each raising: B's streams equal A's, B's imported blocks read
    back byte-equal to the bucket's payloads, ``hit_blocks`` equals the
    index's chain depths (and is not 0), and B ran its kernel once or more
    and neither the other kernel nor the plain version."""
    for preset, kv_dtype, impl, path, extra in KVFLEET_CASES:
        run = parity_kvfleet_run(preset, kv_dtype, impl, path, extra,
                                 device)
        failures = []
        if run["streams_equal_unshared"] != run["streams"]:
            failures.append("an importer's stream differs from the "
                            "unshared engine's")
        if not (run["imported_blocks_read_back"] == run["hit_blocks"]
                == run["imported_blocks_byte_equal"]
                == run["expected_hit_blocks"] > 0):
            failures.append("imports differ from the chain depth or from "
                            "the published bytes")
        if not (run["kernel_launches"] > 0 and run["other_kernel_launches"]
                == 0 and run["plain_launches"] == 0):
            failures.append("the importer's launches miss its kernel")
        if path == "micro_k4" and not run["micro_steps"]:
            failures.append("no micro-step ran")
        if path == "spec_k2" and not run["spec_rounds"]:
            failures.append("no spec round ran")
        emit("parity_kvfleet", ok=not failures, **run, failures=failures)
        if failures:
            raise AssertionError(f"{preset}/{kv_dtype}/{impl}/{path}: "
                                 f"{failures}")


def serve_kvfleet(device, smi: str, phase: str, bucket: str,
                  published: dict, **serving) -> dict:
    """A fresh flagship engine with ``serving`` bound to ``bucket`` (the
    serve phase's publisher's blocks), after the warm-up, serves the
    publisher's last wave again under ``_timed_drain``'s gates: each
    admission's import (timed to its writes' completion), the chunk steps
    and ms until every request holds its first token against the
    publisher's, tokens/s, launches, and how many streams equal the
    publisher's (reported, each that differs with its first differing
    position and top-2 logit gap: the importer decodes its tokens in
    other step shapes than the publisher did)."""
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.serve.kvfleet import FleetKvClient
    from tpu_task_torch.storage.backends import LocalBackend

    cfg, params = flagship_model(device)
    scfg = ServingConfig(**SERVE_KNOBS, **serving)
    client = FleetKvClient(LocalBackend(bucket), phase)
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(params, cfg, scfg, device=device,
                           kv_fleet=client)
    warm_up(engine)
    client.index.refresh(force=True)
    ref = published["wave"]
    predicted = expected_imports(client.index, [
        (p, 0, None) for p in ref["prompts"]], scfg.block_size)
    imports, inner = [], engine._fleet_import

    def timed_import(ctx, have):
        t0 = time.perf_counter()
        got = inner(ctx, have)
        torch.cuda.synchronize()
        imports.append(((time.perf_counter() - t0) * 1e3, len(got)))
        return got

    engine._fleet_import = timed_import
    before = dict(engine.stats()["kvfleet"])
    run = _timed_drain(engine, KVFLEET_SEED)
    fleet = {key: value - before[key] for key, value in
             engine.stats()["kvfleet"].items() if key != "enabled"}
    same, differ = 0, []
    for i, (rid, want) in enumerate(zip(run["rids"], ref["streams"])):
        req = engine.request(rid)
        if req.tokens == want:
            same += 1
            continue
        at = next(j for j, (a, b) in enumerate(zip(req.tokens, want))
                  if a != b)
        differ.append(dict(request=i, sampled=bool(req.temperature),
                           first_differing_position=at,
                           top2_logit_gap=top2_gap(engine, req, at)))
    import_ms = [ms for ms, _ in imports]
    line = dict(
        kv_dtype=scfg.kv_dtype or "bfloat16", decode_impl=engine.decode_impl,
        published_blocks=published["blocks"],
        published_bytes=published["bytes"],
        payload_bytes=published["payload_bytes"],
        publish_ms=published["publish_ms"],
        publish_stage_ms=published["stage_ms"],
        publish_force_ms=published["force_ms"],
        publish_write_ms=published["write_ms"],
        hit_blocks=fleet["hit_blocks"], expected_hit_blocks=predicted,
        miss_blocks=fleet["miss_blocks"],
        import_requests=fleet["import_requests"],
        bytes_fetched=fleet["bytes_fetched"],
        import_ms_per_request=float(np.mean(import_ms)),
        import_ms_max=max(import_ms), import_ms_total=sum(import_ms),
        chunk_steps=run["chunk_steps"],
        publisher_chunk_steps=ref["chunk_steps"],
        all_first_token_ms=run["all_next_token_ms"],
        publisher_all_first_token_ms=ref["all_next_token_ms"],
        tokens_per_s=run["tokens_per_s"],
        publisher_tokens_per_s=ref["tokens_per_s"], wall_s=run["wall_s"],
        decode_steps=run["decode_steps"],
        mean_chunk_step_ms=run["mean_chunk_step_ms"],
        mean_decode_step_ms=run["mean_decode_step_ms"],
        kernel=run["kernel"], kernel_launches=run["kernel_launches"],
        expected_launches=run["expected_launches"],
        combine_launches=run["combine_launches"],
        expected_combine_launches=run["expected_combine_launches"],
        other_kernel_launches=run["other_kernel_launches"],
        plain_launches=run["plain_launches"],
        streams_equal_publisher=same, streams_compared=len(run["rids"]),
        streams_differing=differ, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    emit(phase, **line)
    if not (wave_ok(run) and line["hit_blocks"] == predicted > 0
            and line["import_requests"] == len(run["rids"])):
        raise AssertionError(f"{phase} failed its gates: {line}")
    return line


def phase_serve_kvfleet(device, smi: str, bucket: str, published: dict,
                        published_quant: dict) -> dict:
    """The flagship imports its own published waves: bf16 pools through
    the tile kernel (phase 6's publisher), int8 through the pipelined
    kernel (phase 14's). Returns both phase lines."""
    return {"bf16": serve_kvfleet(device, smi, "serve_kvfleet", bucket,
                                  published),
            "int8": serve_kvfleet(device, smi, "serve_kvfleet_quant", bucket,
                                  published_quant, kv_dtype="int8",
                                  decode_impl="pipelined")}


# -- the HTTP replica (phases 25 and 26) ---------------------------------------

class HttpClient:
    """This script's own loopback client of a replica: one keep-alive
    connection, JSON in and out, every status it was answered kept (a 500
    anywhere fails the phase)."""

    def __init__(self, url: str, timeout: float = 300.0):
        import http.client
        from urllib.parse import urlsplit

        parts = urlsplit(url)
        self._conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                                timeout=timeout)
        self.statuses = []

    def call(self, method: str, path: str, body=None, headers=None):
        """(status, headers, body): JSON parsed, Prometheus text as is."""
        data = None if body is None else json.dumps(body).encode()
        self._conn.request(method, path, body=data, headers={
            "Content-Type": "application/json", **(headers or {})})
        response = self._conn.getresponse()
        raw = response.read()
        self.statuses.append(response.status)
        text = response.getheader("Content-Type", "").startswith("text/plain")
        return (response.status, dict(response.getheaders()),
                raw.decode() if text else json.loads(raw))

    def stream(self, rid: int, offset: int = 0, times=None, calls=None):
        """Long-poll ``/stream`` from ``offset`` until the request is done
        or the replica drains: (the tokens past ``offset``, the last
        answer). ``times`` gets each token's arrival, ``calls`` one entry a
        poll."""
        tokens = []
        while True:
            status, _, body = self.call(
                "GET", f"/stream?rid={rid}&offset={offset + len(tokens)}"
                       f"&wait_ms=2000")
            if status != 200:
                raise AssertionError(f"/stream answered {status}: {body}")
            if times is not None:
                times.extend([time.perf_counter()] * len(body["tokens"]))
            if calls is not None:
                calls.append(1)
            tokens += body["tokens"]
            if body["status"] == "done" or body["draining"]:
                return tokens, body

    def close(self) -> None:
        self._conn.close()


def parse_prometheus(text: str) -> dict:
    """Sample name (with labels) → value, and under ``"# TYPE"`` each
    metric's type; raises on a malformed line."""
    samples, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types[name] = kind
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            samples[key] = float(value)
    samples["# TYPE"] = types
    return samples


def prometheus_ok(samples: dict) -> bool:
    """Every histogram's buckets are cumulative and its ``+Inf`` bucket is
    its ``_count``."""
    for base, kind in samples["# TYPE"].items():
        if kind != "histogram":
            continue
        count = samples.get(base + "_count")
        buckets = sorted((float(k.split('le="')[1][:-2]), v)
                         for k, v in samples.items()
                         if k.startswith(base + "_bucket{")
                         and "+Inf" not in k)
        inf = samples.get(base + '_bucket{le="+Inf"}')
        if inf != count or any(b[1] > a[1] for b, a in
                               zip(buckets, buckets[1:])) \
                or (buckets and buckets[-1][1] > count):
            return False
    return True


def prometheus_quantile(before: dict, after: dict, name: str,
                        q: float) -> float:
    """The upper bound (``le``) of the bucket that holds quantile ``q`` of
    what histogram ``name`` observed between two scrapes of ``/metrics``."""
    def buckets(samples):
        return {float(k.split('le="')[1][:-2]): v for k, v in samples.items()
                if k.startswith(f"tpu_task_{name}_bucket{{")
                and "+Inf" not in k}

    was, now = buckets(before), buckets(after)
    count = after[f"tpu_task_{name}_count"] \
        - before.get(f"tpu_task_{name}_count", 0.0)
    # cumulative counts: a bound absent in a scrape holds the last one below
    for le in sorted(now):
        below = [v for b, v in was.items() if b <= le]
        if now[le] - (max(below) if below else 0.0) >= q * count:
            return le
    return math.inf


def replica_faults(replica, asked_to_drain: bool) -> list:
    """What phases 25 and 26 fail on besides their numbers: an error the
    replica counted, a drain nobody asked for, a step loop that died."""
    errors = 0.0
    if replica.obs is not None:
        errors = replica.obs.metrics.snapshot().get(
            "replica.errors", {}).get("value", 0.0)
    faults = []
    if errors:
        faults.append(f"replica.errors {errors}")
    if replica.draining and not asked_to_drain:
        faults.append("a drain nobody asked for")
    if replica.step_error is not None:
        faults.append(f"the step loop died:\n{replica.step_error}")
    return faults


#: Phase 25's configurations: (preset, kv_dtype, decode_impl), through
#: each kernel (the CPU tests hold the replica on the plain route).
REPLICA_CASES = tuple((preset, kv_dtype, impl)
                      for preset in ("micro", "tiny")
                      for kv_dtype in (None, "int8")
                      for impl in ("cuda", "pipelined"))
#: The cases whose replica also takes a ``/profile`` capture.
PROFILED = {("tiny", None, "cuda"), ("tiny", "int8", "pipelined")}


def _replica_wave(vocab: int) -> list:
    """Phase 25's requests as ``/submit`` bodies: six prompts of 3-13
    tokens, 24 new tokens each, every other one sampled, each with the
    raw key a router would send."""
    rng = np.random.default_rng(25)
    wave = []
    for i in range(6):
        body = {"prompt": rng.integers(0, vocab, size=int(
                    rng.integers(3, 14))).tolist(),
                "max_new_tokens": 24, "key": [250 + i, 25]}
        if i % 2:
            body.update(temperature=0.8, top_p=0.9)
        wave.append(body)
    return wave


def direct_streams(engine, wave: list) -> list:
    """``wave`` (``/submit`` bodies) through ``engine`` driven directly."""
    rids = [engine.submit(b["prompt"], b["max_new_tokens"],
                          temperature=b.get("temperature", 0.0),
                          top_p=b.get("top_p"), key=b["key"])
            for b in wave]
    out = engine.drain(max_steps=5000)
    return [out[r] for r in rids]


def profile_kernels(client, replica, wave: list, impl: str) -> dict:
    """``GET /profile?ms=200`` while the replica serves ``wave`` again and
    again: the capture's Chrome trace and the paged kernels it names."""
    status, _, body = client.call("GET", "/profile?ms=200")
    if status != 200:
        raise AssertionError(f"/profile answered {status}: {body}")
    while replica._profile_thread.is_alive():
        for rid in [client.call("POST", "/submit", b)[2]["rid"]
                    for b in wave]:
            client.stream(rid)
    path = Path(body["dir"]) / "trace-cuda.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return dict(profile_trace=path.name, profile_events=len(events),
                profile_runtime_calls=sum(e.get("cat") == "cuda_runtime"
                                          for e in events),
                profile_kernels=len(names),
                profile_walks=sum(any(w in n for w in WALK_NAMES[impl])
                                  for n in names),
                profile_combines=sum(COMBINE_NAME in n for n in names))


def parity_replica_run(preset: str, kv_dtype, impl: str, device,
                       root: str) -> dict:
    """One configuration of phase 25: the wave driven directly, then over
    HTTP through replica A (trace and SLA headers, streamed by offset);
    ``/metrics`` and ``/obs``; A's published blocks prefetched by replica
    B; the wave again on A, drained once every request holds tokens and
    re-dispatched to B with its tokens and key; a 429 while draining;
    ``/profile`` where the case is in PROFILED. Both replicas share a
    fresh bucket under ``root``."""
    import tempfile

    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import chain_block_hashes
    from tpu_task_torch.obs import SLA_HEADER, TRACE_HEADER, \
        format_sla_header
    from tpu_task_torch.serve.kvfleet import FleetKvClient
    from tpu_task_torch.serve.replica import MODEL_PRESETS, \
        SERVING_PRESETS, ReplicaServer, build_engine
    from tpu_task_torch.storage.backends import LocalBackend

    serving = {"decode_impl": impl}
    if kv_dtype:
        serving["kv_dtype"] = kv_dtype
    wave = _replica_wave(MODEL_PRESETS[preset]["vocab_size"])
    want = direct_streams(build_engine(preset, serving=serving,
                                       device=device), wave)
    backend = LocalBackend(tempfile.mkdtemp(dir=root))
    clients = [FleetKvClient(backend, name, refresh_interval=0.0)
               for name in ("a", "b")]
    a, b = (ReplicaServer(preset=preset, serving=serving, device=device,
                          kv_client=client, kv_publish_every=1,
                          profile_dir=str(Path(root) / "profiles"))
            for client in clients)
    pa.reset_launch_counts()
    a.start()
    b.start()
    ca, cb = HttpClient(a.url), HttpClient(b.url)
    line = dict(preset=preset, kv_dtype=kv_dtype or "float32", impl=impl)
    try:
        headers = [{TRACE_HEADER: f"{0x25 + i:016x}:{0x250 + i:016x}",
                    SLA_HEADER: format_sla_header(
                        ("premium", "standard", "best_effort")[i % 3],
                        600_000.0)} for i in range(len(wave))]
        rids = [ca.call("POST", "/submit", body, head)[2]["rid"]
                for body, head in zip(wave, headers)]
        got = [ca.stream(rid)[0] for rid in rids]
        line["http_streams_equal_direct"] = sum(
            g == w for g, w in zip(got, want))

        _, _, text = ca.call("GET", "/metrics")
        samples = parse_prometheus(text)
        _, _, obs = ca.call("GET", "/obs")
        phases = {}
        for span, head in ((s, h) for s in obs["spans"]
                           for h in headers
                           if s["name"].startswith("engine.")
                           and s["trace_id"] == h[TRACE_HEADER][:16]):
            phases.setdefault(span["attrs"]["rid"], []).append(
                (span["name"], span["parent_id"] == head[TRACE_HEADER][17:]))
        line.update(
            metrics_samples=len(samples) - 1,
            metrics_ok=prometheus_ok(samples) and samples.get(
                "tpu_task_engine_ttft_s_count", 0) >= len(wave),
            obs_spans_per_request_ok=all(sorted(phases.get(rid, [])) == [
                ("engine.decode", True), ("engine.prefill", True),
                ("engine.queue", True)] for rid in rids))

        bs = {**SERVING_PRESETS[preset], **serving}["block_size"]
        prompt = max(wave, key=lambda body: len(body["prompt"]))["prompt"]
        chain = [h.hex() for h in chain_block_hashes(np.asarray(prompt), bs)]
        deadline = time.monotonic() + 30
        while not set(chain) <= set(clients[0]._published) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        imported = cb.call("POST", "/prefetch", {"hashes": chain})[2]
        line.update(chain_blocks=len(chain),
                    published_blocks=clients[0].published_blocks,
                    prefetch_imported=imported["imported"])

        rids = [ca.call("POST", "/submit", body)[2]["rid"] for body in wave]
        for rid in rids:
            ca.call("GET", f"/stream?rid={rid}&offset=0&wait_ms=2000")
        drain = ca.call("POST", "/drain", {})
        busy = ca.call("POST", "/submit", wave[0])
        exported = ca.call("GET", "/export")[2]["inflight"]
        prefixes = [ca.stream(rid)[0] for rid in rids]
        joined = []
        for body, prefix in zip(wave, prefixes):
            if len(prefix) < body["max_new_tokens"]:
                rid = cb.call("POST", "/submit",
                              {**body, "tokens": prefix})[2]["rid"]
                prefix = prefix + cb.stream(rid, offset=len(prefix))[0]
            joined.append(prefix)
        line.update(
            drain_status=drain[0], exported_records=len(exported),
            cut_mid_stream=sum(0 < len(p) < 24 for p in prefixes),
            joined_streams_equal=sum(j == w for j, w in zip(joined, want)),
            busy_status=busy[0], busy_retry_after=busy[1].get("Retry-After"),
            busy_draining=busy[2].get("draining"))
        if (preset, kv_dtype, impl) in PROFILED:    # A drains: B serves
            line.update(profile_kernels(cb, b, wave, impl))
    finally:
        for replica in (a, b):
            replica.stop()
        ca.close()
        cb.close()
    torch.cuda.synchronize()
    counts = attention_launches()
    launches, combines = counts.pop(impl)
    line.update(
        kernel_launches=launches, combine_launches=combines,
        other_kernel_launches=sum(n + c for n, c in counts.values()),
        faults=replica_faults(a, True) + replica_faults(b, False),
        http_500s=(ca.statuses + cb.statuses).count(500))
    return line


def replica_subprocess_run(device, root: str) -> dict:
    """``python -m tpu_task_torch.serve.replica --preset tiny --kv-bucket``
    on ``device`` with one slot: it announces ``endpoint.json``, serves
    phase 25's wave (24 new tokens a request), gets it twice more and
    SIGTERM at once, writes
    ``inflight.json`` and exits 0; a fresh engine here resumes the
    records."""
    import os
    import signal
    import tempfile

    from tpu_task_torch.serve.replica import MODEL_PRESETS, build_engine

    cwd = Path(tempfile.mkdtemp(dir=root))
    serving = {"slots": 1}
    cmd = [sys.executable, "-m", "tpu_task_torch.serve.replica",
           "--preset", "tiny", "--kv-bucket", str(cwd / "bucket"),
           "--serving", json.dumps(serving), "--device", device.type]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(cwd), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env={
                                **os.environ, "PYTHONPATH": str(HERE),
                                "TPU_TASK_SERVE_LINGER": "0.1"})
    wave = _replica_wave(MODEL_PRESETS["tiny"]["vocab_size"])
    try:
        endpoint = cwd / "endpoint.json"
        while not endpoint.exists():
            if proc.poll() is not None or time.perf_counter() - t0 > 180:
                raise AssertionError(f"the replica never announced: "
                                     f"{proc.communicate(timeout=30)}")
            time.sleep(0.05)
        announce = json.loads(endpoint.read_text())
        boot_s = time.perf_counter() - t0
        client = HttpClient(announce["url"])
        served = [client.stream(client.call("POST", "/submit", body)[2][
            "rid"])[0] for body in wave]
        stats = client.call("GET", "/stats")[2]
        rids = [client.call("POST", "/submit", body)[2]["rid"]
                for body in wave + wave]
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    drained = json.loads((cwd / "inflight.json").read_text())
    records = drained["inflight"]
    want = direct_streams(build_engine("tiny", serving=serving,
                                       device=device), wave)
    fresh = build_engine("tiny", serving=serving, device=device)
    mapping = fresh.resume_inflight(records)
    out = fresh.drain(max_steps=5000)
    blocks = list((cwd / "bucket").glob("kvfleet/*/blocks/*"))
    return dict(
        endpoint_keys=sorted(announce), boot_s=boot_s,
        returncode=proc.returncode, stderr_tail=err[-2000:],
        served_streams_equal_direct=sum(s == w for s, w in zip(served,
                                                               want)),
        device=stats["device"], decode_impl=stats["decode_impl"],
        attention_launches=stats["attention_launches"],
        drained_boot_id_ok=drained["boot_id"] == announce["boot_id"],
        records=len(records),
        records_mid_stream=sum(0 < len(r["tokens"]) for r in records),
        resumed_streams_equal=sum(
            out[mapping[r["rid"]]] == want[rids.index(r["rid"]) % len(wave)]
            for r in records),
        published_blocks=len(blocks))


def phase_parity_replica(device, cases=REPLICA_CASES) -> dict:
    """Phase 25: every case of REPLICA_CASES (``parity_replica_run``), then
    the replica as its own process (``replica_subprocess_run``). Gates,
    each raising: the HTTP streams and the drained-and-re-dispatched
    streams equal the direct ones, something was cut mid-stream, a 429
    with ``Retry-After: 0`` while draining, ``/metrics`` parses and
    ``/obs`` holds one queue, prefill and decode span a request under its
    trace header, B imports A's published chain, the capture names the
    case's kernel, the engine's kernel ran and nothing else did, and no
    fault (``replica_faults``) or 500. Returns each kernel's launches
    here."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="tpu-task-replica-")
    totals = {"cuda": 0, "pipelined": 0, "combine": 0}
    try:
        for preset, kv_dtype, impl in cases:
            run = parity_replica_run(preset, kv_dtype, impl, device, root)
            n = len(_replica_wave(8))
            failures = []
            if not (run["http_streams_equal_direct"] == n
                    == run["joined_streams_equal"]):
                failures.append("a stream over HTTP differs from the "
                                "direct engine's")
            if not (run["cut_mid_stream"] > 0 and run["drain_status"] == 200
                    and run["exported_records"] >= run["cut_mid_stream"]):
                failures.append("the drain cut nothing mid-stream")
            if (run["busy_status"], run["busy_retry_after"],
                    run["busy_draining"]) != (429, "0", True):
                failures.append("no 429 + Retry-After: 0 while draining")
            if not (run["metrics_ok"] and run["obs_spans_per_request_ok"]):
                failures.append("/metrics or /obs is wrong")
            if not run["prefetch_imported"] == run["chain_blocks"] > 0:
                failures.append("B did not import A's published chain")
            if "profile_walks" in run and not run["profile_walks"]:
                failures.append("the capture names no paged kernel")
            if not (run["kernel_launches"] > 0
                    and run["other_kernel_launches"] == 0):
                failures.append("launches miss the engine's kernel")
            if run["faults"] or run["http_500s"]:
                failures.append("a replica fault or a 500")
            emit("parity_replica", ok=not failures, **run,
                 failures=failures)
            if failures:
                raise AssertionError(f"{preset}/{kv_dtype}/{impl}: "
                                     f"{failures}: {run['faults']}")
            if impl != "reference":
                totals[impl] += run["kernel_launches"]
                totals["combine"] += run["combine_launches"]
        sub = replica_subprocess_run(device, root)
        failures = []
        if sub["endpoint_keys"] != ["boot_id", "generation", "pid",
                                    "preset", "url"]:
            failures.append("endpoint.json keys differ from JAX's")
        if sub["returncode"] != 0 or not sub["drained_boot_id_ok"]:
            failures.append("no clean drain on SIGTERM")
        if not (sub["records"] > 0
                and sub["resumed_streams_equal"] == sub["records"]
                and sub["served_streams_equal_direct"] == n):
            failures.append("served or resumed streams differ")
        launched = sub["attention_launches"]
        if device.type == "cuda" and not (launched["cuda"] > 0
                                          and launched["reference"] == 0):
            failures.append("the process's engine missed its kernel")
        emit("parity_replica_process", ok=not failures, **sub,
             failures=failures)
        if failures:
            raise AssertionError(f"replica process: {failures}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return totals


REPLICA_CLIENTS = 16


def http_wave(replica, seed: int, max_new: int = 64,
              adapter_ids=None) -> dict:
    """Phase 6's ``seed`` wave over HTTP: one client thread a request,
    each submitting with a trace header (and request i with
    ``adapter_ids[i]``, when given) and long-polling its stream, while a
    probe thread times an acquisition of the replica's lock every 10 ms.
    Returns what each client saw and the probe's waits."""
    import threading

    from tpu_task_torch.obs import TRACE_HEADER, TraceContext

    wave = _wave_requests(replica.engine.cfg.vocab_size, seed)
    start, stop = threading.Barrier(len(wave)), threading.Event()
    waits = []

    def probe():
        while not stop.wait(0.01):
            t0 = time.perf_counter()
            with replica._lock:
                pass
            waits.append(time.perf_counter() - t0)

    def client(i):
        prompt, kw = wave[i]
        body = {"prompt": prompt.tolist(), "max_new_tokens": max_new}
        if kw:
            body.update(temperature=kw["temperature"], top_p=kw["top_p"],
                        key=[int(w) for w in kw["key"]])
        if adapter_ids is not None:
            body["adapter_id"] = adapter_ids[i]
        http = HttpClient(replica.url)
        try:
            start.wait()
            t_submit = time.perf_counter()
            status, _, reply = http.call(
                "POST", "/submit", body,
                {TRACE_HEADER: TraceContext.mint().to_header()})
            times, calls = [], []
            tokens, last = http.stream(reply["rid"], times=times, calls=calls)
            return dict(tokens=tokens, status=last["status"],
                        t_submit=t_submit, times=times, polls=len(calls),
                        statuses=http.statuses)
        finally:
            http.close()

    prober = threading.Thread(target=probe, daemon=True)
    prober.start()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(wave)) as pool:
        results = list(pool.map(client, range(len(wave))))
    wall = time.perf_counter() - t0
    stop.set()
    prober.join(timeout=10)
    return dict(results=results, wall_s=wall, lock_waits=waits,
                prompt_tokens=sum(len(p) for p, _ in wave))


def serve_replica(device, smi: str, phase: str, reference: list,
                  direct_median: float, obs_turns: bool,
                  **serving) -> dict:
    """Phase 26 for one configuration: a flagship engine with ``serving``
    over SERVE_KNOBS and an ``Obs``, warmed up, wrapped in
    ``ReplicaServer(engine=...)``; one timed wave of phase 6's seed-2
    traffic from REPLICA_CLIENTS client threads over HTTP. With
    ``obs_turns``, first the engine and an obs-off twin each run two
    other waves directly, in turns (off, on, on, off)."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.obs import Obs
    from tpu_task_torch.serve.replica import ReplicaServer

    cfg, params = flagship_model(device)
    scfg = ServingConfig(**SERVE_KNOBS, **serving)
    engine = ServingEngine(params, cfg, scfg, device=device,
                           obs=Obs.create("replica:chip"))
    warm_up(engine)
    line = dict(kv_dtype=scfg.kv_dtype or "bfloat16",
                decode_impl=engine.decode_impl, clients=REPLICA_CLIENTS,
                direct_tokens_per_s_median=direct_median)
    if obs_turns:
        plain = ServingEngine(params, cfg, scfg, device=device)
        warm_up(plain)
        # Seeds 3 and 4, so the prefix cache holds none of the seed-2 wave
        # the replica serves after them.
        turns = []
        for name, eng, seed in (("off", plain, 3), ("on", engine, 3),
                                ("on", engine, 4), ("off", plain, 4)):
            run = _timed_drain(eng, seed)
            if not wave_ok(run):
                raise AssertionError(f"{phase}: a direct wave (obs {name}) "
                                     f"failed its gates: {run}")
            turns.append((name, run["tokens_per_s"]))
        del plain
        on = [t for name, t in turns if name == "on"]
        off = [t for name, t in turns if name == "off"]
        line.update(obs_turns=turns, obs_on_tokens_per_s=on,
                    obs_off_tokens_per_s=off,
                    obs_on_over_off=float(np.mean(on) / np.mean(off)))
    replica = ReplicaServer(engine=engine).start()
    try:
        http = HttpClient(replica.url)
        before = parse_prometheus(http.call("GET", "/metrics")[2])
        counters = (engine.chunk_steps, engine.decode_steps,
                    engine.micro_steps)
        pa.reset_launch_counts()
        torch.cuda.synchronize()
        wave = http_wave(replica, KVFLEET_SEED)
        torch.cuda.synchronize()
        after = parse_prometheus(http.call("GET", "/metrics")[2])
        obs = http.call("GET", "/obs")[2]["metrics"]
        statuses = http.statuses
        http.close()
    finally:
        replica.stop()
    results = wave["results"]
    chunk_steps = engine.chunk_steps - counters[0]
    micro_steps = engine.micro_steps - counters[2]
    decode_calls = (engine.decode_steps - counters[1] - micro_steps
                    + scfg.micro_k * micro_steps)
    kernels = {"cuda": pa.paged_decode_attention,
               "pipelined": pa.paged_decode_pipelined_attention}
    kernel = kernels.pop(engine.decode_impl)
    plans = step_splits(engine)
    ttft = [(r["times"][0] - r["t_submit"]) * 1e3 for r in results]
    gaps = [(b - a) * 1e3 for r in results
            for a, b in zip(r["times"], r["times"][1:])]
    generated = sum(len(r["tokens"]) for r in results)
    waits = np.asarray(wave["lock_waits"]) * 1e3
    run = dict(
        all_finished=all(r["status"] == "done" and len(r["tokens"]) == 64
                         for r in results),
        kernel_launches=kernel.launches, combine_launches=kernel.combine_launches,
        other_kernel_launches=sum(fn.launches + fn.combine_launches
                                  for fn in kernels.values()),
        plain_launches=pa.paged_reference_attention.launches,
        expected_launches=cfg.n_layers * (chunk_steps + decode_calls),
        expected_combine_launches=cfg.n_layers * (
            decode_calls * (plans["decode"] > 1)
            + chunk_steps * (plans["chunk"] > 1)))
    line.update(
        run, wall_s=wave["wall_s"], generated_tokens=generated,
        tokens_per_s=generated / wave["wall_s"],
        over_direct_median=generated / wave["wall_s"] / direct_median,
        chunk_steps=chunk_steps, decode_steps=decode_calls,
        client_ttft_ms_p50=float(np.percentile(ttft, 50)),
        client_ttft_ms_p99=float(np.percentile(ttft, 99)),
        client_ttft_ms_max=max(ttft),
        client_intertoken_ms_p50=float(np.percentile(gaps, 50)),
        client_intertoken_ms_p99=float(np.percentile(gaps, 99)),
        tokens_per_poll=generated / sum(r["polls"] for r in results),
        engine_ttft_s_p50_le=prometheus_quantile(before, after,
                                                 "engine_ttft_s", 0.5),
        engine_ttft_s_p99_le=prometheus_quantile(before, after,
                                                 "engine_ttft_s", 0.99),
        engine_ttft_s_p50_since_start=obs["engine.ttft_s"]["p50"],
        engine_ttft_s_p99_since_start=obs["engine.ttft_s"]["p99"],
        lock_probes=len(waits),
        lock_wait_ms_p50=float(np.percentile(waits, 50)) if len(waits)
        else None,
        lock_wait_ms_p99=float(np.percentile(waits, 99)) if len(waits)
        else None,
        lock_wait_ms_max=float(waits.max()) if len(waits) else None,
        streams_equal_direct_wave=sum(
            r["tokens"] == want for r, want in zip(results, reference)),
        step_splits=plans,
        faults=replica_faults(replica, False),
        http_500s=(statuses + [s for r in results
                               for s in r["statuses"]]).count(500),
        gpu=smi)
    emit(phase, **line)
    if not (wave_ok(run) and not line["faults"] and not line["http_500s"]):
        raise AssertionError(f"{phase} failed its gates: {line}")
    return line


def phase_serve_replica(device, smi: str, serve_streams: dict,
                        quant_streams: dict, medians: dict) -> dict:
    """Phase 26: the flagship behind the HTTP replica, bf16 pools through
    the tile kernel (with the obs on/off turns) and int8 through the
    pipelined kernel. Returns both phase lines."""
    return {"bf16": serve_replica(device, smi, "serve_replica",
                                  serve_streams[KVFLEET_SEED],
                                  medians["bf16"], True),
            "int8": serve_replica(device, smi, "serve_replica_quant",
                                  quant_streams[KVFLEET_SEED],
                                  medians["int8"], False, kv_dtype="int8",
                                  decode_impl="pipelined")}


# -- phase 27: the weight roll -----------------------------------------------

#: Phase 27's engine rolls: (kv_dtype, decode_impl, micro_k).
ROLL_CASES = ((None, "cuda", 1), ("int8", "pipelined", 1), (None, "cuda", 4))
#: The new wave of a roll, submitted once every old stream holds
#: ROLL_AT tokens; the old wave is phase 6's seed-2 wave.
ROLL_NEW_SEED, ROLL_AT, ROLL_NEW_MAX = 3, 8, 32
#: The share of generation 0's param bytes (the flagship serves bf16
#: weights: 377,522,176 bytes) that the last old stream's retirement must
#: free; at K = 4 its graphs go too, and generation 1's first capture may
#: land in the same step.
ROLL_FREED_SHARE = 0.9


def roll_new_params(cfg, device, seed: int):
    """The port's ``init`` from another ``torch.Generator`` seed: the
    flagship's shapes, other values."""
    from tpu_task_torch.ml.models import transformer

    return transformer.init(torch.Generator(device=device).manual_seed(seed),
                            cfg)


def engine_roll(device, smi: str, kv_dtype, impl: str, micro_k: int,
                reference: list, direct_median: float) -> dict:
    """One engine roll of phase 27: a warmed-up flagship engine serves
    phase 6's seed-2 wave at ``max_new_tokens`` 32 and 96 in turn; once
    every request holds ROLL_AT tokens, ``adopt_params(generation=1)``
    with weights from another seed; then the seed-3 wave at ROLL_NEW_MAX;
    drained. Then the seed-3 wave again on the engine, which now holds
    generation 1 alone. Launch counts from the roll's submission to its
    drain."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.ml.tree import leaves

    cfg, params = flagship_model(device)
    scfg = ServingConfig(**SERVE_KNOBS, decode_impl=impl, micro_k=micro_k,
                         **({"kv_dtype": kv_dtype} if kv_dtype else {}))
    engine = ServingEngine(params, cfg, scfg, device=device)
    del params                 # the engine holds generation 0's weights alone
    old_bytes = sum(t.numel() * t.element_size()
                    for t in leaves(engine.params))
    warm_up(engine)
    new_params = roll_new_params(cfg, device, 1)
    old_wave = _wave_requests(cfg.vocab_size, KVFLEET_SEED)
    new_wave = _wave_requests(cfg.vocab_size, ROLL_NEW_SEED)
    old_max = [(32, 96)[i % 2] for i in range(len(old_wave))]
    counters = (engine.chunk_steps, engine.decode_steps, engine.micro_steps)
    captures0 = engine.stats()["step_graph"]["captures"]
    pa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    old = [engine.submit(prompt, n, **kw)
           for (prompt, kw), n in zip(old_wave, old_max)]
    steps = []                   # (ms, generations dispatched, phase)

    def step(phase: str) -> None:
        gens = len({r.generation for r in engine._slots if r is not None})
        s0 = time.perf_counter()
        engine.step()
        steps.append(((time.perf_counter() - s0) * 1e3, gens, phase))

    while min(len(engine.request(r).tokens) for r in old) < ROLL_AT:
        step("before")
    a0 = time.perf_counter()
    engine.adopt_params(new_params, generation=1)
    adopt_ms = (time.perf_counter() - a0) * 1e3
    del new_params
    new = [engine.submit(prompt, ROLL_NEW_MAX, **kw)
           for prompt, kw in new_wave]
    freed = None
    while engine.has_work:
        stale = engine.stale_generation_streams
        before = torch.cuda.memory_allocated()
        step("roll" if stale else "after")
        if stale and not engine.stale_generation_streams:
            freed = before - torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = {g: runner.stats() for g, runner in engine._micro_graphs.items()}
    kernels = {"cuda": pa.paged_decode_attention,
               "pipelined": pa.paged_decode_pipelined_attention}
    kernel = kernels.pop(engine.decode_impl)
    chunk_steps = engine.chunk_steps - counters[0]
    micro_steps = engine.micro_steps - counters[2]
    decode_calls = (engine.decode_steps - counters[1] - micro_steps
                    + micro_k * micro_steps)
    plans = step_splits(engine)
    results = [engine.request(r) for r in old + new]
    run = dict(
        all_finished=all(r.status == "done" and len(r.tokens)
                         == r.max_new_tokens for r in results),
        kernel_launches=kernel.launches,
        combine_launches=kernel.combine_launches,
        other_kernel_launches=sum(fn.launches + fn.combine_launches
                                  for fn in kernels.values()),
        plain_launches=pa.paged_reference_attention.launches,
        expected_launches=cfg.n_layers * (chunk_steps + decode_calls),
        expected_combine_launches=cfg.n_layers * (
            decode_calls * (plans["decode"] > 1)
            + chunk_steps * (plans["chunk"] > 1)))
    stats = engine.stats()
    generated = sum(len(r.tokens) for r in results)
    new_tokens = [engine.request(r).tokens for r in new]
    alone = _timed_drain(engine, ROLL_NEW_SEED, max_new=ROLL_NEW_MAX)
    alone_tokens = [engine.request(r).tokens for r in alone["rids"]]
    roll_ms = [ms for ms, _, phase in steps if phase == "roll"]
    before_ms = [ms for ms, _, phase in steps if phase == "before"]
    line = dict(
        run, kv_dtype=scfg.kv_dtype or "bfloat16",
        decode_impl=engine.decode_impl, micro_k=micro_k,
        generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        over_phase6_median=generated / wall / direct_median,
        adopt_ms=adopt_ms, steps=len(steps),
        two_generation_steps=sum(g > 1 for _, g, _ in steps),
        roll_steps=len(roll_ms),
        max_step_ms_before_roll=max(before_ms),
        max_step_ms_mid_roll=max(roll_ms) if roll_ms else None,
        median_step_ms_mid_roll=float(np.median(roll_ms)) if roll_ms
        else None,
        old_param_bytes=old_bytes,
        freed_bytes_at_last_old_retire=freed,
        param_swaps=stats["adapters"]["param_swaps"],
        stale_generation_streams=stats["adapters"][
            "stale_generation_streams"],
        generations_held=sorted(engine._gen_params),
        graph_generations=sorted(graphs),
        graph_captures=stats["step_graph"]["captures"] - captures0,
        new_generation_capture_ms=(graphs[1]["capture_ms"]
                                   if 1 in graphs else None),
        # A report, not a gate (as phase 26's): the split plan follows
        # the step's shape, and a bf16 stream can part at a near tie.
        old_streams_equal_phase6_prefix=sum(
            engine.request(r).tokens[:64] == want[:len(
                engine.request(r).tokens[:64])]
            for r, want in zip(old, reference)),
        new_streams_equal_single_generation=sum(
            a == b for a, b in zip(new_tokens, alone_tokens)),
        single_generation_wave_ok=wave_ok(alone), gpu=smi)
    failures = []
    if not wave_ok(run):
        failures.append("a request fell short or the launches miss the "
                        "engine's kernel")
    if not line["two_generation_steps"]:
        failures.append("no step dispatched two generations")
    if (line["param_swaps"], line["stale_generation_streams"],
            line["generations_held"]) != (1, 0, [1]):
        failures.append("the roll did not end on generation 1 alone")
    if micro_k > 1 and (line["graph_generations"] != [1]
                        or line["new_generation_capture_ms"] is None):
        failures.append("generation 0's graphs outlived it, or generation "
                        "1 never captured")
    if freed is None or freed < ROLL_FREED_SHARE * old_bytes:
        failures.append(f"the last old stream's retirement freed {freed} "
                        f"of generation 0's {old_bytes} param bytes")
    if not line["single_generation_wave_ok"]:
        failures.append("the single-generation wave failed its gates")
    line["failures"] = failures
    emit("serve_roll", **line)
    if failures:
        raise AssertionError(f"serve_roll {kv_dtype}/{impl}/K{micro_k}: "
                             f"{failures}")
    return line


def replica_roll(device, smi: str, replica_line: dict) -> dict:
    """Phase 27's replica roll: a warmed-up bf16 flagship engine at K = 1
    behind ``ReplicaServer(ckpt_dir=, ckpt_poll_s=0.05)``; 16 HTTP
    clients stream phase 6's seed-2 wave while this script publishes
    steps 1 and 2 (``save_checkpoint``, weights from other seeds) into the
    directory. Gates: every stream ends with 64 tokens, ``/healthz`` names
    generation 2 and ``replica.param_rolls`` counts 2, no error and no
    500, and the engine's kernel ran and nothing else."""
    import shutil
    import threading

    from tpu_task_torch.ml.checkpoint import save_checkpoint
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.obs import Obs
    from tpu_task_torch.serve.replica import ReplicaServer

    cfg, params = flagship_model(device)
    engine = ServingEngine(params, cfg, ServingConfig(**SERVE_KNOBS),
                           device=device, obs=Obs.create("replica:roll"))
    del params
    warm_up(engine)
    # The published weights, on the host before the wave: the script only
    # writes them while the streams flow.
    steps = {step: transformer.map_params(
        lambda v: v.cpu(), roll_new_params(cfg, device, 10 + step))
        for step in (1, 2)}
    root = tempfile.mkdtemp(prefix="tpu-task-roll-")
    replica = ReplicaServer(engine=engine, ckpt_dir=root,
                            ckpt_poll_s=0.05).start()
    published = {}

    def publish():
        for step, tree in steps.items():
            # Step 2 only once the replica has seen step 1 (it reads a
            # step by number, so step 2's pointer cannot hide it).
            while not (replica._ckpt_read is not None or replica.rolls) \
                    and step > 1 and time.monotonic() - t_wave < 60:
                time.sleep(0.005)
            t0 = time.perf_counter()
            save_checkpoint(root, step, tree)
            published[step] = dict(save_s=time.perf_counter() - t0,
                                   at_s=time.monotonic() - t_wave)

    try:
        http = HttpClient(replica.url)
        counters = (engine.chunk_steps, engine.decode_steps)
        pa.reset_launch_counts()
        torch.cuda.synchronize()
        publisher = threading.Thread(target=publish, daemon=True)
        t_wave = time.monotonic()
        publisher.start()
        wave = http_wave(replica, KVFLEET_SEED)
        t_end = time.monotonic()
        publisher.join(timeout=120)
        deadline = time.monotonic() + 60
        while http.call("GET", "/healthz")[2]["generation"] != 2 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        health = http.call("GET", "/healthz")[2]
        torch.cuda.synchronize()
        metrics = http.call("GET", "/obs")[2]["metrics"]
        statuses = http.statuses
        http.close()
    finally:
        replica.stop()
        shutil.rmtree(root, ignore_errors=True)
    results = wave["results"]
    chunk_steps = engine.chunk_steps - counters[0]
    decode_calls = engine.decode_steps - counters[1]
    kernel = pa.paged_decode_attention
    plans = step_splits(engine)
    run = dict(
        all_finished=all(r["status"] == "done" and len(r["tokens"]) == 64
                         for r in results),
        kernel_launches=kernel.launches,
        combine_launches=kernel.combine_launches,
        other_kernel_launches=(pa.paged_decode_pipelined_attention.launches
                               + pa.paged_decode_pipelined_attention
                               .combine_launches),
        plain_launches=pa.paged_reference_attention.launches,
        expected_launches=cfg.n_layers * (chunk_steps + decode_calls),
        expected_combine_launches=cfg.n_layers * (
            decode_calls * (plans["decode"] > 1)
            + chunk_steps * (plans["chunk"] > 1)))
    gaps = [(b - a) * 1e3 for r in results
            for a, b in zip(r["times"], r["times"][1:])]
    rolls = [dict(roll, adopted_before_wave_end=roll["at"] < t_end,
                  at_s=roll["at"] - t_wave) for roll in replica.rolls]
    line = dict(
        run, wall_s=wave["wall_s"],
        generated_tokens=sum(len(r["tokens"]) for r in results),
        healthz_generation=health["generation"],
        param_rolls=metrics.get("replica.param_rolls", {}).get("value", 0),
        replica_errors=metrics.get("replica.errors", {}).get("value", 0),
        rolls=[{k: v for k, v in roll.items() if k != "at"}
               for roll in rolls],
        restore_s=[roll["read_s"] for roll in rolls],
        lock_held_ms=[roll["adopt_s"] * 1e3 for roll in rolls],
        published=published,
        client_intertoken_ms_p50=float(np.percentile(gaps, 50)),
        client_intertoken_ms_p99=float(np.percentile(gaps, 99)),
        client_intertoken_ms_max=max(gaps),
        phase26_intertoken_ms_p99=replica_line["client_intertoken_ms_p99"],
        faults=replica_faults(replica, False),
        http_500s=(statuses + [s for r in results
                               for s in r["statuses"]]).count(500),
        gpu=smi)
    failures = []
    if not wave_ok(run):
        failures.append("a stream fell short or the launches miss the "
                        "engine's kernel")
    if (line["healthz_generation"], line["param_rolls"]) != (2, 2):
        failures.append("the replica did not roll to step 1, then step 2")
    if line["replica_errors"] or line["faults"] or line["http_500s"]:
        failures.append("a replica fault or a 500")
    line["failures"] = failures
    emit("serve_roll_replica", **line)
    if failures:
        raise AssertionError(f"serve_roll_replica: {failures}")
    return line


def phase_serve_roll(device, smi: str, serve_streams: dict,
                     quant_streams: dict, medians: dict,
                     replica_line: dict) -> dict:
    """Phase 27: the three engine rolls of ROLL_CASES, then the replica
    roll. Returns each kernel's and the combine's launches here."""
    totals = {"cuda": 0, "pipelined": 0, "cuda_combine": 0,
              "pipelined_combine": 0}
    for kv_dtype, impl, micro_k in ROLL_CASES:
        streams = quant_streams if kv_dtype else serve_streams
        line = engine_roll(device, smi, kv_dtype, impl, micro_k,
                           streams[KVFLEET_SEED],
                           medians["int8" if kv_dtype else "bf16"])
        totals[impl] += line["kernel_launches"]
        totals[f"{impl}_combine"] += line["combine_launches"]
    line = replica_roll(device, smi, replica_line)
    totals["cuda"] += line["kernel_launches"]
    totals["cuda_combine"] += line["combine_launches"]
    return totals


# -- phase 28: paged LoRA adapters -------------------------------------------

#: Phase 28's adapters: the pool rank, the tenants, the scale each is
#: registered with, and the tiny preset's rank and scale.
LORA_RANK, LORA_TENANTS, LORA_SCALE = 16, 8, 1.0
TINY_LORA_RANK, TINY_LORA_SCALE = 4, 1.5
#: Phase 28's flagship engines: scratch + 8 adapters x 8 layers, and a
#: pool that holds four adapters (legs c and d).
LORA_BLOCKS, LORA_SMALL_BLOCKS = 65, 33
#: The bf16 error bound of ``apply_lora`` against float64 on the same bf16
#: values, per element, over the magnitude of its products (|x| |A|^T
#: |scale| |B|): three bf16 roundings (the shrink, the scale, the output),
#: 3 x 2^-8 < 2^-6.
LORA_BF16_BOUND = 2.0 ** -6


def lora_adapter(seed: int, d_model: int, n_layers: int, rank: int,
                 full_scale: bool = False) -> list:
    """One tenant's per-layer (A, B) from a seeded numpy generator. The
    flagship's are N(0, 1/d) and N(0, 1/r): each layer's delta is about
    as large as the residual it joins, which turns the greedy argmax and
    keeps bf16 logits finite; the tiny preset's are full-scale N(0, 1),
    as ``tests/test_lora.py``'s."""
    rng = np.random.default_rng(seed)
    sa, sb = (1.0, 1.0) if full_scale else (d_model ** -0.5, rank ** -0.5)
    return [{"a": rng.normal(size=(d_model, rank)) * sa,
             "b": rng.normal(size=(rank, d_model)) * sb}
            for _ in range(n_layers)]


def lora_engine(device, n_blocks: int, obs=None, kv_fleet=None,
                **serving):
    """A flagship engine with the LoRA pool over SERVE_KNOBS."""
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg, params = flagship_model(device)
    return ServingEngine(params, cfg, ServingConfig(
        **SERVE_KNOBS, lora_rank=LORA_RANK, n_adapter_blocks=n_blocks,
        **serving), device=device, obs=obs, kv_fleet=kv_fleet)


def register_tenants(engine, tenants, **kw) -> None:
    cfg = engine.cfg
    for t in tenants:
        engine.register_adapter(
            f"tenant-{t}", lora_adapter(t, cfg.d_model, cfg.n_layers,
                                        LORA_RANK), scale=LORA_SCALE, **kw)


def lora_load(engine, seed: int, tenants, max_new: int = 64,
              requests=None):
    """A ``_timed_drain`` loader: the seed's serve wave (or the requests at
    the indices ``requests``), request j under ``tenants[j]`` (None: the
    base model)."""
    def load():
        wave = _wave_requests(engine.cfg.vocab_size, seed)
        picked = range(len(wave)) if requests is None else requests
        rids = [engine.submit(wave[i][0], max_new, adapter_id=t,
                              **wave[i][1]) for i, t in zip(picked, tenants)]
        return rids, sum(len(wave[i][0]) for i in picked)
    return load


def first_divergence(engine, rid, want) -> dict:
    """Where ``rid``'s stream first parts from ``want``, with the top-2 gap
    there (its adapter applied), or None when equal."""
    got = engine.request(rid).tokens
    at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
              None)
    if at is None:
        return None
    return {"at": at, "top2_gap": top2_gap(engine, engine.request(rid), at)}


def lora_numerics(device) -> dict:
    """``apply_lora`` on the card at the flagship's shapes (16 decode rows
    and 144 chunk rows, rank 16, d_model 1024, bf16) against float64 on
    the host from the same bf16 values: within LORA_BF16_BOUND of the
    products' magnitude at every element, and the rows on the scratch
    block or at scale 0 exactly 0.0."""
    from tpu_task_torch.ml.serving.lora import apply_lora

    gen = torch.Generator(device=device).manual_seed(28)
    d, out = FLAGSHIP["d_model"], {}
    pool = torch.randn((LORA_BLOCKS, 2, LORA_RANK, d), generator=gen,
                       device=device).mul_(0.05).to(torch.bfloat16)
    pool[0] = 0
    for rows in (16, CHUNK_ROWS):
        x = torch.randn((rows, 1, d), generator=gen,
                        device=device).to(torch.bfloat16)
        blocks = torch.randint(1, LORA_BLOCKS, (rows,), generator=gen,
                               device=device)
        scales = torch.rand((rows,), generator=gen, device=device) + 0.5
        blocks[::5] = 0                      # scratch rows
        scales[3::7] = 0.0                   # bound rows at scale 0
        got = apply_lora(x, pool, blocks, scales).double().cpu()
        xd, ab = x.double().cpu(), pool[blocks].double().cpu()
        sd = scales.to(torch.bfloat16).double().cpu()[:, None, None]
        ref = torch.bmm(torch.bmm(xd, ab[:, 0].transpose(1, 2)) * sd,
                        ab[:, 1])
        mag = torch.bmm(torch.bmm(xd.abs(), ab[:, 0].abs().transpose(1, 2))
                        * sd.abs(), ab[:, 1].abs())
        err = (got - ref).abs()
        zero = (blocks.cpu() == 0) | (scales.cpu() == 0)
        out[rows] = dict(
            max_abs_err=float(err.max()),
            max_err_over_magnitude=float((err / mag.clamp_min(1e-30))
                                         [~zero].max()),
            within_bound=bool((err <= LORA_BF16_BOUND * mag).all()),
            zero_rows=int(zero.sum()),
            zero_rows_exact=bool((got[zero] == 0).all()))
    return out


def lora_parity_tiny(device) -> dict:
    """The tiny preset at fp32 through ``"cuda"``, ``"pipelined"`` and
    ``"reference"``: ``tests/test_lora.py``'s 8-adapter mixed wave (a base
    request beside eight tenants, every second request sampled with its
    own key) equals, stream for stream, a dedicated engine that holds the
    request's adapter alone (a LoRA-free engine for the base request),
    and the two kernels' mixed streams equal the plain version's. Returns
    each kernel's (launches, combine launches) over its engines."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.serve.replica import build_engine

    rng = np.random.default_rng(19)
    serving = dict(slots=10, lora_rank=TINY_LORA_RANK, n_adapter_blocks=40)
    mixed, launches = {}, {}
    for impl in ("cuda", "pipelined", "reference"):
        engine = build_engine("tiny", serving={**serving,
                                               "decode_impl": impl},
                              device=device)
        cfg = engine.cfg
        tenants = {f"tiny-{t}": lora_adapter(100 + t, cfg.d_model,
                                             cfg.n_layers, TINY_LORA_RANK,
                                             full_scale=True)
                   for t in range(LORA_TENANTS)}
        if impl == "cuda":
            wave = [(aid, rng.integers(0, cfg.vocab_size, size=5 + i % 3),
                     {"temperature": 0.8, "key": [500 + i, 3]} if i % 2
                     else {})
                    for i, aid in enumerate([None] + list(tenants))]
        for aid, layers in tenants.items():
            engine.register_adapter(aid, layers, scale=TINY_LORA_SCALE)
        pa.reset_launch_counts()
        rids = [engine.submit(p, 10, adapter_id=aid, **kw)
                for aid, p, kw in wave]
        out = engine.drain()
        mixed[impl] = [out[r] for r in rids]
        dedicated = []
        for (aid, p, kw), stream in zip(wave, mixed[impl]):
            knobs = {**serving, "decode_impl": impl}
            if aid is None:          # a LoRA-free engine of the same shape
                knobs.update(lora_rank=0, n_adapter_blocks=0)
            alone = build_engine("tiny", device=device, serving=knobs)
            if aid is not None:
                alone.register_adapter(aid, tenants[aid],
                                       scale=TINY_LORA_SCALE)
            rid = alone.submit(p, 10, adapter_id=aid, **kw)
            dedicated.append(alone.drain()[rid] == stream)
        launches[impl] = attention_launches()      # mixed and dedicated
        line = dict(impl=impl, requests=len(wave),
                    equal_dedicated=sum(dedicated),
                    adapter_streams_differ_from_base=sum(
                        s != mixed[impl][0] for s in mixed[impl][1:]),
                    launches=launches[impl])
        emit("parity_lora", **line)
        if not all(dedicated) or not line["adapter_streams_differ_from_base"]:
            raise AssertionError(f"parity_lora {impl}: a mixed stream "
                                 f"differs from its dedicated engine's: "
                                 f"{line}")
        n = {name: counts[0] for name, counts in launches[impl].items()}
        kernel_ok = {"cuda": n["cuda"] > 0 and n["reference"] == 0,
                     "pipelined": n["pipelined"] > 0 and n["reference"] == 0,
                     "reference": n["cuda"] == n["pipelined"] == 0}[impl]
        if not kernel_ok:
            raise AssertionError(f"parity_lora {impl}: launches "
                                 f"{launches[impl]}")
    for impl in ("cuda", "pipelined"):
        if mixed[impl] != mixed["reference"]:
            raise AssertionError(f"parity_lora: {impl}'s mixed streams "
                                 "differ from the plain version's")
    # Each kernel's (launches, combine launches) in its own engines.
    return {impl: launches[impl][impl] for impl in ("cuda", "pipelined")}


def traced_range_share(engine, module, attr: str, label: str) -> dict:
    """One ``engine.step()`` under ``torch.profiler``, on this (the
    launching) thread, with ``module.attr`` wrapped in a ``label`` range:
    the device time of the kernels its calls launched (the ranges' device
    totals) against the step's device-busy time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    inner = getattr(module, attr)

    def ranged(*args, **kwargs):
        with record_function(label):
            return inner(*args, **kwargs)

    setattr(module, attr, ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prime_tracer(engine.device)
            with record_function("traced_step"):
                engine.step()
            torch.cuda.synchronize()
    finally:
        setattr(module, attr, inner)
    cpu = torch.autograd.DeviceType.CPU
    step = [e for e in prof.events()
            if e.name == "traced_step" and e.device_type == cpu]
    ranges = [e for e in prof.events()
              if e.name == label and e.device_type == cpu]
    start, end = step[0].time_range.start, step[0].time_range.end
    busy, last, kernels = 0.0, -math.inf, 0
    for d_start, d_end, name in sorted(
            (s, e, n) for n, s, e in device_events(prof)
            if n not in ("traced_step", label)):
        if not start <= d_start <= end:
            continue
        kernels += 1
        if d_end > last:
            busy += d_end - max(d_start, last)
            last = d_end

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    range_us = sum(device_us(e) for e in ranges)
    return dict(step_device_busy_ms=busy / 1e3, step_kernels=kernels,
                calls=len(ranges), range_device_ms=range_us / 1e3,
                share=range_us / busy if busy else None)


def lora_step_share(engine, seed: int) -> dict:
    """One 100%-adapter decode step under ``torch.profiler``: the device
    time of the kernels ``apply_lora`` launched against the step's
    device-busy time (``traced_range_share``)."""
    from tpu_task_torch.ml.serving import model as serving_model

    wave = _wave_requests(engine.cfg.vocab_size, seed)
    for j, (prompt, kw) in enumerate(wave):
        engine.submit(prompt[:64], 24, adapter_id=f"tenant-{j % LORA_TENANTS}",
                      **kw)
    while any(engine._prefilling(i) for i in range(engine.scfg.slots)) \
            or engine._queue:
        engine.step()                 # ingest: the next step is a decode
    slot_blocks = engine._slot_lora_blocks.copy()
    traced = traced_range_share(engine, serving_model, "apply_lora",
                                "lora_branch")
    engine.drain()
    busy = traced["step_device_busy_ms"] * 1e3
    # The same branch timed alone with CUDA events at this step's shapes
    # (16 decode rows, every layer, cold L2), beside the traced sum.
    from tpu_task_torch.ml.serving.lora import apply_lora

    cfg, n = engine.cfg, engine.scfg.slots
    x = torch.randn((n, 1, cfg.d_model), device=engine.device,
                    dtype=cfg.dtype)
    blocks = torch.as_tensor(slot_blocks, dtype=torch.int64,
                             device=engine.device)
    scales = torch.ones((n,), device=engine.device).to(cfg.dtype)

    def branch():
        for i in range(cfg.n_layers):
            x + apply_lora(x, engine._lora_pool, blocks[:, i], scales)

    timed_ms = DeviceTimer(engine.device)(branch)
    return dict(step_device_busy_ms=traced["step_device_busy_ms"],
                step_kernels=traced["step_kernels"],
                lora_branch_calls=traced["calls"],
                lora_branch_device_ms=traced["range_device_ms"],
                lora_share_of_step=traced["share"],
                lora_branch_timed_ms=timed_ms,
                lora_timed_share_of_step=timed_ms * 1e3 / busy if busy
                else None)


def lora_wave_line(run: dict, engine, reference=None) -> dict:
    line = {k: run[k] for k in (
        "seed", "requests", "generated_tokens", "wall_s", "tokens_per_s",
        "chunk_steps", "decode_steps", "micro_steps", "kernel",
        "kernel_launches", "combine_launches", "other_kernel_launches",
        "plain_launches", "expected_launches", "expected_combine_launches",
        "all_finished", "graph_captures")}
    line["wave_ok"] = wave_ok(run)
    if reference is not None:
        line["streams_equal_reference"] = sum(
            engine.request(r).tokens == want
            for r, want in zip(run["rids"], reference))
    return line


def lora_reload_leg(device, smi: str, bucket: str, micro_k: int) -> dict:
    """Legs (c) and (d): a pool of four adapters, the eight registered with
    ``host_copy=False`` into a local bucket through the port's fleet
    client; the first eight requests of the seed-2 wave under tenants 0-3,
    then 4-7 (evicting 0-3), then 0-3 again (reloaded from the bucket).
    The third wave equals the first token for token; the pool keeps its
    address; at ``micro_k`` 4 the LoRA graphs are captured in the first
    wave alone and replayed over the reloaded adapters."""
    from tpu_task_torch.serve.kvfleet import FleetKvClient
    from tpu_task_torch.storage.backends import LocalBackend

    client = FleetKvClient(LocalBackend(bucket), f"lora-k{micro_k}",
                           refresh_interval=0.0)
    engine = lora_engine(device, LORA_SMALL_BLOCKS, kv_fleet=client,
                         micro_k=micro_k, decode_impl="cuda")
    register_tenants(engine, range(LORA_TENANTS), host_copy=False)
    ptrs = {engine._lora_pool.data_ptr()}
    pool = engine._lora_pool
    runs, graphs = [], []
    for tenants in ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 2, 3)):
        names = [f"tenant-{tenants[j % 4]}" for j in range(8)]
        runs.append(_timed_drain(engine, KVFLEET_SEED, load=lora_load(
            engine, KVFLEET_SEED, names, requests=range(8))))
        ptrs.add(engine._lora_pool.data_ptr())
        runner = engine._micro_graphs.get(0)
        graphs.append(dict(runner._graphs) if runner else {})
    streams = [[engine.request(r).tokens for r in run["rids"]]
               for run in runs]
    stats = engine.stats()
    graph_stats = stats["step_graph"]
    line = dict(
        micro_k=micro_k, n_adapter_blocks=LORA_SMALL_BLOCKS,
        waves=[lora_wave_line(r, engine) for r in runs],
        third_equals_first=streams[2] == streams[0],
        second_differs=streams[1] != streams[0],
        loads=stats["adapters"]["loads"],
        evictions=stats["adapters"]["evictions"],
        resident=stats["adapters"]["resident"],
        pool_high_water=stats["adapters"]["pool_high_water"],
        pool_same_tensor=engine._lora_pool is pool,
        pool_addresses=len(ptrs),
        bucket_bytes_shipped=client.bytes_shipped,
        bucket_bytes_fetched=client.bytes_fetched,
        lora_graphs=sorted(str(k) for k in graphs[0] if k[1]),
        lora_captures=graph_stats["lora_captures"],
        capture_ms=graph_stats["capture_ms"],
        graphs_kept_across_reload=all(
            g == graphs[0] for g in graphs[1:]) if micro_k > 1 else None,
        gpu=smi)
    failures = []
    if not all(wave_ok(r) for r in runs):
        failures.append("a wave failed its gates")
    if not (line["third_equals_first"] and line["second_differs"]):
        failures.append("the reloaded adapters gave other streams")
    if line["evictions"] < 4 or line["loads"] < 12:
        failures.append("the pool did not evict and reload")
    if not line["pool_same_tensor"] or line["pool_addresses"] != 1:
        failures.append("the adapter pool was rebound")
    if micro_k > 1 and not (line["graphs_kept_across_reload"]
                            and line["lora_graphs"]
                            and line["lora_captures"]
                            == len(line["lora_graphs"])):
        failures.append("the LoRA graphs were captured again, or never")
    line["failures"] = failures
    emit("serve_lora_reload", **line)
    if failures:
        raise AssertionError(f"serve_lora reload K{micro_k}: {failures}")
    return line


def lora_replica_leg(device, smi: str, reference: list) -> dict:
    """Leg (f): a fresh bf16 LoRA engine of leg (b)'s configuration with an
    obs handle behind ``ReplicaServer``; four adapters go in over ``POST
    /adapter``, then 16 HTTP clients send the seed-2 wave with the four
    ids round-robin. Gates: 64 tokens a stream, ``/stats`` counts 4
    registered adapters, ``/metrics`` carries the ``adapters`` series, no
    fault and no 500, the engine's kernel and nothing else."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.obs import Obs
    from tpu_task_torch.serve.replica import ReplicaServer

    engine = lora_engine(device, LORA_BLOCKS, obs=Obs.create("replica:lora"),
                         decode_impl="cuda")
    warm_up(engine)
    cfg = engine.cfg
    names = [f"http-{t}" for t in range(4)]
    replica = ReplicaServer(engine=engine).start()
    try:
        http = HttpClient(replica.url)
        hashes = []
        for t, name in enumerate(names):
            layers = [{"a": layer["a"].tolist(), "b": layer["b"].tolist()}
                      for layer in lora_adapter(t, cfg.d_model, cfg.n_layers,
                                                LORA_RANK)]
            status, _, body = http.call("POST", "/adapter", {
                "adapter_id": name, "layers": layers, "scale": LORA_SCALE})
            if status != 200:
                raise AssertionError(f"POST /adapter answered {status}: "
                                     f"{body}")
            hashes.append(body["hash"])
        counters = (engine.chunk_steps, engine.decode_steps)
        pa.reset_launch_counts()
        torch.cuda.synchronize()
        wave = http_wave(replica, KVFLEET_SEED,
                         adapter_ids=[names[i % 4] for i in range(16)])
        torch.cuda.synchronize()
        stats = http.call("GET", "/stats")[2]
        metrics = http.call("GET", "/metrics")[2]
        statuses = http.statuses
        http.close()
    finally:
        replica.stop()
    results = wave["results"]
    chunk_steps = engine.chunk_steps - counters[0]
    decode_calls = engine.decode_steps - counters[1]
    plans = step_splits(engine)
    kernel = pa.paged_decode_attention
    run = dict(
        all_finished=all(r["status"] == "done" and len(r["tokens"]) == 64
                         for r in results),
        kernel_launches=kernel.launches,
        combine_launches=kernel.combine_launches,
        other_kernel_launches=(pa.paged_decode_pipelined_attention.launches
                               + pa.paged_decode_pipelined_attention
                               .combine_launches),
        plain_launches=pa.paged_reference_attention.launches,
        expected_launches=cfg.n_layers * (chunk_steps + decode_calls),
        expected_combine_launches=cfg.n_layers * (
            decode_calls * (plans["decode"] > 1)
            + chunk_steps * (plans["chunk"] > 1)))
    series = sorted({line.split("{")[0].split(" ")[0]
                     for line in metrics.splitlines()
                     if line.startswith("tpu_task_adapters_")})
    generated = sum(len(r["tokens"]) for r in results)
    line = dict(
        run, wall_s=wave["wall_s"], generated_tokens=generated,
        tokens_per_s=generated / wave["wall_s"],
        adapters=stats["adapters"], distinct_hashes=len(set(hashes)),
        metrics_series=series,
        adapter_streams_equal_base=sum(
            r["tokens"] == want for r, want in zip(results, reference)),
        faults=replica_faults(replica, False),
        http_500s=(statuses + [s for r in results
                               for s in r["statuses"]]).count(500),
        gpu=smi)
    failures = []
    if not wave_ok(run):
        failures.append("a stream fell short or the launches miss the "
                        "engine's kernel")
    if stats["adapters"]["registered"] != 4:
        failures.append("/stats does not count 4 registered adapters")
    if not {"tpu_task_adapters_registered", "tpu_task_adapters_loads",
            "tpu_task_adapters_resident"} <= {
                s.removesuffix("_total") for s in series}:
        failures.append("/metrics lacks the adapters series")
    if line["faults"] or line["http_500s"]:
        failures.append("a replica fault or a 500")
    line["failures"] = failures
    emit("serve_lora_replica", **line)
    if failures:
        raise AssertionError(f"serve_lora_replica: {failures}")
    return line


def phase_serve_lora(device, smi: str, serve_streams: dict,
                     serve_seed2: dict, median: float) -> dict:
    """Phase 28: paged LoRA adapters on the flagship (legs a-f), then the
    numerics of ``apply_lora`` at the flagship's shapes and the tiny
    preset's fp32 exactness through both kernels. Returns each kernel's
    and the combine's launches in the flagship legs, and the tiny
    parity's."""
    import shutil

    t0 = time.perf_counter()
    reference = serve_streams[KVFLEET_SEED]
    totals = {"cuda": 0, "pipelined": 0, "cuda_combine": 0,
              "pipelined_combine": 0}

    def count(run):
        totals[run["kernel"]] += run["kernel_launches"]
        totals[f"{run['kernel']}_combine"] += run["combine_launches"]

    # (a) base traffic on a LoRA engine holding eight adapters.
    engine = lora_engine(device, LORA_BLOCKS, decode_impl="cuda")
    pool_bytes_lora = (engine._lora_pool.numel()
                       * engine._lora_pool.element_size())
    warm_up(engine)
    register_tenants(engine, range(LORA_TENANTS))
    base = _timed_drain(engine, KVFLEET_SEED)
    count(base)
    base_line = lora_wave_line(base, engine, reference)
    base_line.update(
        same_launches_as_phase6=(
            base["kernel_launches"], base["combine_launches"])
        == (serve_seed2["kernel_launches"],
            serve_seed2["combine_launches"]),
        over_phase6_median=base["tokens_per_s"] / median)
    # (b) 25%, then 100% of the requests under tenants round-robin.
    mixed = {}
    for share, tenants in (
            (25, [f"tenant-{(j // 4) % LORA_TENANTS}" if j % 4 == 0
                  else None for j in range(16)]),
            (100, [f"tenant-{j % LORA_TENANTS}" for j in range(16)])):
        run = _timed_drain(engine, KVFLEET_SEED,
                           load=lora_load(engine, KVFLEET_SEED, tenants))
        count(run)
        line = lora_wave_line(run, engine, reference)
        line.update(share=share,
                    adapter_streams_differ_from_base=sum(
                        engine.request(r).tokens != want
                        for r, want, t in zip(run["rids"], reference,
                                              tenants) if t),
                    over_phase6_median=run["tokens_per_s"] / median)
        mixed[share] = (run, line, tenants)
    stats_b = engine.stats()["adapters"]
    share = lora_step_share(engine, 3)
    del engine
    bucket = tempfile.mkdtemp(prefix="tpu-task-lora-")
    try:
        reload_k1 = lora_reload_leg(device, smi, bucket, 1)
        reload_k4 = lora_reload_leg(device, smi, bucket, 4)
    finally:
        shutil.rmtree(bucket, ignore_errors=True)
    for line in (reload_k1, reload_k4):
        for wave in line["waves"]:
            totals["cuda"] += wave["kernel_launches"]
            totals["cuda_combine"] += wave["combine_launches"]
    # (e) int8 pools through the pipelined kernel, 100% adapters.
    engine = lora_engine(device, LORA_BLOCKS, kv_dtype="int8",
                         decode_impl="pipelined")
    register_tenants(engine, range(LORA_TENANTS))
    quant = _timed_drain(engine, KVFLEET_SEED, load=lora_load(
        engine, KVFLEET_SEED, [f"tenant-{j % LORA_TENANTS}"
                               for j in range(16)]))
    count(quant)
    quant_line = lora_wave_line(quant, engine)
    del engine
    replica = lora_replica_leg(device, smi, reference)
    totals["cuda"] += replica["kernel_launches"]
    totals["cuda_combine"] += replica["combine_launches"]
    numerics = lora_numerics(device)
    parity = lora_parity_tiny(device)
    line = dict(
        lora_rank=LORA_RANK, tenants=LORA_TENANTS,
        adapter_pool_bytes=pool_bytes_lora,
        base=base_line, mixed={s: m[1] for s, m in mixed.items()},
        adapters_after_mixed=stats_b,
        lora_step=share, reload_k1_loads=reload_k1["loads"],
        reload_k4_capture_ms=reload_k4["capture_ms"],
        reload_k4_lora_captures=reload_k4["lora_captures"],
        int8=quant_line, replica_tokens_per_s=replica["tokens_per_s"],
        numerics=numerics, launches=totals, phase6_median=median,
        seconds=time.perf_counter() - t0, gpu=smi)
    failures = []
    if base_line["streams_equal_reference"] != 16 \
            or not base_line["same_launches_as_phase6"]:
        failures.append("(a) base traffic differs from phase 6's wave")
    if not all(wave_ok(m[0]) for m in mixed.values()) \
            or not base_line["wave_ok"]:
        failures.append("(a/b) a wave failed its gates")
    if not any(m[1]["adapter_streams_differ_from_base"]
               for m in mixed.values()):
        failures.append("(b) no adapter changed a stream")
    if (stats_b["registered"], stats_b["resident"],
            stats_b["pool_high_water"]) != (8, 8, 64):
        failures.append(f"(b) adapters {stats_b}")
    if not quant_line["wave_ok"] or quant_line["kernel"] != "pipelined":
        failures.append("(e) the int8 wave failed its gates")
    for rows, check in numerics.items():
        if not (check["within_bound"] and check["zero_rows_exact"]):
            failures.append(f"apply_lora at {rows} rows: {check}")
    line["failures"] = failures
    emit("serve_lora", **line)
    if failures:
        raise AssertionError(f"serve_lora: {failures}")
    return {"flagship": totals, "parity": parity}


# -- the overlapped loop (A5) ---------------------------------------------------

#: Phase 29's tight pool: ``tests/test_serving_async.py``'s pool-pressure
#: knobs. With the tiny preset and ``overlap_workload``'s sampled seed-6
#: requests both loops preempt at K 1 and 4, equally (4 and 5 times through
#: the plain version on the CPU), and the overlapped one flushes.
OVERLAP_TIGHT = dict(slots=3, block_size=4, n_blocks=8, max_len=32,
                     chunk_tokens=4, prefix_cache=False)
OVERLAP_TIGHT_SEED = 6
OVERLAP_KS = (1, 8)


def overlap_workload(vocab: int, seed: int, n: int = 6) -> list:
    """``tests/test_serving_async.py``'s ``_workload`` with sampling: n
    requests of 3-11 prompt tokens and 3-13 new tokens, eos 7, greedy or
    at temperature 0.8 / top_p 0.9, each submitted with no step after it,
    as (prompt, max_new, kwargs, steps after)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        prompt = rng.integers(0, vocab, size=int(rng.integers(3, 12)))
        t = float(rng.choice([0.0, 0.8]))
        kw = {"temperature": t, "top_p": 0.9} if t else {}
        out.append((prompt, int(rng.integers(3, 14)),
                    dict(kw, eos_token=7), 0))
    return out


def overlap_arrivals(vocab: int) -> list:
    """12 greedy and keyed-sampled requests of 2-39 prompt tokens and 4-29
    new tokens, a third with an eos, each followed by 0-3 steps before the
    next arrives, as (prompt, max_new, kwargs, steps after)."""
    rng = np.random.default_rng(4)
    out = []
    for i in range(12):
        prompt = rng.integers(0, vocab, size=int(rng.integers(2, 40)))
        t = float(rng.choice([0.0, 0.0, 0.8]))
        kw = {"temperature": t, "top_p": 0.9, "key": [4, i]} if t else {}
        if i % 3 == 0:
            kw["eos_token"] = int(rng.integers(0, 32))
        out.append((prompt, int(rng.integers(4, 30)), kw,
                    int(rng.integers(0, 4))))
    return out


def run_arrivals(engine, traffic: list) -> list:
    """Submit each request and step as many times as it says, then drain;
    returns the streams in submission order."""
    rids = []
    for prompt, max_new, kw, steps in traffic:
        rids.append(engine.submit(prompt, max_new, **kw))
        for _ in range(steps):
            engine.step()
    engine.drain(max_steps=5000)
    return [list(engine.request(rid).tokens) for rid in rids]


def sync_checked(engine) -> list:
    """Run ``engine``'s overlap dispatch region (planning, reservation and
    the dispatch of the next program) under
    ``torch.cuda.set_sync_debug_mode("error")``, so that any wait for the
    device in it raises. Returns a one-item list counting the checked
    dispatches."""
    dispatch, count = engine._dispatch_next, [0]

    def checked(finished):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(finished)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            count[0] += 1

    engine._dispatch_next = checked
    return count


@contextlib.contextmanager
def consume_waits():
    """Totals the consume edge's waits (``Readback.wait``) while open:
    yields [seconds, waits]."""
    from tpu_task_torch.ml.serving.step_graph import Readback

    wait, total = Readback.wait, [0.0, 0]

    def timed(self):
        t0 = time.perf_counter()
        try:
            return wait(self)
        finally:
            total[0] += time.perf_counter() - t0
            total[1] += 1

    Readback.wait = timed
    try:
        yield total
    finally:
        Readback.wait = wait


def overlap_parity_tiny(device) -> dict:
    """Leg (a): the tiny preset at fp32 through ``"cuda"``, ``"pipelined"``
    and ``"reference"`` at K 1 and 4, overlapped and synchronous, on the
    arrivals traffic (the preset's pool) and the tight pool's workload.
    Each engine runs its traffic twice: the first pass captures the carry
    graphs, the second runs the overlapped engine's dispatch region under
    the sync debug mode. Gates: both passes' overlapped streams equal the
    synchronous engine's, equal preemptions, flushes in the tight run,
    every checked dispatch clean, and the launches those of the programs
    (n_layers a chunk program, n_layers x K a micro program) through the
    route's attention alone. Returns the kernels' and combine's launches
    of the overlapped engines."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.serve.replica import SERVING_PRESETS, build_engine

    base = build_engine("tiny", device=device)
    totals = {"cuda": 0, "pipelined": 0, "combine": 0}
    lines = []
    for impl in ("cuda", "pipelined", "reference"):
        for k in (1, 4):
            for tight in (False, True):
                knobs = dict(SERVING_PRESETS["tiny"], decode_impl=impl,
                             micro_k=k, **(OVERLAP_TIGHT if tight else {}))
                traffic = (overlap_workload(base.cfg.vocab_size,
                                            OVERLAP_TIGHT_SEED)
                           if tight else overlap_arrivals(base.cfg.vocab_size))
                runs = {}
                for overlap in (False, True):
                    engine = ServingEngine(
                        base.params, base.cfg,
                        ServingConfig(**knobs, overlap=overlap),
                        device=device)
                    pa.reset_launch_counts()
                    first = run_arrivals(engine, traffic)
                    checked = sync_checked(engine) if overlap else [0]
                    second = run_arrivals(engine, traffic)
                    s = engine.stats()
                    calls = (s["chunk_steps"] + s["decode_steps"]
                             + (k - 1) * s["micro_steps"])
                    launches = dict(s["attention_launches"])
                    combines = (pa.paged_decode_attention.combine_launches
                                + pa.paged_decode_pipelined_attention
                                .combine_launches)
                    want = {name: 0 for name in launches}
                    want[impl] = engine.cfg.n_layers * calls
                    runs[overlap] = dict(
                        streams=(first, second), launches=launches,
                        launches_ok=launches == want, combines=combines,
                        preemptions=s["recompute_preemptions"],
                        flushes=s["overlap_flushes"], checked=checked[0],
                        steps=s["steps"], chunk_steps=s["chunk_steps"],
                        micro_steps=s["micro_steps"])
                    if overlap and impl != "reference":
                        totals[impl] += launches[impl]
                        totals["combine"] += combines
                    del engine
                sync, over = runs[False], runs[True]
                line = dict(
                    kernel=impl, micro_k=k, tight=tight,
                    streams_equal_sync=over["streams"] == sync["streams"],
                    requests=2 * len(traffic),
                    preemptions=(sync["preemptions"], over["preemptions"]),
                    overlap_flushes=over["flushes"],
                    checked_dispatches=over["checked"],
                    launches_ok=(sync["launches_ok"], over["launches_ok"]),
                    overlap_launches=over["launches"][impl],
                    overlap_combines=over["combines"],
                    steps=(sync["steps"], over["steps"]),
                    chunk_steps=(sync["chunk_steps"], over["chunk_steps"]))
                emit("serve_overlap_parity", **line)
                ok = (line["streams_equal_sync"]
                      and sync["preemptions"] == over["preemptions"]
                      and all(line["launches_ok"])
                      and over["checked"] > 0
                      and (not tight or (over["preemptions"] > 0
                                         and over["flushes"] > 0)))
                if not ok:
                    raise AssertionError(f"serve_overlap (a) failed: {line}")
                lines.append(line)
    return totals


def overlap_wave_line(run: dict, engine, arm: str, waits) -> dict:
    goodput = engine.stats()["goodput"]
    return dict(
        arm=arm, micro_k=engine.scfg.micro_k, kernel=run["kernel"],
        kv_dtype=engine.scfg.kv_dtype or "bfloat16",
        tokens_per_s=run["tokens_per_s"], wall_s=run["wall_s"],
        chunk_steps=run["chunk_steps"], decode_steps=run["decode_steps"],
        micro_steps=run["micro_steps"],
        mean_chunk_step_ms=run["mean_chunk_step_ms"],
        mean_decode_or_micro_step_ms=run["mean_decode_step_ms"],
        host_gap_frac=run["host_gap_frac"],
        overlapped_host_s=goodput["overlapped_host_s"],
        program_s=goodput["program_s"], host_s=goodput["host_s"],
        consume_wait_s=waits[0], consume_waits=waits[1],
        dispatches_per_token=run["dispatches_per_token"],
        preemptions=run["preemptions"],
        overlap_flushes=engine.overlap_flushes,
        kernel_launches=run["kernel_launches"],
        expected_launches=run["expected_launches"],
        combine_launches=run["combine_launches"],
        expected_combine_launches=run["expected_combine_launches"],
        other_kernel_launches=run["other_kernel_launches"],
        plain_launches=run["plain_launches"],
        graph_captures=run["graph_captures"], wave_ok=wave_ok(run))


def overlap_flagship(device, smi: str, sync_trace: dict) -> dict:
    """Legs (b), (d) and (c): the flagship with bf16 pools through the
    tile kernel, overlapped, at K 1 and 8, each against a synchronous twin
    of its configuration, both after phase 6's warm-up, on phase 6's
    seed-2 wave in the order sync, overlap, overlap, sync (the first run
    of each engine misses the prefix cache, the second hits it); every
    overlapped dispatch under the sync debug mode. Then one traced
    overlapped wave at K 8 (``serve_trace``'s reading; the synchronous
    arm's is phase 16's at K 8), and int8 pools through the pipelined
    kernel overlapped at K 8, one wave. Returns the kernels' and the
    combine's launches in the overlapped waves."""
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg, params = flagship_model(device)
    totals = {"cuda": 0, "pipelined": 0, "cuda_combine": 0,
              "pipelined_combine": 0}
    out, failures = {}, []

    def gate(line, engine, checked, what):
        if not (line["wave_ok"] and line["overlapped_host_s"] > 0
                and checked[0] > 0):
            failures.append(f"{what}: {line}")

    for k in OVERLAP_KS:
        engines = {}
        for overlap in (False, True):
            engine = ServingEngine(params, cfg, ServingConfig(
                **SERVE_KNOBS, micro_k=k, overlap=overlap), device=device)
            warm_up(engine)
            engines[overlap] = engine
        checked = sync_checked(engines[True])
        runs = []
        for arm in ("sync", "overlap", "overlap", "sync"):
            engine = engines[arm == "overlap"]
            with consume_waits() as waits:
                run = _timed_drain(engine, KVFLEET_SEED)
            line = overlap_wave_line(run, engine, arm, waits)
            line["streams"] = [list(engine.request(r).tokens)
                               for r in run["rids"]]
            emit("serve_overlap_wave", **{key: v for key, v in line.items()
                                          if key != "streams"}, gpu=smi)
            if arm == "overlap":
                totals["cuda"] += run["kernel_launches"]
                totals["cuda_combine"] += run["combine_launches"]
                gate(line, engine, checked, f"(b) K {k}")
            elif not line["wave_ok"]:
                failures.append(f"(d) sync twin K {k}: {line}")
            runs.append((line, run))
        over, sync = runs[1], runs[0]
        divergences = [first_divergence(engines[True], rid, want)
                       for rid, want in zip(over[1]["rids"],
                                            sync[0]["streams"])]

        def median(arm):
            return float(np.median([line["tokens_per_s"]
                                    for line, _ in runs
                                    if line["arm"] == arm]))

        graphs = engines[True].stats()["step_graph"]
        out[k] = dict(
            tokens_per_s_median_sync=median("sync"),
            tokens_per_s_median_overlap=median("overlap"),
            overlap_over_sync=median("overlap") / median("sync"),
            streams_equal_sync=sum(d is None for d in divergences),
            first_divergence=[d for d in divergences if d is not None],
            checked_dispatches=checked[0],
            graph_captures=graphs["captures"],
            capture_ms=graphs["capture_ms"])
        if k == OVERLAP_KS[-1]:
            trace = trace_wave(engines[True], 3, smi,
                               phase="serve_overlap_trace")
            out[k].update(
                traced_idle_share_overlap=trace["wave_device_idle_share"],
                traced_idle_share_sync=sync_trace["wave_device_idle_share"],
                traced_chunk_step_overlap=trace["chunk_step"],
                traced_micro_step_overlap=trace["decode_or_micro_step"])
            totals["cuda"] += trace["kernel_launches"]
            totals["cuda_combine"] += trace["combine_launches"]
        del engines, engine
    # (c) int8 pools through the pipelined kernel.
    engine = ServingEngine(params, cfg, ServingConfig(
        **SERVE_KNOBS, micro_k=OVERLAP_KS[-1], overlap=True,
        kv_dtype="int8", decode_impl="pipelined"), device=device)
    warm_up(engine)
    checked = sync_checked(engine)
    with consume_waits() as waits:
        run = _timed_drain(engine, KVFLEET_SEED)
    quant = overlap_wave_line(run, engine, "overlap", waits)
    emit("serve_overlap_wave", **quant, gpu=smi)
    gate(quant, engine, checked, "(c) int8")
    totals["pipelined"] += run["kernel_launches"]
    totals["pipelined_combine"] += run["combine_launches"]
    out["int8"] = dict(tokens_per_s=quant["tokens_per_s"],
                       checked_dispatches=checked[0],
                       graph_captures=engine.stats()["step_graph"][
                           "captures"])
    return out, totals, failures


def phase_serve_overlap(device, smi: str, sync_trace: dict) -> dict:
    """Phase 29: the overlapped loop, legs (a)-(d). Returns the launches
    of the tiny legs (``parity``) and of the flagship's overlapped waves
    (``flagship``)."""
    t0 = time.perf_counter()
    parity = overlap_parity_tiny(device)
    flagship, totals, failures = overlap_flagship(device, smi, sync_trace)
    line = dict(flagship, launches=totals, parity_launches=parity,
                seconds=time.perf_counter() - t0, gpu=smi)
    line["failures"] = failures
    emit("serve_overlap", **{str(key): v for key, v in line.items()})
    if failures:
        raise AssertionError(f"serve_overlap: {failures}")
    return {"flagship": totals, "parity": parity}


# -- the host KV tier (A9) -------------------------------------------------------

#: Phase 30's tiny soak: 10 sessions of 3 turns (16-token first contexts,
#: 4, 7 or 10 new and 1 appended tokens a turn) on a pool of 11 usable
#: blocks, a fifth of the sessions' final contexts (53 blocks), under a
#: 64-block host tier; the pressure-free twin has 160 blocks.
TIER_TINY = dict(slots=2, max_len=64)
TIER_TINY_POOL = dict(n_blocks=12, host_offload_blocks=64)
TIER_TINY_FREE_BLOCKS = 160
#: Phase 30's flagship traffic: 32 sessions of 2 turns (80 before phase
#: 33 took their time), a 256-token first prompt, 32 new tokens a turn and
#: 16 appended ones, every fourth request keyed sampled. The pool is 16
#: slots x 22 blocks + 1 (half the sessions' final 21 blocks each); the
#: pressure-free engine holds them all.
TIER_SESSIONS, TIER_PROMPT, TIER_NEW, TIER_APPEND = 32, 256, 32, 16
TIER_BLOCKS = 16 * 22 + 1
TIER_FREE_BLOCKS = TIER_SESSIONS * 21 + 1
TIER_HOST_BLOCKS = 4096
#: The engine methods of a tier's migration that must not wait for the
#: device with a program in flight, beside the overlapped dispatch.
TIER_CHECKED = ("_dispatch_next", "_demote_pass", "_finalize_demotions",
                "_import_hash_chain")


def tier_sessions(engine, base: int, turns: int = 3) -> list:
    """The tiny soak from context ``base``: each turn resubmits every
    session's whole context for 4, 7 or 10 new tokens (so slots retire
    apart, each while the other's program runs; every third session keyed
    sampled) and drains; returns each turn's streams."""
    ctxs = [list(range(base + s, base + s + 16)) for s in range(10)]
    streams = []
    for t in range(turns):
        rids = [engine.submit(
            np.asarray(ctx), 4 + 3 * (s % 3),
            **({"temperature": 0.8, "top_p": 0.9, "key": [base + s, t]}
               if s % 3 == 2 else {}))
            for s, ctx in enumerate(ctxs)]
        engine.drain(max_steps=5000)
        outs = [list(engine.request(r).tokens) for r in rids]
        streams.append(outs)
        for s, out in enumerate(outs):
            ctxs[s] += out + [(3 * s + 7 * t) % 200 + 1]
    return streams


def tier_checked(engine) -> dict:
    """Run the overlapped dispatch, the demote pass, the force and the
    promotion import of ``engine`` under
    ``torch.cuda.set_sync_debug_mode("error")``, so that any wait for the
    device in them raises. Returns, per method, how many of its calls
    moved work (a dispatch, staged or demoted blocks, imported blocks)
    while a program was in flight."""
    in_flight = [None]
    dispatch = engine._dispatch_next

    def dispatched(finished):
        in_flight[0] = dispatch(finished)
        return in_flight[0]

    engine._dispatch_next = dispatched
    moved = {name: 0 for name in TIER_CHECKED}
    for name in TIER_CHECKED:
        inner = getattr(engine, name)

        def checked(*args, inner=inner, name=name):
            before = (engine.demoted_blocks, len(engine._pending_demotions))
            live = (engine._inflight if name in (
                "_dispatch_next", "_import_hash_chain") else in_flight[0]) \
                is not None
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = inner(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if name in ("_dispatch_next", "_import_hash_chain"):
                did = bool(out)
            else:
                did = (engine.demoted_blocks,
                       len(engine._pending_demotions)) != before
            moved[name] += int(did and live)
            return out

        setattr(engine, name, checked)
    return moved


def tier_parity_tiny(device) -> dict:
    """Leg (a): the tiny preset at fp32 through ``"cuda"``, ``"pipelined"``
    and the plain version at K 1 and 4, synchronous and overlapped, on the
    tiny soak from two bases in turn. Gates: every stream equal to the
    pressure-free engine's at that K (the plain route's, computed once a
    K), blocks demoted and promoted in both loops,
    the launches those of the programs through the route alone, and in
    the overlapped engine's second pass (its first captured the carry
    graphs) every dispatch, demote pass, force and promotion checked by
    ``tier_checked``, each of them moving work with a program in flight.
    Returns the kernels' and combine's launches of the tiered engines."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.serve.replica import SERVING_PRESETS, build_engine

    base = build_engine("tiny", device=device)
    totals = {"cuda": 0, "pipelined": 0, "combine": 0}
    failures, wants = [], {}
    for impl in ("cuda", "pipelined", "reference"):
        for k in (1, 4):
            knobs = dict(SERVING_PRESETS["tiny"], **TIER_TINY,
                         decode_impl=impl, micro_k=k)

            def make(**over):
                return ServingEngine(base.params, base.cfg, ServingConfig(
                    **{**knobs, **over}), device=device)

            if k not in wants:
                free = make(n_blocks=TIER_TINY_FREE_BLOCKS,
                            decode_impl="reference")
                wants[k] = [tier_sessions(free, 1), tier_sessions(free, 40)]
                del free
            want = wants[k]
            line = dict(kernel=impl, micro_k=k)
            for overlap in (False, True):
                engine = make(**TIER_TINY_POOL, overlap=overlap)
                pa.reset_launch_counts()
                got = [tier_sessions(engine, 1)]
                moved = tier_checked(engine) if overlap else None
                got.append(tier_sessions(engine, 40))
                s = engine.stats()
                calls = (s["chunk_steps"] + s["decode_steps"]
                         + (k - 1) * s["micro_steps"])
                launches = dict(s["attention_launches"])
                expect = {name: 0 for name in launches}
                expect[impl] = engine.cfg.n_layers * calls
                combines = (pa.paged_decode_attention.combine_launches
                            + pa.paged_decode_pipelined_attention
                            .combine_launches)
                arm = "overlap" if overlap else "sync"
                line[arm] = dict(
                    streams_equal_free=got == want,
                    demoted=s["tiering"]["demoted_blocks"],
                    promoted=s["tiering"]["promoted_blocks"],
                    host_hits=s["tiering"]["host_hits"],
                    evictions=s["prefix_cache"]["evictions"],
                    preemptions=s["recompute_preemptions"],
                    launches_ok=launches == expect,
                    launches=launches[impl], combines=combines,
                    checked_moving=moved)
                if impl != "reference":
                    totals[impl] += launches[impl]
                    totals["combine"] += combines
                ok = (got == want and line[arm]["demoted"] > 0
                      and line[arm]["promoted"] > 0
                      and line[arm]["launches_ok"]
                      and (moved is None or min(moved.values()) > 0))
                if not ok:
                    failures.append(f"(a) {impl} K {k} {arm}: {line[arm]}")
                del engine
            emit("serve_tier_parity", **line)
    return totals, failures


def tier_traffic(vocab: int, seed: int = 30) -> list:
    """Phase 30's flagship sessions: (first prompt, appended tokens,
    sampling kwargs) each."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=TIER_PROMPT),
             rng.integers(0, vocab, size=TIER_APPEND),
             {"temperature": 0.8, "top_p": 0.9,
              "key": np.array([3000 + i, i], np.uint32)} if i % 4 == 3
             else {})
            for i in range(TIER_SESSIONS)]


class TierProbe:
    """Times an engine's migration: each demote pass's staging (device ms
    between events around its gathers and copy out, host ms of the
    enqueue, launches, blocks), each force's host ms, and each promotion
    upload (device ms around the upload and writes, host ms, blocks).
    With ``check_bytes`` every block promoted from host RAM is read back
    right after its write and held to its tier payload byte for byte."""

    def __init__(self, engine, check_bytes: bool = False):
        from tpu_task_torch.ml.serving import cache
        from tpu_task_torch.ml.serving import engine as engine_module

        self.engine, self.nbytes = engine, cache.block_payload_nbytes(
            engine.cfg, engine.scfg)
        self.stagings, self.forces, self.uploads = [], [], []
        self.checked_blocks, self.byte_mismatches = 0, 0
        probe, staging = self, engine_module.BlockStaging
        write = engine_module.write_block_payloads

        class Timed(staging):
            def __init__(self, pools, blocks):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                super().__init__(pools, blocks)
                end.record()
                probe.stagings.append(dict(
                    blocks=len(blocks), launches=self.launches,
                    host_ms=(time.perf_counter() - t0) * 1e3,
                    events=(start, end)))

        def timed_write(pools, dsts, payloads):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            write(pools, dsts, payloads)
            end.record()
            probe.uploads.append(dict(
                blocks=len(payloads),
                host_ms=(time.perf_counter() - t0) * 1e3,
                events=(start, end)))

        force = engine._finalize_demotions

        def timed_force():
            t0 = time.perf_counter()
            force()
            if probe.stagings:
                probe.forces.append((time.perf_counter() - t0) * 1e3)

        self._restore = (engine_module, staging, write)
        engine_module.BlockStaging = Timed
        engine_module.write_block_payloads = timed_write
        engine._finalize_demotions = timed_force
        if check_bytes:
            imports = engine._import_hash_chain

            def checked_import(want):
                promoted = engine.promoted_blocks
                got = imports(want)
                n = engine.promoted_blocks - promoted
                for h, block in zip(want[:n], got[:n]):
                    probe.checked_blocks += 1
                    probe.byte_mismatches += int(
                        cache.export_block_bytes(engine.pools, block)
                        != engine._host_tier._entries[h])
                return got

            engine._import_hash_chain = checked_import

    def close(self) -> dict:
        """Put the engine module back and summarize (after a synchronize,
        so every event has completed)."""
        module, staging, write = self._restore
        module.BlockStaging, module.write_block_payloads = staging, write
        torch.cuda.synchronize()

        def device_ms(rows):
            return sum(r["events"][0].elapsed_time(r["events"][1])
                       for r in rows)

        demoted = sum(r["blocks"] for r in self.stagings)
        promoted = sum(r["blocks"] for r in self.uploads)
        d_ms, p_ms = device_ms(self.stagings), device_ms(self.uploads)
        return dict(
            demote_passes=len(self.stagings), staged_blocks=demoted,
            staged_mb=demoted * self.nbytes / 1e6,
            launches_per_demote_pass=(
                sum(r["launches"] for r in self.stagings)
                / max(1, len(self.stagings))),
            demote_device_ms=d_ms,
            demote_gb_per_s=(demoted * self.nbytes / d_ms / 1e6
                             if d_ms else None),
            demote_enqueue_host_ms=sum(r["host_ms"] for r in self.stagings),
            force_host_ms=sum(self.forces), forces=len(self.forces),
            promote_uploads=len(self.uploads), uploaded_blocks=promoted,
            uploaded_mb=promoted * self.nbytes / 1e6,
            promote_device_ms=p_ms,
            promote_gb_per_s=(promoted * self.nbytes / p_ms / 1e6
                              if p_ms else None),
            promote_host_ms=sum(r["host_ms"] for r in self.uploads),
            checked_promoted_blocks=self.checked_blocks,
            promoted_byte_mismatches=self.byte_mismatches)


def tier_turns(engine, traffic: list, probe=None) -> dict:
    """The flagship sessions' two turns through ``engine``, each a
    ``_timed_drain`` (launch gates) under ``consume_waits``. Returns the
    turns' runs, each session's streams, and the migration summary."""
    runs, streams = [], [[] for _ in traffic]
    ctxs = [prompt for prompt, _, _ in traffic]
    for turn in range(2):
        def load(turn=turn):
            rids = [engine.submit(ctx, TIER_NEW, **kw)
                    for ctx, (_, _, kw) in zip(ctxs, traffic)]
            return rids, sum(len(ctx) for ctx in ctxs)

        with consume_waits() as waits:
            run = _timed_drain(engine, 0, TIER_NEW, load=load)
        run["consume_wait_s"], run["consume_waits"] = waits
        run["overlapped_host_s"] = \
            engine.stats()["goodput"]["overlapped_host_s"]
        runs.append(run)
        for s, rid in enumerate(run["rids"]):
            streams[s].append(list(engine.request(rid).tokens))
        ctxs = [np.concatenate([ctx, np.asarray(out[-1], np.int64),
                                traffic[s][1]])
                for s, (ctx, out) in enumerate(zip(ctxs, streams))]
    return dict(runs=runs, streams=streams, ctxs=ctxs,
                migration=probe.close() if probe is not None else None)


def resume_ttft(engines: dict, ctxs: dict, per_class: int = 5) -> dict:
    """Resume time to first token by residency, as JAX's tiering bench
    defines it: one session resumed at a time on an idle engine, its
    next-turn context submitted and stepped until its first token. A
    session whose chain the tiered engine still holds in its pool is an
    HBM hit, one it holds only in host RAM a host promotion; on the no-tier
    twin a session whose chain was evicted recomputes. Each resume is
    classed again by what it did (blocks promoted, prefix blocks hit).
    Returns per class the p50 ms, the resumes and their ms."""
    from tpu_task_torch.ml.serving.cache import chain_block_hashes

    out = {"hbm_hit": [], "host_promote": [], "recompute": []}
    for name, want in (("tier", ("hbm_hit", "host_promote")),
                       ("twin", ("recompute",))):
        engine = engines[name]
        bs = engine.scfg.block_size
        for s, ctx in enumerate(ctxs[name]):
            chain = chain_block_hashes(ctx, bs)[:20]
            if engine._pcache.has(chain[-1]) and \
                    engine._pcache.has(chain[0]):
                where = "hbm_hit"
            elif engine._host_tier is not None and \
                    engine._host_tier.chain_depth(chain) == len(chain) \
                    and not engine._pcache.has(chain[0]):
                where = "host_promote"
            elif engine._host_tier is None and \
                    not engine._pcache.has(chain[0]):
                where = "recompute"
            else:
                continue
            if where not in want or len(out[where]) >= per_class:
                continue
            promoted, hits = engine.promoted_blocks, engine.prefix_hit_blocks
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rid = engine.submit(ctx, 1)
            while not engine.request(rid).tokens:
                engine.step()
            ms = (time.perf_counter() - t0) * 1e3
            engine.drain()
            did = ("host_promote" if engine.promoted_blocks > promoted
                   else "hbm_hit" if engine.prefix_hit_blocks > hits
                   else "recompute")
            out[did].append(ms)
    return {where: dict(resumes=len(ms), p50_ms=(float(np.median(ms))
                                                 if ms else None),
                        ms=ms)
            for where, ms in out.items()}


def free_streams(engine, res: dict, free: dict) -> dict:
    """Streams of ``res`` (``tier_turns`` through ``engine``) against the
    pressure-free engine's: equal sessions per turn (turn 2 only where
    turn 1 agreed, else its context differs) and the first few
    divergences with ``engine``'s top-2 logit gap there."""
    equal, parts = [0, 0], []
    for s, (mine, ref) in enumerate(zip(res["streams"], free["streams"])):
        for turn in range(2):
            if turn and mine[0] != ref[0]:
                break
            if mine[turn] == ref[turn]:
                equal[turn] += 1
            elif len(parts) < 4:
                part = first_divergence(
                    engine, res["runs"][turn]["rids"][s], ref[turn])
                parts.append(dict(part, session=s, turn=turn + 1))
    return dict(streams_equal_free=equal, first_divergences=parts)


def tier_flagship(device, smi: str) -> tuple:
    """Legs (b) and (c): the flagship with bf16 pools through the tile
    kernel, tiered, overlapped and synchronous, beside a no-tier twin of
    the same pool and a pressure-free engine, all overlapped but the
    synchronous tiered one; then int8 pools through the pipelined kernel,
    tiered and overlapped. Gates: every wave complete at 32 tokens a
    request with phase 6's launch gates, and every block promoted in the
    synchronous and int8 runs equal to its tier payload byte for byte.
    Returns the lines, the kernels' and combine's launches of the tiered
    runs, and the failures."""
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg, params = flagship_model(device)
    traffic = tier_traffic(cfg.vocab_size)
    totals = {"cuda": 0, "pipelined": 0, "cuda_combine": 0,
              "pipelined_combine": 0}
    failures, out, engines, ctxs = [], {}, {}, {}
    arms = (("free", dict(n_blocks=TIER_FREE_BLOCKS, overlap=True)),
            ("tier", dict(host_offload_blocks=TIER_HOST_BLOCKS,
                          overlap=True)),
            ("twin", dict(overlap=True)),
            ("tier_sync", dict(host_offload_blocks=TIER_HOST_BLOCKS)))
    results = {}
    for arm, knobs in arms:
        engine = ServingEngine(params, cfg, ServingConfig(**{
            **SERVE_KNOBS, "n_blocks": TIER_BLOCKS, **knobs}),
            device=device)
        warm_up(engine)
        probe = (TierProbe(engine, check_bytes=arm == "tier_sync")
                 if arm.startswith("tier") else None)
        res = results[arm] = tier_turns(engine, traffic, probe)
        for turn, run in enumerate(res["runs"]):
            if not wave_ok(run):
                failures.append(f"(b) {arm} turn {turn + 1}: " + str({
                    key: run[key] for key in (
                        "all_finished", "kernel_launches",
                        "expected_launches", "combine_launches",
                        "expected_combine_launches", "plain_launches",
                        "other_kernel_launches")}))
            if arm.startswith("tier"):
                totals["cuda"] += run["kernel_launches"]
                totals["cuda_combine"] += run["combine_launches"]
        if arm in ("tier", "twin"):
            engines[arm], ctxs[arm] = engine, res["ctxs"]
        tiering = engine.stats()["tiering"]
        runs = res["runs"]
        wall = sum(r["wall_s"] for r in runs)
        line = dict(
            arm=arm, overlap=engine.scfg.overlap,
            n_blocks=engine.scfg.n_blocks,
            pool_mb=engine.stats()["kv_pool_bytes"] / 1e6,
            tokens_per_s=sum(r["generated_tokens"] for r in runs) / wall,
            turn_tokens_per_s=[r["tokens_per_s"] for r in runs],
            turn_wall_s=[r["wall_s"] for r in runs],
            chunk_steps=[r["chunk_steps"] for r in runs],
            decode_steps=[r["decode_steps"] for r in runs],
            mean_chunk_step_ms=[r["mean_chunk_step_ms"] for r in runs],
            preemptions=[r["preemptions"] for r in runs],
            host_gap_frac=[r["host_gap_frac"] for r in runs],
            overlapped_host_s=[r["overlapped_host_s"] for r in runs],
            consume_wait_s=[r["consume_wait_s"] for r in runs],
            prefix_hit_blocks=engine.prefix_hit_blocks,
            evictions=engine.stats()["prefix_cache"]["evictions"],
            tiering=tiering, migration=res["migration"],
            kernel_launches=sum(r["kernel_launches"] for r in runs),
            combine_launches=sum(r["combine_launches"] for r in runs),
            waves_ok=all(wave_ok(r) for r in runs), gpu=smi)
        out[arm] = line
        if arm.startswith("tier") and not (
                tiering["demoted_blocks"] > 0
                and tiering["promoted_blocks"] > 0):
            failures.append(f"(b) {arm}: nothing migrated: {tiering}")
        if arm == "tier_sync" and (
                res["migration"]["promoted_byte_mismatches"]
                or not res["migration"]["checked_promoted_blocks"]):
            failures.append(f"(b) promoted bytes: {res['migration']}")
        if arm != "free":
            line.update(free_streams(engine, res, results["free"]))
        if arm not in engines:
            del engine
    out["ttft_by_residency"] = resume_ttft(engines, ctxs)
    out["tier_over_twin_tokens_per_s"] = (out["tier"]["tokens_per_s"]
                                          / out["twin"]["tokens_per_s"])
    del engines
    for arm in ("tier", "twin", "free", "tier_sync"):
        emit("serve_tier_wave", **out[arm])
    emit("serve_tier_resume", ttft=out["ttft_by_residency"], gpu=smi)
    # (c) int8 pools through the pipelined kernel, one pass.
    engine = ServingEngine(params, cfg, ServingConfig(
        **{**SERVE_KNOBS, "n_blocks": TIER_BLOCKS}, kv_dtype="int8",
        decode_impl="pipelined", host_offload_blocks=TIER_HOST_BLOCKS,
        overlap=True), device=device)
    warm_up(engine)
    res = tier_turns(engine, traffic, TierProbe(engine, check_bytes=True))
    runs = res["runs"]
    quant = dict(
        arm="tier_int8", kernel=engine.decode_impl,
        tokens_per_s=(sum(r["generated_tokens"] for r in runs)
                      / sum(r["wall_s"] for r in runs)),
        tiering=engine.stats()["tiering"], migration=res["migration"],
        kernel_launches=sum(r["kernel_launches"] for r in runs),
        combine_launches=sum(r["combine_launches"] for r in runs),
        waves_ok=all(wave_ok(r) for r in runs), gpu=smi)
    emit("serve_tier_wave", **quant)
    totals["pipelined"] += quant["kernel_launches"]
    totals["pipelined_combine"] += quant["combine_launches"]
    if not (quant["waves_ok"] and quant["tiering"]["promoted_blocks"] > 0
            and quant["migration"]["checked_promoted_blocks"] > 0
            and not quant["migration"]["promoted_byte_mismatches"]):
        failures.append(f"(c) int8: {quant}")
    out["int8"] = quant
    return out, totals, failures


def pinned_copy_rates(device, mib: int = 64, reps: int = 5) -> dict:
    """The bus the tier crosses, alone: GB/s of one ``mib`` MiB copy
    between the card and fresh pinned host memory each way (median of
    ``reps``, CUDA events around each non-blocking copy)."""
    dev = torch.empty((mib << 20,), dtype=torch.uint8, device=device)
    host = torch.empty(dev.shape, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        ms = []
        for _ in range(reps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        out[f"{name}_gb_per_s"] = dev.numel() / float(np.median(ms[1:])) / 1e6
    return out


def phase_serve_tier(device, smi: str) -> dict:
    """Phase 30: the host KV tier, legs (a)-(c). Returns the launches of
    the tiny legs (``parity``) and of the flagship's tiered runs
    (``flagship``)."""
    t0 = time.perf_counter()
    parity, failures = tier_parity_tiny(device)
    flagship, totals, more = tier_flagship(device, smi)
    failures += more
    emit("serve_tier", launches=totals, parity_launches=parity,
         pinned_copy=pinned_copy_rates(device),
         tier_over_twin_tokens_per_s=flagship["tier_over_twin_tokens_per_s"],
         ttft_by_residency={k: v["p50_ms"] for k, v in
                            flagship["ttft_by_residency"].items()},
         seconds=time.perf_counter() - t0, failures=failures, gpu=smi)
    if failures:
        raise AssertionError(f"serve_tier: {failures}")
    return {"flagship": totals, "parity": parity}


# -- phase 31: mixture-of-experts layers (A13) --------------------------------

#: Phase 31's serve model: the serve flagship with every second layer a
#: mixture-of-experts layer of 8 experts, top-2 (about 0.41 B parameters).
FLAGSHIP_MOE = dict(FLAGSHIP, moe_every=2, n_experts=8, moe_top_k=2)
#: Phase 31's train model: the train flagship with the same MoE layers.
TRAIN_FLAGSHIP_MOE = dict(TRAIN_FLAGSHIP, moe_every=2, n_experts=8,
                          moe_top_k=2)
#: Leg (a)'s top-2 config: the ``tiny`` preset's geometry, its second layer
#: a 4-expert top-2 MoE layer (the ``moe`` preset is top-1).
MOE_TINY_TOP2 = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=8,
                     d_head=16, d_ff=256, n_kv_heads=4, moe_every=2,
                     n_experts=4, moe_top_k=2)
#: Leg (a)'s legs: (name, ServingConfig overrides, sampled requests).
MOE_LEGS = (("greedy_k1", {}, False), ("greedy_k4", {"micro_k": 4}, False),
            ("sampled_k1", {}, True), ("spec_k2", {"spec_k": 2}, True),
            ("overlap_k4", {"overlap": True, "micro_k": 4}, True))
#: Leg (a)'s kernel routes, each held to the plain route at its storage.
MOE_ROUTES = (("cuda", None), ("pipelined", "int8"))
#: The dense dispatch on the card against the CPU's, fp32 (TF32 off).
MOE_EXPERT_ATOL = 1e-5
#: Leg (c)'s timed steps (after one warm-up step).
MOE_TRAIN_STEPS = 6


def moe_traffic(vocab: int, sampled: bool) -> list:
    """Leg (a)'s 5 requests (8 before phase 34) of 3-24 prompt tokens and
    6-18 new tokens, every second one keyed-sampled at temperature 0.8 /
    top_p 0.9 when ``sampled``, each followed by 0-2 steps before the next
    arrives, as ``run_arrivals`` takes them."""
    rng = np.random.default_rng(31)
    out = []
    for i in range(5):
        prompt = rng.integers(0, vocab, size=int(rng.integers(3, 25)))
        kw = ({"temperature": 0.8, "top_p": 0.9, "key": [31, i]}
              if sampled and i % 2 else {})
        out.append((prompt, int(rng.integers(6, 19)), kw,
                    int(rng.integers(0, 3))))
    return out


def moe_tiny_models(device) -> dict:
    """Leg (a)'s models at fp32: name → (cfg, params on the CPU, serving
    knobs). The ``moe`` preset holds the JAX package's weights; the top-2
    config's are drawn from a seeded generator."""
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.serve.replica import SERVING_PRESETS, build_engine

    preset = build_engine("moe", device="cpu")
    cfg = transformer.TransformerConfig(dtype=torch.float32, **MOE_TINY_TOP2)
    params = transformer.init(torch.Generator().manual_seed(7), cfg)
    return {"moe": (preset.cfg, preset.params, SERVING_PRESETS["moe"]),
            "top2": (cfg, params, SERVING_PRESETS["tiny"])}


def moe_expert_check(models: dict, device) -> dict:
    """The dense dispatch of each tiny model's first MoE layer on the card
    against the CPU's on the same fp32 inputs: output and aux within
    MOE_EXPERT_ATOL, expert choices equal."""
    from tpu_task_torch.ml.models import moe

    out = {}
    for name, (cfg, params, _) in models.items():
        index = next(i for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
        layer = {k: params["layers"][index][k]
                 for k in ("router", "w_in", "w_out")}
        h = torch.randn((3, 17, cfg.d_model),
                        generator=torch.Generator().manual_seed(5))
        want, want_aux = moe.apply_dense(layer, cfg.moe_cfg, h)
        card = {k: v.to(device) for k, v in layer.items()}
        got, got_aux = moe.apply_dense(card, cfg.moe_cfg, h.to(device))
        chosen = [moe._route(t.reshape(-1, cfg.d_model), w["router"],
                             cfg.moe_cfg)[0].cpu()
                  for t, w in ((h, layer), (h.to(device), card))]
        out[name] = dict(
            layer=index, top_k=cfg.moe_top_k,
            max_abs_err=float((got.cpu() - want).abs().max()),
            aux_err=abs(float(got_aux) - float(want_aux)),
            experts_equal=bool(torch.equal(*chosen)))
        out[name]["ok"] = (out[name]["max_abs_err"] <= MOE_EXPERT_ATOL
                           and out[name]["aux_err"] <= MOE_EXPERT_ATOL
                           and out[name]["experts_equal"])
    return out


def moe_parity_tiny(device) -> tuple:
    """Leg (a): each tiny model on each leg of MOE_LEGS, through each
    kernel route and the plain route at the same storage. Each engine runs
    its traffic twice (on the overlap leg the second pass runs the
    dispatch region under the sync debug mode). Gates: the kernel route's
    streams equal the plain route's in both passes, every launch through
    the route's attention alone (n_layers a chunk program, n_layers x K a
    micro program, off the spec leg whose draft calls the same kernel),
    the checked dispatches clean. Returns the kernels' and combine's
    launches and the failures."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    models = moe_tiny_models(device)
    expert = moe_expert_check(models, device)
    emit("serve_moe_expert_check", atol=MOE_EXPERT_ATOL, **expert)
    failures = [f"(a) expert check {name}: {row}"
                for name, row in expert.items() if not row["ok"]]
    totals = {"cuda": 0, "pipelined": 0, "combine": 0}
    for name, (cfg, params, knobs) in models.items():
        for leg, serving, sampled in MOE_LEGS:
            traffic = moe_traffic(cfg.vocab_size, sampled)
            spec = serving.get("spec_k", 0) > 0
            for impl, kv_dtype in MOE_ROUTES:
                runs = {}
                for route in (impl, "reference"):
                    engine = ServingEngine(
                        params, cfg, ServingConfig(**{
                            **knobs, **serving, "decode_impl": route,
                            "kv_dtype": kv_dtype}),
                        device=device, draft_params=params if spec else None,
                        draft_cfg=cfg if spec else None)
                    pa.reset_launch_counts()
                    first = run_arrivals(engine, traffic)
                    checked = ([0] if route == "reference"
                               or not serving.get("overlap")
                               else sync_checked(engine))
                    second = run_arrivals(engine, traffic)
                    s = engine.stats()
                    k = engine.scfg.micro_k
                    calls = (s["chunk_steps"] + s["decode_steps"]
                             + (k - 1) * s["micro_steps"])
                    launches = dict(s["attention_launches"])
                    want = {key: 0 for key in launches}
                    want[route] = (launches[route] if spec
                                   else engine.cfg.n_layers * calls)
                    combines = (pa.paged_decode_attention.combine_launches
                                + pa.paged_decode_pipelined_attention
                                .combine_launches)
                    runs[route] = dict(
                        streams=(first, second), launches=launches,
                        launches_ok=launches == want and launches[route] > 0,
                        combines=combines, checked=checked[0])
                    del engine
                kernel, plain = runs[impl], runs["reference"]
                line = dict(
                    model=name, leg=leg, kernel=impl,
                    kv_dtype=kv_dtype or "float32",
                    streams_equal_plain=kernel["streams"] == plain["streams"],
                    requests=2 * len(traffic),
                    tokens=sum(len(s) for s in kernel["streams"][0]),
                    kernel_launches=kernel["launches"][impl],
                    combine_launches=kernel["combines"],
                    launches_ok=(kernel["launches_ok"],
                                 plain["launches_ok"]),
                    checked_dispatches=kernel["checked"])
                emit("serve_moe_parity", **line)
                totals[impl] += kernel["launches"][impl]
                totals["combine"] += kernel["combines"]
                if not (line["streams_equal_plain"] and all(
                        line["launches_ok"]) and (
                        not serving.get("overlap")
                        or kernel["checked"] > 0)):
                    failures.append(f"(a) {line}")
    return totals, expert, failures


def moe_flagship_model(device):
    from tpu_task_torch.ml.models import transformer

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP_MOE)
    params = transformer.init(
        torch.Generator(device=device).manual_seed(0), cfg)
    return cfg, params


def moe_step_share(engine, seed: int) -> dict:
    """One decode step of 16 running requests (K 1, eager) under
    ``torch.profiler``: the device time of the kernels the dense dispatch
    launched against the step's device-busy time
    (``traced_range_share``); and the dispatch alone at that step's shape
    (16 rows, every MoE layer, cold L2), captured in a CUDA graph so that
    the host's enqueue of its launches stays out, timed with CUDA
    events."""
    from tpu_task_torch.ml.models import moe

    wave = _wave_requests(engine.cfg.vocab_size, seed)
    for prompt, kw in wave:
        engine.submit(prompt[:64], 24, **kw)
    while any(engine._prefilling(i) for i in range(engine.scfg.slots)) \
            or engine._queue:
        engine.step()                 # ingest: the next step is a decode
    traced = traced_range_share(engine, moe, "apply_dense", "moe_ffn")
    engine.drain()
    busy = traced["step_device_busy_ms"] * 1e3
    cfg, n = engine.cfg, engine.scfg.slots
    params = engine.params
    layers = [params["layers"][i] for i in range(cfg.n_layers)
              if cfg.is_moe_layer(i)]
    h = torch.randn((n, 1, cfg.d_model), device=engine.device,
                    dtype=cfg.dtype)

    def ffn():
        for layer in layers:
            moe.apply_dense(layer, cfg.moe_cfg, h)

    ffn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ffn()
    timed_ms = DeviceTimer(engine.device)(graph.replay)
    del graph
    # Expert weights a decode step reads once: the bound of the dispatch.
    weight_bytes = sum(layer[k].numel() * layer[k].element_size()
                       for layer in layers for k in ("w_in", "w_out"))
    return dict(step_device_busy_ms=traced["step_device_busy_ms"],
                step_kernels=traced["step_kernels"],
                moe_ffn_calls=traced["calls"],
                moe_ffn_device_ms=traced["range_device_ms"],
                moe_share_of_step=traced["share"],
                moe_ffn_graph_ms=timed_ms,
                moe_graph_share_of_step=timed_ms * 1e3 / busy if busy
                else None,
                expert_weight_bytes=weight_bytes,
                expert_weight_read_bound_ms=weight_bytes / HBM_BYTES_PER_S
                * 1e3)


#: Leg (b)'s engines: (name, ServingConfig overrides over SERVE_KNOBS).
MOE_SERVE_LEGS = (
    ("k1", {}),
    ("k8_overlap", {"micro_k": 8, "overlap": True}),
    ("int8_k8_overlap", {"micro_k": 8, "overlap": True, "kv_dtype": "int8",
                         "decode_impl": "pipelined"}))


def moe_flagship(device, smi: str, serve_median: float) -> tuple:
    """Leg (b): FLAGSHIP_MOE in bf16 on phase 6's configuration, and a
    dense twin (phase 6's flagship) of each engine: after phase 6's
    warm-up, one timed wave of phase 6's seed-0 traffic at each of
    MOE_SERVE_LEGS, twin first; phase 6's launch gates, every K = 1 MoE
    step's logits finite. Tokens/s against the twin's and phase 6's
    median (``serve_median``), streams against the K = 1 leg's, and the
    dispatch's share of one traced decode step. Returns the legs' lines,
    the kernels' and combine's launches of the MoE waves and the
    failures."""
    from tpu_task_torch.ml.serving import model as serving_model
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    models = {"dense": flagship_model(device),
              "moe": moe_flagship_model(device)}
    n_params = sum(p.numel() for p in models["moe"][1].values()
                   if torch.is_tensor(p))
    n_params += sum(p.numel() for layer in models["moe"][1]["layers"]
                    for p in layer.values())
    totals = {"cuda": 0, "pipelined": 0, "cuda_combine": 0,
              "pipelined_combine": 0}
    lines, failures, reference = {}, [], None
    for name, serving in MOE_SERVE_LEGS:
        twin = {}
        for model in ("dense", "moe"):
            cfg, params = models[model]
            torch.cuda.reset_peak_memory_stats()
            engine = ServingEngine(params, cfg,
                                   ServingConfig(**SERVE_KNOBS, **serving),
                                   device=device)
            warm_up(engine)
            finite = torch.ones((), dtype=torch.bool, device=device)
            step_fn = serving_model.paged_decode_step

            def checked_step(*args, **kwargs):
                out = step_fn(*args, **kwargs)
                logits = out[0] if isinstance(out, tuple) else out
                finite.logical_and_(torch.isfinite(logits).all())
                return out

            if name == "k1":
                serving_model.paged_decode_step = checked_step
            try:
                run = _timed_drain(engine, 0)
            finally:
                serving_model.paged_decode_step = step_fn
            if not wave_ok(run):
                failures.append(f"(b) {name} {model}: {run}")
            if model == "dense":
                twin = {key: run[key] for key in (
                    "tokens_per_s", "mean_decode_step_ms",
                    "mean_chunk_step_ms")}
                del engine
                continue
            streams = [engine.request(rid).tokens for rid in run["rids"]]
            if reference is None:
                reference = streams
            impl = engine.decode_impl
            totals[impl] += run["kernel_launches"]
            totals[f"{impl}_combine"] += run["combine_launches"]
            line = dict(
                leg=name, params=n_params, micro_k=engine.scfg.micro_k,
                overlap=engine.scfg.overlap,
                kv_dtype=engine.scfg.kv_dtype or "bfloat16", kernel=impl,
                tokens_per_s=run["tokens_per_s"],
                dense_twin_tokens_per_s=twin["tokens_per_s"],
                moe_over_dense=run["tokens_per_s"] / twin["tokens_per_s"],
                serve_phase_median_tokens_per_s=serve_median,
                mean_decode_step_ms=run["mean_decode_step_ms"],
                mean_chunk_step_ms=run["mean_chunk_step_ms"],
                dense_twin_mean_decode_step_ms=twin["mean_decode_step_ms"],
                dense_twin_mean_chunk_step_ms=twin["mean_chunk_step_ms"],
                chunk_steps=run["chunk_steps"],
                decode_steps=run["decode_steps"],
                micro_steps=run["micro_steps"],
                host_gap_frac=run["host_gap_frac"],
                kernel_launches=run["kernel_launches"],
                expected_launches=run["expected_launches"],
                combine_launches=run["combine_launches"],
                other_kernel_launches=run["other_kernel_launches"],
                plain_launches=run["plain_launches"],
                graph_captures=engine.stats()["step_graph"]["captures"],
                streams_equal_k1=sum(a == b
                                     for a, b in zip(streams, reference)),
                logits_finite=bool(finite) if name == "k1" else None,
                wave_ok=wave_ok(run),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            if name == "k1":
                line.update(moe_step_share(engine, 3))
                if not line["logits_finite"]:
                    failures.append(f"(b) {name}: logits not finite")
            emit("serve_moe_wave", **line, gpu=smi)
            lines[name] = line
            del engine
    return lines, totals, failures


def expert_products_ms(device, cfg, tokens: int) -> float:
    """Device ms of one MoE layer's expert products in the train step, in
    float32 as the promotion makes them: (experts, tokens, d_model) through
    ``w_in``, silu, ``w_out``, and the backward of all three, timed alone
    with CUDA events."""
    gen = torch.Generator(device=device).manual_seed(3)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    x = torch.randn((e, tokens, d), device=device, generator=gen,
                    requires_grad=True)
    w_in = torch.randn((e, d, f), device=device, generator=gen,
                       requires_grad=True)
    w_out = torch.randn((e, f, d), device=device, generator=gen,
                        requires_grad=True)
    g = torch.randn((e, tokens, d), device=device, generator=gen)

    def products():
        out = torch.bmm(torch.nn.functional.silu(torch.bmm(x, w_in)), w_out)
        torch.autograd.grad(out, (x, w_in, w_out), g)

    return DeviceTimer(device)(products, iters=5, warmup=1)


def moe_train(device, smi: str) -> tuple:
    """Leg (c): TRAIN_FLAGSHIP_MOE (bf16 over fp32 masters) at batch 8 x
    1024 through the flash kernels: one warm-up step, then
    MOE_TRAIN_STEPS steps on one batch with the flash launch counts set to
    0 just before them and read just after. Gates: finite losses, each
    step n_layers launches of each flash kernel and none of the plain
    versions. Reported: step ms, MFU under the MoE-aware FLOP model (top-k
    experts, as the goodput model counts them), peak memory, one profiled
    step, and the share of the step the float32 expert products take.
    Returns the flash launch counts and the failures."""
    from tpu_task_torch.ml import train
    from tpu_task_torch.ml.models import transformer
    from tpu_task_torch.ml.ops import attention as fa

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16,
                                        **TRAIN_FLAGSHIP_MOE)
    state = train.init_state(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    n_params = sum(p.numel() for p in train._leaves(state.params))
    tokens = torch.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    step = train.make_train_step(cfg)
    state, m = step(state, tokens)                            # warm-up
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    step_ms, per_step = [], []
    for _ in range(MOE_TRAIN_STEPS):
        before = flash_counts()
        t0 = time.perf_counter()
        state, m = step(state, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = flash_counts()
        per_step.append({key: after[key] - before[key] for key in after})
        losses.append(m["loss"])
    counts = flash_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in losses]
    median_ms = float(np.median(step_ms))
    flops = train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    expert_ms = expert_products_ms(device, cfg, TRAIN_BATCH * TRAIN_SEQ)
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "plain_fwd": 0, "plain_bwd": 0,
            "plain_mha": 0}
    line = dict(
        params=n_params, moe_layers=n_moe, n_experts=cfg.n_experts,
        top_k=cfg.moe_top_k, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        dtype="bfloat16", master_weights="float32", warmup_steps=1,
        timed_steps=len(step_ms), step_ms=step_ms, step_ms_median=median_ms,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / median_ms * 1e3,
        flops_per_step=flops, mfu=flops / (median_ms / 1e3) / BF16_FLOPS,
        mfu_flops="top-k experts counted (goodput.matmul_params); the "
                  "dense dispatch computes n_experts / top_k times their "
                  "expert products",
        expert_products_ms_per_layer=expert_ms,
        expert_products_share_of_step=expert_ms * n_moe / median_ms,
        losses=losses, loss_fell=losses[-1] < losses[0],
        launches_per_step=per_step[0],
        launches_every_step_as_expected=all(p == want for p in per_step),
        launches=counts, peak_memory_gb=peak, gpu=smi)
    emit("serve_moe_train", **line)
    failures = []
    if not (all(math.isfinite(x) for x in losses)
            and line["launches_every_step_as_expected"]):
        failures.append(f"(c) train: {line}")
    else:
        emit("serve_moe_train_profile",
             **profile_step(step, state, tokens, median_ms), gpu=smi)
    return counts, failures


def phase_serve_moe(device, smi: str, serve_median: float) -> dict:
    """Phase 31: mixture-of-experts layers, legs (a)-(c); ``serve_median``
    is phase 6's median tokens/s, reported beside leg (b)'s.
    Returns the launches of the tiny legs (``parity``), of the flagship's
    waves (``flagship``) and of the train steps (``train``)."""
    t0 = time.perf_counter()
    parity, expert, failures = moe_parity_tiny(device)
    t_parity = time.perf_counter() - t0
    lines, flagship, more = moe_flagship(device, smi, serve_median)
    failures += more
    t_serve = time.perf_counter() - t0 - t_parity
    train_counts, more = moe_train(device, smi)
    failures += more
    emit("serve_moe", launches=flagship, parity_launches=parity,
         train_launches={k: train_counts[k] for k in (
             "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
         expert_check={k: v["max_abs_err"] for k, v in expert.items()},
         moe_over_dense={k: v["moe_over_dense"] for k, v in lines.items()},
         seconds=time.perf_counter() - t0, parity_seconds=t_parity,
         serve_seconds=t_serve, failures=failures, gpu=smi)
    if failures:
        raise AssertionError(f"serve_moe: {failures}")
    return {"flagship": flagship, "parity": parity, "train": train_counts}


#: Phase 32's tiny legs: (name, ServingConfig overrides, sampled).
BUCKETED_LEGS = (("greedy_k1", {}, False), ("greedy_k4", {"micro_k": 4},
                                            False),
                 ("sampled_k1", {}, True), ("spec_k2", {"spec_k": 2}, True))
#: Phase 32's tiny presets with their bucketed knobs: the largest bucket is
#: the preset's max_len.
BUCKETED_TINY = {"tiny": (16, 32, 64, 128), "moe": (8, 16, 32, 48)}
#: Phase 32's flagship configuration: the JAX bench's
#: ``bench_serving_long_prompt`` engine (bench.py).
LONG_PROMPT_KNOBS = dict(slots=4, block_size=16, n_blocks=160, max_len=416,
                         prefill_buckets=(8, 384), chunk_tokens=16,
                         prefix_cache=False)
#: (runners, runner prompt, runner new tokens, long prompts, long prompt,
#: long new tokens), as the JAX bench.
LONG_PROMPT_TRAFFIC = (3, 8, 56, 6, 384, 4)


#: The schedule counters a launch gate reads.
GATE_KEYS = ("decode_steps", "micro_steps", "chunk_steps", "prefills")


def launch_gate(engine, launches: dict, combines: int, spec: bool,
                since=None) -> dict:
    """The attention launches of a run against its programs: n_layers a
    decode or chunk program, n_layers x K a micro program (a spec run's
    draft calls the same kernel, so only > 0 there), through the route
    alone, and the combine wherever the route's plan splits the decode
    (chunk) shape. ``since``: the counters (GATE_KEYS) when the launch
    counts were set to 0 (None: a fresh engine)."""
    stats = engine.stats()
    s = {key: stats[key] - (since or {}).get(key, 0) for key in GATE_KEYS}
    impl = engine.decode_impl
    calls = (s["decode_steps"] + (engine.scfg.micro_k - 1) * s["micro_steps"])
    plans = step_splits(engine)
    want = {key: 0 for key in launches}
    want[impl] = (launches[impl] if spec
                  else engine.cfg.n_layers * (calls + s["chunk_steps"]))
    want_combines = engine.cfg.n_layers * (
        calls * (plans["decode"] > 1)
        + s["chunk_steps"] * (plans["chunk"] > 1))
    return dict(kernel_launches=launches[impl], combine_launches=combines,
                launches_ok=(launches == want and launches[impl] > 0
                             and (spec or combines == want_combines)),
                expected_combine_launches=None if spec else want_combines,
                decode_splits=plans["decode"], decode_calls=calls,
                chunk_steps=s["chunk_steps"], prefills=s["prefills"])


def combine_count() -> int:
    from tpu_task_torch.ml.ops import paged_attention as pa

    return (pa.paged_decode_attention.combine_launches
            + pa.paged_decode_pipelined_attention.combine_launches)


def bucketed_parity_tiny(device) -> tuple:
    """Leg (a): each tiny preset on each of BUCKETED_LEGS through each of
    MOE_ROUTES, bucketed, against the same engine on the CPU's plain route.
    Returns the kernels' and combine's launches and the failures."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.serve.replica import SERVING_PRESETS, build_engine

    totals = {"cuda": 0, "pipelined": 0, "combine": 0}
    failures = []
    for preset, buckets in BUCKETED_TINY.items():
        base = build_engine(preset, device="cpu")
        cfg, params = base.cfg, base.params
        del base
        for leg, serving, sampled in BUCKETED_LEGS:
            traffic = moe_traffic(cfg.vocab_size, sampled)
            spec = serving.get("spec_k", 0) > 0
            for impl, kv_dtype in MOE_ROUTES:
                streams = {}
                for route, dev in (("reference", torch.device("cpu")),
                                   (impl, device)):
                    engine = ServingEngine(
                        params, cfg, ServingConfig(**{
                            **SERVING_PRESETS[preset], **serving,
                            "prefill": "bucketed", "prefix_cache": False,
                            "prefill_buckets": buckets,
                            "decode_impl": route, "kv_dtype": kv_dtype}),
                        device=dev, draft_params=params if spec else None,
                        draft_cfg=cfg if spec else None)
                    pa.reset_launch_counts()
                    streams[route] = run_arrivals(engine, traffic)
                gate = launch_gate(
                    engine, dict(engine.stats()["attention_launches"]),
                    combine_count(), spec)
                del engine
                line = dict(
                    preset=preset, leg=leg, kernel=impl,
                    kv_dtype=kv_dtype or "float32", buckets=list(buckets),
                    streams_equal_cpu_plain=(streams[impl]
                                             == streams["reference"]),
                    requests=len(traffic),
                    tokens=sum(len(s) for s in streams[impl]), **gate)
                emit("serve_bucketed_parity", **line)
                totals[impl] += line["kernel_launches"]
                totals["combine"] += line["combine_launches"]
                if not (line["streams_equal_cpu_plain"]
                        and line["launches_ok"] and line["chunk_steps"] == 0
                        and line["prefills"] >= len(traffic)):
                    failures.append(f"(a) {line}")
    return totals, failures


def long_prompt_traffic(vocab: int) -> tuple:
    """The JAX bench's prompts (``bench_serving_long_prompt``, seed 0):
    the runners' and the long ones."""
    n_run, run_len, _, n_long, long_len, _ = LONG_PROMPT_TRAFFIC
    rng = np.random.default_rng(0)
    runners = [rng.integers(0, vocab, size=run_len) for _ in range(n_run)]
    longs = [rng.integers(0, vocab, size=long_len) for _ in range(n_long)]
    return runners, longs


def long_prompt_leg(engine) -> dict:
    """The scenario on one engine, as the JAX bench runs it: a warm-up
    request of each kind drained, then the runners submitted and stepped
    until all run, then the long prompts submitted; each step's new runner
    tokens stamped with the step's end. The attention launches are set to
    0 just before the runners and read just after the drain."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    _, _, run_new, _, _, long_new = LONG_PROMPT_TRAFFIC
    runner_prompts, long_prompts = long_prompt_traffic(engine.cfg.vocab_size)
    engine.submit(runner_prompts[0], 2)           # the programs' first use
    engine.submit(long_prompts[0], 2)
    engine.drain()
    engine.goodput.reset()
    steps0 = {key: engine.stats()[key] for key in ("steps",) + GATE_KEYS}
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    runners = [engine.submit(p, run_new) for p in runner_prompts]
    while any(engine.poll(r)["status"] != "running" for r in runners):
        engine.step()
    longs = [engine.submit(p, long_new) for p in long_prompts]
    seen = {r: len(engine.poll(r)["tokens"]) for r in runners}
    stamps = {r: [] for r in runners}
    t_longs = time.perf_counter()
    while engine.has_work:
        engine.step()
        now = time.perf_counter()
        for r in runners:
            n = len(engine.poll(r)["tokens"])
            stamps[r] += [now] * (n - seen[r])
            seen[r] = n
    torch.cuda.synchronize()
    makespan = time.perf_counter() - t_longs
    launches = dict(engine.stats()["attention_launches"])
    combines = combine_count()
    gaps = [(b - a) * 1e3 for r in runners
            for a, b in zip(stamps[r], stamps[r][1:])]
    ttft = [(engine.request(r).first_token_t - engine.request(r).submit_t)
            * 1e3 for r in longs]
    stats = engine.stats()
    requests = [engine.request(r) for r in runners + longs]
    vocab = engine.cfg.vocab_size
    return dict(
        intertoken_p50_ms=float(np.percentile(gaps, 50)),
        intertoken_p99_ms=float(np.percentile(gaps, 99)),
        intertoken_max_ms=max(gaps), intertoken_gaps=len(gaps),
        long_ttft_p50_ms=float(np.percentile(ttft, 50)),
        long_ttft_max_ms=max(ttft), makespan_s=makespan,
        wall_with_runner_admission_s=time.perf_counter() - t0,
        **{key: stats[key] - steps0[key] for key in steps0}, since=steps0,
        host_gap_frac=stats["goodput"]["host_gap_frac"],
        dispatches_per_token=stats["goodput"]["dispatches_per_token"],
        all_finished=all(
            r.status == "done" and len(r.tokens) == r.max_new_tokens
            and all(0 <= t < vocab for t in r.tokens) for r in requests),
        streams=[list(r.tokens) for r in requests],
        launches=launches, combines=combines)


def prefill_device_ms(engine, mode: str) -> dict:
    """One 384-token prompt's ingestion by ``mode``'s programs on the
    engine's weights and pools (blocks 1-24, free after the drain): one
    ``paged_prefill`` at bucket 384, or the 24 chunk programs of 16 rows
    (each the engine's chunk-step shape, the decode rows inactive), under
    ``torch.profiler``: the union of the device kernels' spans (busy ms,
    the L2 warm) and the calls' wall, each synchronized. Run after the
    leg's launch counts are read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_task_torch.ml.serving import model as serving_model

    cfg, scfg, dev = engine.cfg, engine.scfg, engine.device
    long_len = LONG_PROMPT_TRAFFIC[4]
    prompt = torch.as_tensor(long_prompt_traffic(cfg.vocab_size)[1][0],
                             device=dev, dtype=torch.int64)
    need = scfg.blocks_for(long_len)
    table = torch.zeros((scfg.max_blocks_per_slot,), dtype=torch.int32,
                        device=dev)
    table[:need] = torch.arange(1, need + 1, device=dev)
    params = engine.params
    n, w = scfg.slots, scfg.chunk_tokens
    quant = engine._quantized
    layouts = []
    for start in range(0, long_len if mode == "chunked" else 0, w):
        positions = np.zeros((n + w,), np.int32)
        positions[n:] = np.arange(start, start + w)
        active = np.zeros((n + w,), bool)
        active[n:] = True
        tables = np.zeros((n + w, scfg.max_blocks_per_slot), np.int32)
        tables[n:] = table.cpu().numpy()
        qa = None
        if quant:
            qa = tuple(torch.as_tensor(a, device=dev) for a in
                       engine._quant_layout(tables, positions[:, None],
                                            active[:, None]))
        tokens = torch.zeros((n + w,), dtype=torch.int64, device=dev)
        tokens[n:] = prompt[start:start + w]
        layouts.append((tokens, torch.as_tensor(positions, device=dev),
                        torch.as_tensor(tables, device=dev),
                        torch.as_tensor(active, device=dev), qa))

    def run():
        with torch.no_grad():
            if mode == "bucketed":
                serving_model.paged_prefill(
                    params, cfg, prompt[None], long_len, table,
                    engine.pools)
                return
            for tokens, positions, tables, active, qa in layouts:
                serving_model.greedy_decode_step(
                    params, cfg, tokens, positions, tables, active,
                    engine.pools, qa, attn_impl=engine.decode_impl)

    run()                                      # first use off the clock
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime_tracer(dev)
        with record_function("prefill_384"):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    cpu = torch.autograd.DeviceType.CPU
    span = next(e for e in prof.events()
                if e.name == "prefill_384" and e.device_type == cpu)
    start, end = span.time_range.start, span.time_range.end
    busy, last, kernels = 0.0, -math.inf, 0
    for d_start, d_end in sorted((s, e) for name, s, e in device_events(prof)
                                 if name != "prefill_384"):
        if not start <= d_start <= end:
            continue
        kernels += 1
        if d_end > last:
            busy += d_end - max(d_start, last)
            last = d_end
    return dict(prefill_384_device_busy_ms=busy / 1e3,
                prefill_384_wall_ms=wall * 1e3,
                prefill_384_kernels=kernels,
                prefill_384_programs=1 if mode == "bucketed"
                else len(layouts))


#: Phase 32's flagship legs: (name, prefill, ServingConfig overrides).
BUCKETED_FLAGSHIP_LEGS = (
    ("chunked", "chunked", {}),
    ("bucketed", "bucketed", {}),
    ("bucketed_int8", "bucketed", {"kv_dtype": "int8",
                                   "decode_impl": "pipelined"}))


def bucketed_flagship(device, smi: str) -> tuple:
    """Leg (b): the flagship on the long-prompt scenario by each of
    BUCKETED_FLAGSHIP_LEGS. Returns the legs' lines, the kernels' and
    combine's launches and the failures."""
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine

    cfg, params = flagship_model(device)
    lines, failures, streams = {}, [], {}
    totals = {"cuda": 0, "pipelined": 0, "cuda_combine": 0,
              "pipelined_combine": 0}
    for name, prefill, serving in BUCKETED_FLAGSHIP_LEGS:
        engine = ServingEngine(params, cfg, ServingConfig(
            **LONG_PROMPT_KNOBS, prefill=prefill, **serving), device=device)
        run = long_prompt_leg(engine)
        gate = launch_gate(engine, run.pop("launches"), run.pop("combines"),
                           spec=False, since=run.pop("since"))
        streams[name] = run.pop("streams")
        impl = engine.decode_impl
        totals[impl] += gate["kernel_launches"]
        totals[f"{impl}_combine"] += gate["combine_launches"]
        line = dict(leg=name, prefill=prefill, kernel=impl,
                    kv_dtype=engine.scfg.kv_dtype or "bfloat16", **run,
                    **{k: v for k, v in gate.items() if k not in GATE_KEYS},
                    **prefill_device_ms(engine, prefill))
        if name != "chunked":
            line["streams_equal_chunked"] = sum(
                a == b for a, b in zip(streams[name], streams["chunked"]))
        emit("serve_bucketed_flagship", **line, gpu=smi)
        lines[name] = line
        if not (run["all_finished"] and gate["launches_ok"]
                and gate["decode_splits"] > 1):
            failures.append(f"(b) {name}: {line}")
        del engine
    chunked, bucketed = lines["chunked"], lines["bucketed"]
    emit("serve_bucketed_compare", **{
        f"bucketed_over_chunked_{key}": (bucketed[key] / chunked[key]
                                         if chunked[key] else None)
        for key in ("intertoken_p50_ms", "intertoken_p99_ms",
                    "long_ttft_p50_ms", "makespan_s",
                    "prefill_384_device_busy_ms", "prefill_384_wall_ms")},
        gpu=smi)
    return lines, totals, failures


def phase_serve_bucketed(device, smi: str) -> dict:
    """Phase 32: bucketed prefill, legs (a) and (b). Returns the launches
    of the tiny legs (``parity``) and of the flagship legs
    (``flagship``)."""
    t0 = time.perf_counter()
    parity, failures = bucketed_parity_tiny(device)
    t_parity = time.perf_counter() - t0
    lines, flagship, more = bucketed_flagship(device, smi)
    failures += more
    emit("serve_bucketed", launches=flagship, parity_launches=parity,
         seconds=time.perf_counter() - t0, parity_seconds=t_parity,
         failures=failures, gpu=smi)
    if failures:
        raise AssertionError(f"serve_bucketed: {failures}")
    return {"flagship": flagship, "parity": parity}


# -- phase 33: tensor- and expert-parallel serving on a gang of ranks ---------

#: Phase 33's gangs, (tp, ep): every rank a process of its own on the card.
MESH_GANGS = ((2, 1), (1, 2), (2, 2))
#: Phase 33's tiny legs, fp32 against the CPU's plain route: (name, preset,
#: gang, ServingConfig overrides, sampled).
MESH_TINY_LEGS = (
    ("micro_tp2_cuda", "micro", (2, 1), {}, False),
    ("micro_tp2_pipelined_int8", "micro", (2, 1),
     {"decode_impl": "pipelined", "kv_dtype": "int8"}, False),
    ("micro_tp2_k4", "micro", (2, 1), {"micro_k": 4}, False),
    ("micro_tp2_spec2", "micro", (2, 1), {"spec_k": 2}, False),
    ("micro_tp2_sampled", "micro", (2, 1), {}, True),
    ("moe_ep2", "moe", (1, 2), {}, False),
    ("moe_tp2_ep2", "moe", (2, 2), {}, True))
#: Phase 33's flagship legs: (name, model, gang, ServingConfig overrides).
MESH_FLAGSHIP_LEGS = (
    ("flagship_tp2", FLAGSHIP, (2, 1), {}),
    ("flagship_tp2_int8", FLAGSHIP, (2, 1),
     {"kv_dtype": "int8", "decode_impl": "pipelined"}),
    ("flagship_moe_ep2", FLAGSHIP_MOE, (1, 2), {}))
#: A flagship leg's wave: the serve wave's 16 requests (every slot live),
#: each prompt cut to its first MESH_PROMPT tokens, MESH_NEW new tokens.
MESH_PROMPT, MESH_NEW = 64, 16


def rank_counts() -> dict:
    """This rank's paged launches in the engine's ``attention_launches``
    shape, with the combine's beside them."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    counts = pa.launch_counts()
    return {"cuda": counts["paged_decode_attention"],
            "pipelined": counts["paged_decode_pipelined_attention"],
            "reference": counts["paged_reference_attention"],
            "combine": counts["paged_decode_combine"]
            + counts["paged_decode_pipelined_combine"]}


def rank_kernel_check(pools, heads: int, d_head: int, dtype, impl: str,
                      mesh) -> dict:
    """One call of this rank's kernel (``impl``) on its kv-head block of
    layer 0's pools — four rows over blocks 1.., a seeded query at the
    rank's ``heads`` query heads in ``dtype`` — against the plain version
    on the same values: fp32 within FP32_ATOL, bf16 within its output's
    rounding of the fp32 plain version. Run after the leg's launches are
    read, so its own launches are not among them."""
    from tpu_task_torch.ml.ops import paged_attention as pa

    pool = pools[0]
    n_blocks, bs = pool["k"].shape[:2]
    dev = pool["k"].device
    gen = torch.Generator(device=dev).manual_seed(33 + mesh.rank)
    rows, max_blocks = 4, min(8, n_blocks - 1)
    q = torch.randn((rows, 1, heads, d_head), generator=gen, device=dev,
                    dtype=torch.float32).to(dtype)
    tables = (1 + torch.arange(rows * max_blocks, device=dev,
                               dtype=torch.int32) % (n_blocks - 1)
              ).reshape(rows, max_blocks)
    positions = torch.tensor([[max_blocks * bs - 1 - 3 * r]
                              for r in range(rows)], device=dev,
                             dtype=torch.int32)
    args = (q, pool["k"], pool["v"], tables, positions) + (
        (pool["k_scale"], pool["v_scale"]) if "k_scale" in pool else ())
    got = pa.paged_attention(*args, impl=impl, mesh=mesh)
    if dtype == torch.float32:
        err = float((got - pa.paged_reference_attention(*args)).abs().max())
        return {"rank": mesh.rank, "max_abs_err": err,
                "ok": err <= FP32_ATOL, "tolerance": FP32_ATOL}
    check = against_fp32_plain(got, args)
    return {"rank": mesh.rank, "max_abs_err": check["max_abs_err_vs_fp32"],
            "ok": check["ok"], "tolerance": check["tolerance_vs_fp32"]}


def mesh_rank_gate(engine, per_rank: list, spec: bool) -> dict:
    """Every rank's paged launches against the run's programs
    (``launch_gate`` on each rank's counts: the route's kernel once a
    layer a decode-shape call and chunk step, the combine wherever the
    plan splits, nothing else): ranks equal, each gated."""
    gates = [launch_gate(engine, {k: c[k] for k in ("cuda", "pipelined",
                                                   "reference")},
                         c["combine"], spec) for c in per_rank]
    return dict(rank_launches=[g["kernel_launches"] for g in gates],
                rank_combine_launches=[g["combine_launches"] for g in gates],
                ranks_ok=all(g["launches_ok"] for g in gates)
                and len({g["kernel_launches"] for g in gates}) == 1,
                decode_splits=gates[0]["decode_splits"],
                decode_calls=gates[0]["decode_calls"],
                chunk_steps=gates[0]["chunk_steps"])


def mesh_tiny_legs(mesh, legs, device) -> tuple:
    """Leg (a) on one gang: each tiny leg's streams through the gang on
    the card against one device's on the CPU's plain route, every rank's
    launches gated, and each rank's kernel on its shard against the plain
    version. Returns the launch totals by route and the failures."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.serving.cache import ServingConfig
    from tpu_task_torch.ml.serving.engine import ServingEngine
    from tpu_task_torch.serve.replica import SERVING_PRESETS, build_engine

    gang = mesh.gang
    totals = {key: [0] * mesh.size
              for key in ("cuda", "pipelined", "reference", "combine")}
    failures, models = [], {}
    for name, preset, _, over, sampled in legs:
        if preset not in models:
            base = build_engine(preset, device="cpu")
            models[preset] = (base.cfg, base.params)
            del base
        cfg, params = models[preset]
        spec = over.get("spec_k", 0) > 0
        traffic = moe_traffic(cfg.vocab_size, sampled)
        knobs = {**SERVING_PRESETS[preset], **over}
        extra = dict(draft_params=params, draft_cfg=cfg) if spec else {}
        cpu = ServingEngine(params, cfg, ServingConfig(
            **{**knobs, "decode_impl": "reference"}),
            device=torch.device("cpu"), **extra)
        want = run_arrivals(cpu, traffic)
        del cpu
        engine = ServingEngine(params, cfg, ServingConfig(**knobs),
                               mesh=mesh, **extra)
        gang.query(pa.reset_launch_counts)
        got = run_arrivals(engine, traffic)
        torch.cuda.synchronize()
        per_rank = gang.query(rank_counts)
        gate = mesh_rank_gate(engine, per_rank, spec)
        impl = engine.decode_impl
        checks = gang.query(rank_kernel_check, engine.pools,
                            cfg.n_heads // engine.tp, cfg.d_head, cfg.dtype,
                            impl, mesh)
        line = dict(leg=name, preset=preset, tp=engine.tp, ep=engine.ep,
                    kernel=impl, kv_dtype=engine.scfg.kv_dtype or "float32",
                    streams_equal_cpu_plain=got == want,
                    requests=len(traffic), tokens=sum(map(len, got)),
                    kernel_check=checks, **gate,
                    graph_captures=engine.stats()["step_graph"]["captures"])
        emit("serve_mesh_parity", **line)
        for r, c in enumerate(per_rank):
            totals[impl][r] += c[impl]
            totals["combine"][r] += c["combine"]
        if not (line["streams_equal_cpu_plain"] and gate["ranks_ok"]
                and all(c["ok"] for c in checks)
                and line["graph_captures"] == 0):
            failures.append(f"(a) {line}")
        del engine
    return totals, failures


def mesh_flagship_model(spec, device):
    """A flagship-shaped bf16 model drawn on the card (the full tree once,
    in rank 0; each follower receives only its block)."""
    from tpu_task_torch.ml.models import transformer

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16, **spec)
    params = transformer.init(
        torch.Generator(device=device).manual_seed(0), cfg)
    return cfg, params


def _mesh_wave(engine):
    """A flagship leg's wave (MESH_PROMPT, MESH_NEW) into ``engine``."""
    wave = _wave_requests(engine.cfg.vocab_size, 0)
    rids = [engine.submit(prompt[:MESH_PROMPT], MESH_NEW, **kw)
            for prompt, kw in wave]
    return rids, len(wave) * MESH_PROMPT


def mesh_wave_run(engine) -> dict:
    """One timed MESH wave through ``engine`` (``_timed_drain``), with its
    streams."""
    run = _timed_drain(engine, 0, max_new=MESH_NEW,
                       load=lambda: _mesh_wave(engine))
    run["streams"] = [engine.request(r).tokens for r in run["rids"]]
    return run


def mesh_flagship_leg(mesh, leg, device, smi: str) -> tuple:
    """Leg (b) for one flagship leg: the MESH wave through one rank's
    engine on the card, then through the gang's engine on the same
    params, with every rank's launches gated; tokens/s and step ms
    against the one rank's at that load, the collectives a step by kind
    with their host ms, each rank's param and pool bytes against one
    device's, and each rank's kernel against the plain version. Returns
    the line and its failures."""
    from tpu_task_torch.ml.ops import paged_attention as pa
    from tpu_task_torch.ml.parallel import gang as gangs
    from tpu_task_torch.ml.parallel.sharding import tree_nbytes
    from tpu_task_torch.ml.serving.cache import (
        ServingConfig,
        paged_cache_bytes,
    )
    from tpu_task_torch.ml.serving.engine import ServingEngine

    name, spec, _, over = leg
    cfg, params = mesh_flagship_model(spec, device)
    one_device_param_bytes = tree_nbytes(params)
    scfg = ServingConfig(**SERVE_KNOBS, **over)
    engine = ServingEngine(params, cfg, scfg, device=device)
    warm_up(engine)
    one = mesh_wave_run(engine)
    del engine
    torch.cuda.empty_cache()
    t_build = time.perf_counter()
    engine = ServingEngine(params, cfg, scfg, mesh=mesh)
    build_s = time.perf_counter() - t_build
    del params
    torch.cuda.empty_cache()
    warm_up(engine)
    gang = mesh.gang
    gang.query(pa.reset_launch_counts)
    before = {k: list(v) for k, v in mesh.collectives.items()}
    run = mesh_wave_run(engine)
    per_rank = gang.query(rank_counts)
    steps = run["decode_steps"] + run["chunk_steps"]
    collectives = {
        kind: {"per_step": (n - before.get(kind, [0, 0.0])[0]) / steps,
               "host_ms_per_step": (s - before.get(kind, [0, 0.0])[1])
               * 1e3 / steps}
        for kind, (n, s, _) in mesh.collectives.items()}
    impl = engine.decode_impl
    gates = [dict(kernel=c[impl], combine=c["combine"],
                  other=sum(c[k] for k in ("cuda", "pipelined", "reference")
                            if k != impl)) for c in per_rank]
    ranks_ok = all(g["kernel"] == run["expected_launches"] > 0
                   and g["combine"] == run["expected_combine_launches"]
                   and g["other"] == 0 for g in gates)
    checks = gang.query(rank_kernel_check, engine.pools,
                        cfg.n_heads // engine.tp, cfg.d_head, cfg.dtype,
                        impl, mesh)
    param_bytes = gang.query(tree_nbytes, engine.params)
    pool_bytes = gang.query(tree_nbytes, engine.pools)

    def over_one(key):
        return run[key] / one[key] if run[key] and one[key] else None

    line = dict(
        leg=name, tp=engine.tp, ep=engine.ep, kernel=impl,
        kv_dtype=scfg.kv_dtype or "bfloat16", requests=run["requests"],
        prompt_tokens=run["prompt_tokens"],
        generated_tokens=run["generated_tokens"],
        tokens_per_s=run["tokens_per_s"],
        one_rank_tokens_per_s=one["tokens_per_s"],
        over_one_rank_tokens_per_s=over_one("tokens_per_s"),
        mean_decode_step_ms=run["mean_decode_step_ms"],
        one_rank_mean_decode_step_ms=one["mean_decode_step_ms"],
        over_one_rank_decode_step_ms=over_one("mean_decode_step_ms"),
        mean_chunk_step_ms=run["mean_chunk_step_ms"],
        one_rank_mean_chunk_step_ms=one["mean_chunk_step_ms"],
        over_one_rank_chunk_step_ms=over_one("mean_chunk_step_ms"),
        decode_steps=run["decode_steps"], chunk_steps=run["chunk_steps"],
        one_rank_steps=[one["decode_steps"], one["chunk_steps"]],
        # rows live in a decode step: its tokens over the decode steps
        decode_live_rows=run["decode_phase_tokens"] / run["decode_steps"]
        if run["decode_steps"] else None,
        one_rank_decode_live_rows=one["decode_phase_tokens"]
        / one["decode_steps"] if one["decode_steps"] else None,
        greedy_streams_equal_one_rank=sum(
            a == b for i, (a, b) in enumerate(zip(run["streams"],
                                                  one["streams"]))
            if i % 4 != 3),
        collectives=collectives, gang_messages=dict(gang.sent),
        rank_launches=[g["kernel"] for g in gates],
        rank_combine_launches=[g["combine"] for g in gates],
        expected_launches=run["expected_launches"],
        expected_combine_launches=run["expected_combine_launches"],
        step_splits=run["step_splits"], kernel_check=checks,
        rank_param_bytes=param_bytes,
        one_device_param_bytes=one_device_param_bytes,
        rank_pool_bytes=pool_bytes,
        one_device_pool_bytes=paged_cache_bytes(cfg, scfg, scfg.n_blocks),
        engine_build_s=build_s, all_finished=run["all_finished"],
        one_rank_wave_ok=wave_ok(one),
        graph_captures=run["graph_captures"],
        collective_stats_rank0=gangs.collective_stats(mesh), gpu=smi)
    emit("serve_mesh_flagship", **line)
    failures = []
    if not (run["all_finished"] and ranks_ok and wave_ok(one)
            and run["step_splits"]["decode"] > 1
            and all(c["ok"] for c in checks) and run["graph_captures"] == 0
            and sum(pool_bytes) == line["one_device_pool_bytes"]
            * engine.ep):
        failures.append(f"(b) {line}")
    del engine
    torch.cuda.empty_cache()
    return line, failures


def phase_serve_mesh(device, smi: str) -> dict:
    """Phase 33: tensor- and expert-parallel serving on gangs of ranks on
    the one card, legs (a) (tiny fp32 gangs against the CPU's plain route)
    and (b) (the flagship at tp 2 through each kernel, the MoE flagship at
    ep 2, each against one rank at the same load). Each gang starts at its
    turn (``gang.start``) and is closed after its legs; no follower may
    outlive it. Returns each route's per-rank launches over the tiny legs
    (``parity``) and the flagship legs (``flagship``)."""
    from tpu_task_torch.ml.parallel import gang as gangs

    t0 = time.perf_counter()
    parity, flagship, failures, lines = {}, {}, [], {}
    for shape in MESH_GANGS:
        t_start = time.perf_counter()
        mesh = gangs.start(*shape, device=device)
        start_s = time.perf_counter() - t_start
        procs = mesh.gang.procs
        try:
            legs = [leg for leg in MESH_TINY_LEGS if leg[2] == shape]
            totals, more = mesh_tiny_legs(mesh, legs, device)
            parity[f"tp{shape[0]}_ep{shape[1]}"] = totals
            failures += more
            for leg in MESH_FLAGSHIP_LEGS:
                if leg[2] != shape:
                    continue
                line, more = mesh_flagship_leg(mesh, leg, device, smi)
                lines[leg[0]] = line
                flagship[leg[0]] = {
                    "kernel": line["kernel"],
                    "rank_launches": line["rank_launches"],
                    "rank_combine_launches":
                        line["rank_combine_launches"]}
                failures += more
        finally:
            mesh.gang.close()
        left = [p.pid for p in procs if p.poll() is None]
        emit("serve_mesh_gang", tp=shape[0], ep=shape[1], start_s=start_s,
             followers=[p.pid for p in procs], followers_left=left)
        if left:
            failures.append(f"followers outlived the gang: {left}")
    emit("serve_mesh", parity_launches=parity, flagship_launches=flagship,
         tokens_per_s={k: v["tokens_per_s"] for k, v in lines.items()},
         over_one_rank_tokens_per_s={
             k: v["over_one_rank_tokens_per_s"] for k, v in lines.items()},
         seconds=time.perf_counter() - t0, failures=failures, gpu=smi)
    if failures:
        raise AssertionError(f"serve_mesh: {failures}")
    return {"parity": parity, "flagship": flagship}


# -- sharded training across SPMD ranks (phase 34) -------------------------------

#: Phase 34's ranks: one process a mesh position, all on cuda:0.
TRAIN_MESH_RANKS = 4
#: (name, mesh axes, sizes, MoE) of the tiny fp32 parity legs. The
#: config's sequence is a multiple of 128 so the flash kernels take it.
TRAIN_MESH_PARITY = (("fsdp2_tp2", ("fsdp", "tp"), (2, 2), False),
                     ("moe_dp2_ep2", ("dp", "ep"), (2, 2), True))
TRAIN_MESH_TINY = dict(vocab_size=1024, d_model=256, n_layers=2, n_heads=8,
                       d_head=32, d_ff=512, n_kv_heads=4)
#: The MoE parity config: capacity for every token (capacity_factor =
#: n_experts), so the one-process dense dispatch is its reference.
TRAIN_MESH_TINY_MOE = dict(TRAIN_MESH_TINY, moe_every=2, n_experts=4,
                           moe_top_k=2, moe_capacity_factor=4.0)
#: How far the sharded card step's params may be from the CPU step's, as
#: a multiple of the one-process card step's own gap to the CPU step (the
#: sums' order on the card): above it the sharding adds a gap of its own.
TRAIN_MESH_CPU_GAP_RATIO = 2.0
TRAIN_MESH_DENSE = (("dp", "fsdp", "tp"), (1, 2, 2))
TRAIN_MESH_MOE = (("dp", "ep"), (2, 2))
#: The dense flagship's trainer saves at the second step and keeps
#: stepping (to the third number at most) until killed; the restart runs
#: from that save to the first.
TRAIN_MESH_RESUME_STEPS, TRAIN_MESH_SAVE_AT, TRAIN_MESH_LOOP_STEPS = 4, 2, 8

#: Phase 35, sequence-parallel training, run as legs of phase 34's rank
#: launch. (name, mesh axes, sizes, context_parallel) of the tiny fp32
#: parity legs on TRAIN_MESH_TINY (GQA, 4 kv heads), tokens (2, 1025),
#: under phase 34's parity gate.
TRAIN_SP_PARITY = (("zigzag_sp4", ("sp",), (4,), "zigzag"),
                   ("ulysses_sp4", ("sp",), (4,), "ulysses"),
                   ("zigzag_dp2_sp2", ("dp", "sp"), (2, 2), "zigzag"))
#: The flagship legs: the JAX package's long-context row
#: (``bench.py:3381``, ``bench_train_mfu(batch=1, seq=8192)``), tokens (1,
#: 8193), over sp 4: zigzag (2048 tokens a rank in stripes of 1024) and
#: Ulysses (2 heads a rank at 8192).
TRAIN_SP_FLAGSHIP = (("zigzag", ("sp",), (4,)), ("ulysses", ("sp",), (4,)))
TRAIN_SP_BATCH, TRAIN_SP_SEQ = 1, 8192
#: The first sp step's loss and grad norm against the one-process step on
#: the same params and tokens: phase 9's bf16 gate (an all-bf16 attention
#: and an fp32 one differ by 3.3e-5 relative at its config).
TRAIN_SP_RTOL = 2.0 ** -10


#: Phase 36, pipeline-parallel training, run as legs of phase 34's rank
#: launch. (name, mesh axes, sizes, microbatches) of the tiny fp32 parity
#: legs on TRAIN_PP_TINY (TRAIN_MESH_TINY with 4 layers, so that 4 stages
#: divide it), tokens (8, 257), under phase 34's parity gate.
TRAIN_PP_PARITY = (("pp4_m4", ("pp",), (4,), 4),
                   ("dp2_pp2_m2", ("dp", "pp"), (2, 2), 2))
TRAIN_PP_TINY = dict(TRAIN_MESH_TINY, n_layers=4)
#: The flagship leg: TRAIN_FLAGSHIP's 8 layers on 4 stages (2 a stage) at
#: 4 microbatches of 2 rows, the train phase's tokens (8, 1025).
TRAIN_PP_FLAGSHIP = ("pp", ("pp",), (4,), 4)


def pp_launches(leg: dict) -> dict:
    """Flash launches of each kernel a step on every rank of a pp leg:
    each of the stage's layers runs the forward of M microbatches twice
    (the forward tick and the backward's recompute) and the backward
    once."""
    sizes = dict(zip(leg["axes"], leg["sizes"]))
    per_stage = leg["model"]["n_layers"] // sizes["pp"] * leg["pp"]
    return {"flash_fwd": 2 * per_stage, "flash_bwd_dq": per_stage,
            "flash_bwd_dkv": per_stage}


def sp_blocks(mode: str, sp: int) -> int:
    """Flash launches of each kernel a layer a step on every rank: the
    zigzag diagonal's two blocks and one a remote chunk; Ulysses one
    full-length call."""
    return sp + 1 if mode == "zigzag" else 1

#: The rank script of phase 34 (and of ``tests/test_torch_train_mesh_resume
#: .py`` on the CPU at a tiny size): every rank of an SPMD trainer runs it
#: with the orchestrator's variables (``worker_env``), joins the gloo group
#: through ``distributed_init_from_env`` and builds its mesh with
#: ``make_mesh``; it imports only tpu_task_torch and this script's own
#: checkout's ``chip_smoke`` helpers. Its one argument is a JSON config
#: naming the legs; it prints one JSON line an event, each with the rank
#: and its wall time.
TRAIN_MESH_SCRIPT = r'''
import json, os, sys, time

config = json.loads(sys.argv[1])
sys.path.insert(0, config["repo"])
import numpy as np
import torch
import torch.distributed as dist

from tpu_task_torch.ml import (AsyncCheckpointer, restore_checkpoint_sharded,
                               train)
from tpu_task_torch.ml.data import epoch_batches, prefetch_to_device
from tpu_task_torch.ml.models import transformer
from tpu_task_torch.ml.ops import attention
from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel.mesh import (batch_shard,
                                             distributed_init_from_env,
                                             local_batch, make_mesh)
from tpu_task_torch.ml.parallel.sharding import (shard_slices, spec_leaves,
                                                 tree_nbytes)
from tpu_task_torch.ml.tree import leaves, tree_map
import chip_smoke

T_START = time.time()


def log(event, **fields):
    print(json.dumps({"event": event, "rank": RANK, "t": time.time(),
                      **fields}), flush=True)


RANK = int(os.environ.get("TPU_TASK_WORKER_ID", "0"))
log("imported")
if not distributed_init_from_env():
    raise SystemExit("train_mesh: not started as a rank of a trainer")
RANK = dist.get_rank()
device = torch.device(config["device"])
torch.set_num_threads(2)
if device.type == "cuda":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.empty(1, device=device)
    torch.cuda.synchronize()
log("device_ready")


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize()


def model_config(leg):
    return transformer.TransformerConfig(dtype=getattr(torch, leg["dtype"]),
                                         **leg["model"])


def step_builder(cfg, mesh, leg):
    if leg.get("pp"):
        return train.make_pp_train_step(cfg, mesh, leg["pp"])
    if leg.get("sp"):
        return train.make_sp_train_step(cfg, mesh,
                                        context_parallel=leg["sp"])
    if leg.get("moe"):
        return train.make_moe_train_step(cfg, mesh)
    return train.make_train_step(cfg, mesh=mesh)


REFERENCES = {}


def references(cfg, leg, tokens):
    """The one-process steps on the card and on the CPU of a parity leg,
    once for every leg of the same config, tokens and steps."""
    key = json.dumps([leg["model"], leg["dtype"], leg["batch"], leg["seq"],
                      leg["steps"]])
    if key not in REFERENCES:
        REFERENCES[key] = (
            one_process(cfg, tokens, leg["steps"], device),
            one_process(cfg, tokens, leg["steps"], torch.device("cpu")))
    return REFERENCES[key]


def one_process(cfg, tokens, steps, where):
    """The one-process step through the plain route: the plain attention
    on ``where`` (the CPU's wrappers take it; on the card, the plain
    versions under ``FlashAttention``'s wiring). Its final state and
    metrics."""
    state = train.init_state(torch.Generator().manual_seed(6), cfg,
                             device=where)
    attn = None
    if where.type == "cuda":
        def attn(q, k, v):
            return chip_smoke.PlainFlash.apply(
                q, transformer.expand_kv(k, cfg.n_heads),
                transformer.expand_kv(v, cfg.n_heads))
    step, metrics = train.make_train_step(cfg, attn_fn=attn), []
    tokens = tokens.to(where)
    for _ in range(steps):
        state, m = step(state, tokens)
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    return state, metrics


def pp_layout(state, mesh):
    """A one-process state in the pipeline layout of ``mesh``'s stages."""
    n = dict(mesh.shape)["pp"]
    opt = state.opt_state
    return train.TrainState(
        state.step, train.pp_stack_params(state.params, n),
        {"count": opt["count"], "mu": train.pp_stack_params(opt["mu"], n),
         "nu": train.pp_stack_params(opt["nu"], n)})


def shard(state, cfg, mesh, leg):
    """This rank's blocks of ``state`` and their specs: the pipeline
    layout's for a pp leg."""
    if leg.get("pp"):
        return train.shard_pp_state(pp_layout(state, mesh), mesh)
    return train.shard_state(state, cfg, mesh)


class TickTimer:
    """Stands in for ``collectives.pipeline_hop`` for one step: a sync
    before and after each hand-off splits the step into each tick's stage
    compute (since the last hand-off) and its hand-off wait, the bubble
    included."""

    def __enter__(self):
        self.saved, self.ticks = collectives.pipeline_hop, []
        self.last = time.perf_counter()

        def hop(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = self.saved(*args, **kwargs)
            sync()
            t1 = time.perf_counter()
            self.ticks.append([(t0 - self.last) * 1e3, (t1 - t0) * 1e3])
            self.last = t1
            return out

        collectives.pipeline_hop = hop
        return self

    def __exit__(self, *exc):
        collectives.pipeline_hop = self.saved


def max_block_diff(blocks, ref, specs, mesh) -> float:
    err = 0.0
    for got, want, spec in zip(leaves(blocks), leaves(ref),
                               spec_leaves(specs)):
        if torch.is_tensor(got):
            want = want[shard_slices(want.shape, spec, mesh)].to(got.device)
            err = max(err, (got - want).abs().max().item())
    return err


def max_state_diff(a, b) -> float:
    return max((x.cpu() - y.cpu()).abs().max().item()
               for x, y in zip(leaves(a), leaves(b)) if torch.is_tensor(x))


def parity(leg):
    """Three sharded steps of a tiny fp32 config on the card against the
    one-process step through the plain route: on the card (params and
    metrics) and on the CPU (metrics; the params' gap may exceed
    ``param_atol`` only as far as the one-process card step's own gap to
    the CPU step, the witness, allows: ``cpu_gap_ratio`` times it)."""
    mesh = make_mesh(axis_names=leg["axes"], axis_sizes=leg["sizes"],
                     device=device)
    cfg = model_config(leg)
    tokens = torch.randint(0, cfg.vocab_size, (leg["batch"], leg["seq"] + 1),
                           generator=torch.Generator().manual_seed(5))
    full = train.init_state(torch.Generator().manual_seed(6), cfg,
                            device="cpu")
    blocks, specs = shard(full, cfg, mesh, leg)
    t0 = time.perf_counter()
    (ref, ref_metrics), (cpu, cpu_metrics) = references(cfg, leg, tokens)
    reference_s = time.perf_counter() - t0
    if leg.get("pp"):
        ref, cpu = pp_layout(ref, mesh), pp_layout(cpu, mesh)
    step = step_builder(cfg, mesh, leg)(blocks)
    rows = local_batch(tokens, mesh).to(device)
    attention.reset_launch_counts()
    metrics, step_s = [], []
    for _ in range(leg["steps"]):
        t0 = time.perf_counter()
        blocks, m = step(blocks, rows)
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
        step_s.append(time.perf_counter() - t0)
    sync()
    counts = chip_smoke.flash_counts()
    err = max_block_diff(blocks, ref, specs, mesh)
    cpu_err = max_block_diff(blocks, cpu, specs, mesh)
    witness = max_state_diff(ref, cpu)
    metric_err = max(abs(a - b) for ref_m in (ref_metrics, cpu_metrics)
                     for x, y in zip(metrics, ref_m) for a, b in zip(x, y))
    # The sp legs' gradients also sum over the sequence's chunks, and the
    # pp legs' over the microbatches, so the card step is held, as the CPU
    # one, to the witness's gap.
    card_bound = (max(leg["param_atol"], leg["cpu_gap_ratio"] * witness)
                  if leg.get("sp") or leg.get("pp") else leg["param_atol"])
    log("parity", name=leg["name"], metrics=metrics, reference_s=reference_s,
        step_s=step_s,
        reference_metrics=ref_metrics, cpu_metrics=cpu_metrics,
        max_param_abs_diff=err, max_param_abs_diff_cpu=cpu_err,
        one_process_card_vs_cpu=witness,
        max_metric_abs_diff=metric_err, launches=counts,
        ok=(err <= card_bound and metric_err <= leg["metric_atol"]
            and cpu_err <= max(leg["param_atol"],
                               leg["cpu_gap_ratio"] * witness)))


def flagship(leg):
    """The flagship sharded: warm-up steps (the first recorded and held
    against the plain versions), then timed steps on one batch."""
    mesh = make_mesh(axis_names=leg["axes"], axis_sizes=leg["sizes"],
                     device=device)
    cfg = model_config(leg)
    full = train.init_state(torch.Generator(device=device).manual_seed(0),
                            cfg, device=device)
    one_device = tree_nbytes(full)
    blocks, specs = shard(full, cfg, mesh, leg)
    tokens = torch.randint(
        0, cfg.vocab_size, (leg["batch"], leg["seq"] + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    rows = local_batch(tokens, mesh)
    reference = None
    if leg.get("reference") and RANK == 0:
        # The one-process step on the same params and tokens, through the
        # kernels, on a copy.
        alone = tree_map(lambda x: x.clone() if torch.is_tensor(x) else x,
                         full)
        _, m = train.make_train_step(cfg)(alone, tokens)
        reference = [m["loss"].item(), m["grad_norm"].item()]
        del alone, m
    del full
    if device.type == "cuda":
        torch.cuda.empty_cache()
    step = step_builder(cfg, mesh, leg)(blocks)
    losses, norms = [], []
    with chip_smoke.FlashRecorder(attention) as recorder:
        blocks, m = step(blocks, rows)
    losses.append(m["loss"].item())
    norms.append(m["grad_norm"].item())
    recorded = chip_smoke.check_recorded(recorder.calls)
    recorder.calls.clear()
    ticks = None
    for i in range(leg["warmup"] - 1):
        if leg.get("pp") and i == 0:
            with TickTimer() as timer:
                blocks, m = step(blocks, rows)
            ticks = timer.ticks
        else:
            blocks, m = step(blocks, rows)
        losses.append(m["loss"].item())
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    mesh.collectives.clear()
    step_ms, per_step = [], []
    for _ in range(leg["timed"]):
        before = chip_smoke.flash_counts()
        t0 = time.perf_counter()
        blocks, m = step(blocks, rows)
        losses.append(m["loss"].item())
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = chip_smoke.flash_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    log("flagship", name=leg["name"], step_ms=step_ms, losses=losses,
        first_grad_norm=norms[0], reference=reference,
        collectives=collectives.collective_stats(mesh),
        rank_bytes=tree_nbytes(blocks), one_device_bytes=one_device,
        rows=list(rows.shape), launches_per_step=per_step,
        launches=chip_smoke.flash_counts(), recorded=recorded, ticks=ticks,
        stage=mesh.axis_index("pp"),
        peak_memory_gb=(torch.cuda.max_memory_allocated() / 1e9
                        if device.type == "cuda" else None))


def resume(leg):
    """A trainer's loop: restore the newest complete sharded checkpoint
    when there is one, feed seeded batches (``data="epochs"``: this rank's
    piece through ``epoch_batches``; ``"repeat"``: the flagship leg's one
    batch), save asynchronously with the layout (each save's blocking ms
    logged), and write its final blocks (``write_final``)."""
    mesh = make_mesh(axis_names=leg["axes"], axis_sizes=leg["sizes"],
                     device=device)
    cfg = model_config(leg)
    full = train.init_state(torch.Generator(device=device).manual_seed(0),
                            cfg, device=device)
    blocks, specs = train.shard_state(full, cfg, mesh)
    del full
    if os.path.exists(os.path.join("checkpoints", "LATEST_SHARDED")):
        t0 = time.perf_counter()
        blocks = restore_checkpoint_sharded("checkpoints", blocks,
                                            specs=specs, mesh=mesh)
        sync()
        log("restored", step=blocks.step, read_s=time.perf_counter() - t0,
            bytes=tree_nbytes(blocks))
    if leg["data"] == "repeat":
        tokens = torch.randint(
            0, cfg.vocab_size, (leg["batch"], leg["seq"] + 1), device=device,
            generator=torch.Generator(device=device).manual_seed(1))
        rows = local_batch(tokens, mesh)
        batches = iter(lambda: rows, None)
    else:
        tokens = np.random.default_rng(leg["seed"]).integers(
            0, cfg.vocab_size,
            size=(leg["batch"] * leg["steps"], leg["seq"] + 1))
        piece, pieces = batch_shard(mesh)
        batches = prefetch_to_device(
            epoch_batches(tokens, None, leg["batch"], seed=leg["seed"],
                          process_index=piece, process_count=pieces,
                          start_step=blocks.step), device)
    step = step_builder(cfg, mesh, leg)(blocks)
    attention.reset_launch_counts()
    with AsyncCheckpointer("checkpoints", keep=2) as saver:
        while blocks.step < leg["steps"]:
            blocks, m = step(blocks, next(batches))
            log("step", step=blocks.step, loss=m["loss"].item())
            if (blocks.step % leg["save_every"] == 0
                    and blocks.step < leg["steps"]):
                t0 = time.perf_counter()
                saver.save(blocks.step, blocks, specs=specs, mesh=mesh)
                log("saved", step=blocks.step,
                    blocked_ms=(time.perf_counter() - t0) * 1e3,
                    pinned_bytes=saver.pinned_bytes)
    if leg["write_final"]:
        np.savez(f"final-{leg['tag']}-{RANK}.npz", **{
            f"leaf_{i}": (x.detach().float().cpu().numpy()
                          if torch.is_tensor(x) else np.asarray(x))
            for i, x in enumerate(leaves(blocks))})
    log("done", step=blocks.step, launches=chip_smoke.flash_counts())


for name in config["legs"]:
    for leg in config[name]:
        globals()[name](leg)
log("finished", seconds=time.time() - T_START)
if config.get("park"):
    log("parked")
    while True:
        time.sleep(1)
'''


def launch_mesh_ranks(workdir: Path, config: dict, n: int, tag: str, *,
                      until=None,
                      timeout_s: float = 600) -> dict:
    """``TRAIN_MESH_SCRIPT`` as ``n`` rank processes in ``workdir``, each
    started with ``worker_env(i, n, localhost:<free port>)``: (each rank's
    events, the spawn's wall time). ``until="parked"`` SIGKILLs every rank
    once all of them logged it; ``until="published"`` once the step
    ``LATEST_SHARDED`` names has every rank's shard file (``t_until``:
    when the launcher saw it). A rank that exits non-zero fails the launch
    with its log; no rank outlives it."""
    import signal
    import socket

    from tpu_task_torch.ml.parallel.mesh import worker_env

    script = workdir / "train_mesh.py"
    script.write_text(TRAIN_MESH_SCRIPT)
    with socket.socket() as probe:
        probe.bind(("localhost", 0))
        port = probe.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    logs = [workdir / f"{tag}-{i}.log" for i in range(n)]
    procs = []
    t_spawn, t_until = time.time(), None

    def events(i):
        return trainer_events(logs[i]) if logs[i].exists() else []

    def published() -> bool:
        pointer = workdir / "checkpoints" / "LATEST_SHARDED"
        if not pointer.exists():
            return False
        meta = json.loads(pointer.read_text())
        return all((workdir / "checkpoints" /
                    f"ckpt-{meta['step']}.shard-{r}.npz").exists()
                   for r in range(int(meta["process_count"])))

    try:
        for i in range(n):
            with open(logs[i], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), json.dumps(config)],
                    cwd=workdir, stdout=out, stderr=subprocess.STDOUT,
                    env={**env, **worker_env(i, n, f"localhost:{port}")}))
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            failed = [i for i, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed:
                raise AssertionError(
                    f"train_mesh rank {failed[0]} exited "
                    f"{procs[failed[0]].returncode}: "
                    f"{logs[failed[0]].read_text()[-4000:]}")
            if until is None and all(p.poll() == 0 for p in procs):
                break
            if (until == "parked" and all(
                    any(e["event"] == "parked" for e in events(i))
                    for i in range(n))) or (until == "published"
                                            and published()):
                t_until = time.time()
                for p in procs:
                    p.send_signal(signal.SIGKILL)
                break
            time.sleep(0.02)
        else:
            raise AssertionError(f"train_mesh {tag}: ranks did not finish "
                                 f"in {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return {"events": [events(i) for i in range(n)], "t_spawn": t_spawn,
            "t_until": t_until}


def mesh_trainer_config(device: str, legs, *, resume_model: dict,
                        resume_dtype: str, axes, sizes, batch: int, seq: int,
                        steps: int, save_every: int, tag: str,
                        data: str = "epochs", park: bool = False,
                        write_final: bool = True, **extra) -> dict:
    """``TRAIN_MESH_SCRIPT``'s argument: the legs to run, the ``resume``
    leg's trainer, and whether the ranks park at the end to be killed."""
    return dict(repo=str(HERE), device=device, legs=list(legs), park=park,
                resume=[dict(axes=list(axes), sizes=list(sizes),
                             model=resume_model, dtype=resume_dtype,
                             batch=batch, seq=seq, steps=steps,
                             save_every=save_every, seed=11, tag=tag,
                             data=data, write_final=write_final)], **extra)


def rank_timeline(run: dict) -> list:
    """Rank 0's events of a launch: (event, leg, seconds since spawn)."""
    return [[e["event"], e.get("name"), round(e["t"] - run["t_spawn"], 3)]
            for e in run["events"][0] if e["event"] != "step"]


def phase_train_mesh(device, smi: str) -> tuple:
    """Phase 34: sharded training as one launch of TRAIN_MESH_RANKS SPMD
    ranks on the card, then a second for the restart. (a) The tiny fp32
    parity legs against the one-process step through the plain route; (b)
    the dense flagship on (dp 1, fsdp 2, tp 2), timed; (c) the MoE flagship
    on (dp 2, ep 2); (d) the dense flagship's trainer loop on (b)'s batch,
    saving asynchronously with its layout at step TRAIN_MESH_SAVE_AT and
    stepping on: every rank SIGKILLed inside the loop once that save is
    published, relaunched, each restores it and runs to
    TRAIN_MESH_RESUME_STEPS, its losses against (b)'s. Phase 35 runs in
    the same launch: the TRAIN_SP_PARITY legs beside (a) and the
    TRAIN_SP_FLAGSHIP legs beside (b), each also held, on its first step,
    to the one-process step on the same params and tokens; so does phase
    36, the TRAIN_PP_PARITY legs and the TRAIN_PP_FLAGSHIP leg. Returns
    each rank's flash launches over (b)'s timed steps, over each sp
    flagship leg's and over the pp flagship leg's."""
    import shutil

    t0 = time.perf_counter()
    workdir = Path(tempfile.mkdtemp(prefix="tpu-task-train-mesh-"))
    n = TRAIN_MESH_RANKS
    dense_axes, dense_sizes = TRAIN_MESH_DENSE
    common = dict(resume_model=TRAIN_FLAGSHIP, resume_dtype="bfloat16",
                  axes=dense_axes, sizes=dense_sizes, batch=TRAIN_BATCH,
                  seq=TRAIN_SEQ, data="repeat", write_final=False)
    parity_legs = [dict(name=name, axes=list(axes), sizes=list(sizes),
                        moe=moe, dtype="float32",
                        model=TRAIN_MESH_TINY_MOE if moe else TRAIN_MESH_TINY,
                        batch=8, seq=256, steps=3, param_atol=FP32_ATOL,
                        metric_atol=1e-5,
                        cpu_gap_ratio=TRAIN_MESH_CPU_GAP_RATIO, blocks=1)
                   for name, axes, sizes, moe in TRAIN_MESH_PARITY]
    parity_legs += [dict(name=name, axes=list(axes), sizes=list(sizes),
                         sp=mode, dtype="float32", model=TRAIN_MESH_TINY,
                         batch=2, seq=1024, steps=2, param_atol=FP32_ATOL,
                         metric_atol=1e-5,
                         cpu_gap_ratio=TRAIN_MESH_CPU_GAP_RATIO,
                         blocks=sp_blocks(mode, dict(zip(axes, sizes))["sp"]))
                    for name, axes, sizes, mode in TRAIN_SP_PARITY]
    parity_legs += [dict(name=name, axes=list(axes), sizes=list(sizes),
                         pp=micro, dtype="float32", model=TRAIN_PP_TINY,
                         batch=8, seq=256, steps=2, param_atol=FP32_ATOL,
                         metric_atol=1e-5,
                         cpu_gap_ratio=TRAIN_MESH_CPU_GAP_RATIO)
                    for name, axes, sizes, micro in TRAIN_PP_PARITY]
    pp_name, pp_axes, pp_sizes, pp_micro = TRAIN_PP_FLAGSHIP
    pp_flagship = dict(name=pp_name, axes=list(pp_axes),
                       sizes=list(pp_sizes), pp=pp_micro,
                       model=TRAIN_FLAGSHIP, dtype="bfloat16",
                       batch=TRAIN_BATCH, seq=TRAIN_SEQ, warmup=2, timed=2,
                       reference=True)
    for leg in parity_legs + [pp_flagship]:
        if leg.get("pp"):
            leg["launches"] = pp_launches(leg)
    sp_flagship = [dict(name=f"sp_{mode}", axes=list(axes),
                        sizes=list(sizes), sp=mode, model=TRAIN_FLAGSHIP,
                        dtype="bfloat16", batch=TRAIN_SP_BATCH,
                        seq=TRAIN_SP_SEQ, warmup=1, timed=2, reference=True,
                        blocks=sp_blocks(mode, dict(zip(axes, sizes))["sp"]))
                   for mode, axes, sizes in TRAIN_SP_FLAGSHIP]
    flagship_legs = [
        dict(name="dense", axes=list(dense_axes), sizes=list(dense_sizes),
             model=TRAIN_FLAGSHIP, dtype="bfloat16", batch=TRAIN_BATCH,
             seq=TRAIN_SEQ, warmup=1, timed=3, moe=False),
        dict(name="moe", axes=list(TRAIN_MESH_MOE[0]),
             sizes=list(TRAIN_MESH_MOE[1]), model=TRAIN_FLAGSHIP_MOE,
             dtype="bfloat16", batch=TRAIN_BATCH, seq=TRAIN_SEQ, warmup=1,
             timed=2, moe=True)]
    for leg in flagship_legs:
        leg["blocks"] = 1
    flagship_legs += sp_flagship + [pp_flagship]
    try:
        first = launch_mesh_ranks(workdir, mesh_trainer_config(
            "cuda", ("parity", "flagship", "resume"), tag="first",
            park=True, parity=parity_legs, flagship=flagship_legs,
            steps=TRAIN_MESH_LOOP_STEPS, save_every=TRAIN_MESH_SAVE_AT,
            **common), n, "first", until="published")
        second = launch_mesh_ranks(workdir, mesh_trainer_config(
            "cuda", ("resume",), tag="second",
            steps=TRAIN_MESH_RESUME_STEPS,
            save_every=TRAIN_MESH_RESUME_STEPS, **common), n, "second")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    failures = []

    def by_rank(run, event, **match):
        return [[e for e in ranks if e["event"] == event
                 and all(e.get(k) == v for k, v in match.items())]
                for ranks in run["events"]]

    emit("train_mesh_start", ranks=n,
         to_imported_s=max(r[0]["t"] for r in first["events"])
         - first["t_spawn"],
         to_device_ready_s=max(
             e["t"] for r in first["events"] for e in r
             if e["event"] == "device_ready") - first["t_spawn"],
         gpu=smi)
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    for leg in parity_legs:
        lines = [r[0] for r in by_rank(first, "parity", name=leg["name"])]
        per_step = leg.get("launches") or {
            k: leg["model"]["n_layers"] * leg["blocks"] for k in kernels}
        n_launch = {k: leg["steps"] * per_step[k] for k in kernels}
        launches = [line["launches"] for line in lines]
        ok = (all(line["ok"] for line in lines)
              and all(c == launches[0] for c in launches)
              and all(launches[0][k] == n_launch[k] for k in kernels)
              and all(launches[0][k] == 0 for k in
                      ("plain_fwd", "plain_bwd", "plain_mha")))
        card_rule = (f"params {leg['param_atol']} abs against the "
                     "one-process step on the card through the plain route")
        if leg.get("sp") or leg.get("pp"):
            card_rule = ("params against the one-process step on the card "
                         "through the plain route within the larger of "
                         f"{leg['param_atol']} and {leg['cpu_gap_ratio']} "
                         "times that step's gap to the CPU step")
        emit("train_sp_parity" if leg.get("sp") else "train_pp_parity"
             if leg.get("pp") else "train_mesh_parity",
             name=leg["name"], ok=ok, context_parallel=leg.get("sp"),
             microbatches=leg.get("pp"),
             mesh=dict(zip(leg["axes"], leg["sizes"])), model=leg["model"],
             tokens=[leg["batch"], leg["seq"] + 1], steps=leg["steps"],
             metrics_rank0=lines[0]["metrics"],
             reference_metrics=lines[0]["reference_metrics"],
             cpu_metrics=lines[0]["cpu_metrics"],
             max_param_abs_diff=max(l["max_param_abs_diff"] for l in lines),
             max_param_abs_diff_cpu=max(l["max_param_abs_diff_cpu"]
                                        for l in lines),
             one_process_card_vs_cpu=lines[0]["one_process_card_vs_cpu"],
             reference_s_by_rank=[l["reference_s"] for l in lines],
             step_s_by_rank=[l["step_s"] for l in lines],
             max_metric_abs_diff=max(l["max_metric_abs_diff"]
                                     for l in lines),
             launches_by_rank=launches,
             launches_per_kernel_expected=(n_launch if leg.get("pp")
                                           else n_launch["flash_fwd"]),
             tolerance=card_rule
             + f"; loss and grad norm {leg['metric_atol']} abs "
               "against it and against the same step on the CPU; "
               "params against the CPU step within the larger of "
               f"{leg['param_atol']} and {leg['cpu_gap_ratio']} "
               "times the one-process card step's gap to it")
        if not ok:
            failures.append(f"parity {leg['name']}")
    out, dense_losses = {}, None
    for leg in flagship_legs:
        lines = [r[0] for r in by_rank(first, "flagship", name=leg["name"])]
        want = dict(leg.get("launches") or {
            k: leg["model"]["n_layers"] * leg["blocks"] for k in kernels})
        want.update(plain_fwd=0, plain_bwd=0, plain_mha=0)
        every = all(p == want for line in lines
                    for p in line["launches_per_step"])
        recorded = all(c["ok"] for line in lines
                       for c in line["recorded"].values())
        losses = lines[0]["losses"]
        falling = (all(math.isfinite(x) for x in losses)
                   and losses[-1] < losses[0]
                   and all(line["losses"] == losses for line in lines))
        reference = lines[0]["reference"]
        first_rel = None if reference is None else [
            abs(a - b) / abs(b) for a, b in zip(
                [losses[0], lines[0]["first_grad_norm"]], reference)]
        matched = first_rel is None or max(first_rel) <= TRAIN_SP_RTOL
        step_ms = [float(np.median(line["step_ms"])) for line in lines]
        coll = lines[0]["collectives"]
        coll_ms = sum(v["ms"] for v in coll.values()) / leg["timed"]
        pp = pp_report(leg, lines) if leg.get("pp") else {}
        ok = (every and recorded and falling and matched
              and pp.get("hops_as_expected", True))
        emit(f"train_{leg['name']}" if leg.get("sp") else "train_pp_flagship"
             if leg.get("pp") else f"train_mesh_{leg['name']}", ok=ok,
             context_parallel=leg.get("sp"), **pp,
             mesh=dict(zip(leg["axes"], leg["sizes"])),
             batch=leg["batch"], seq=leg["seq"], dtype="bfloat16",
             master_weights="float32", warmup_steps=leg["warmup"],
             timed_steps=leg["timed"],
             step_ms_by_rank=[line["step_ms"] for line in lines],
             step_ms_median=float(np.median(step_ms)),
             tokens_per_s=leg["batch"] * leg["seq"]
             / float(np.median(step_ms)) * 1e3,
             collectives_rank0_per_step={
                 k: {"calls": v["calls"] / leg["timed"],
                     "ms": v["ms"] / leg["timed"],
                     "bytes": v["bytes"] / leg["timed"]}
                 for k, v in coll.items()},
             collective_share_rank0=coll_ms / float(np.median(
                 lines[0]["step_ms"])),
             rank_bytes=[line["rank_bytes"] for line in lines],
             one_device_bytes=lines[0]["one_device_bytes"],
             rows_by_rank=[line["rows"] for line in lines],
             launches_per_step_rank0=lines[0]["launches_per_step"][0],
             launches_every_step_as_expected=every,
             step_check=lines[0]["recorded"], step_check_all_ranks=recorded,
             losses=losses, first_grad_norm=lines[0]["first_grad_norm"],
             one_process_first_step=reference,
             first_step_rel_diff=first_rel,
             tolerance=(None if reference is None else
                        f"the first step's loss and grad norm "
                        f"{TRAIN_SP_RTOL} rel against the one-process step "
                        "on the same params and tokens"),
             peak_memory_gb_by_rank=[
                 line["peak_memory_gb"] for line in lines], gpu=smi)
        if not ok:
            failures.append(f"flagship {leg['name']}")
        out[leg["name"]] = {str(i): {k: line["launches"][k] for k in kernels}
                            for i, line in enumerate(lines)}
        if leg["name"] == "dense":
            dense_losses = losses
    restored = by_rank(second, "restored")
    steps = by_rank(second, "step")

    def rel_to_dense(events) -> float:
        return max((abs(e["loss"] - dense_losses[e["step"] - 1])
                    / abs(dense_losses[e["step"] - 1]) for e in events),
                   default=math.inf)

    rel = rel_to_dense(steps[0])
    done = [r[0] for r in by_rank(second, "done")]
    n_steps = TRAIN_MESH_RESUME_STEPS - TRAIN_MESH_SAVE_AT
    # The first launch's loop: killed inside it (no rank done) once its
    # first save was published, its steps (b)'s steps.
    looped = by_rank(first, "step")
    saves = by_rank(first, "saved")
    killed_inside = (first["t_until"] is not None
                     and not any(by_rank(first, "done"))
                     and all(s and s[0]["step"] == TRAIN_MESH_SAVE_AT
                             for s in saves))
    loop_rel = max(rel_to_dense([e for e in r if e["step"] <= len(
        dense_losses)]) for r in looped)
    resumed_ok = (killed_inside and loop_rel <= RESUME_LOSS_RTOL
                  and all(r and r[0]["step"] == TRAIN_MESH_SAVE_AT
                          for r in restored)
                  and all([e["step"] for e in s] == list(range(
                      TRAIN_MESH_SAVE_AT + 1, TRAIN_MESH_RESUME_STEPS + 1))
                      for s in steps)
                  and rel <= RESUME_LOSS_RTOL
                  and all(d["launches"][k] == n_steps
                          * TRAIN_FLAGSHIP["n_layers"]
                          for d in done for k in kernels))
    emit("train_mesh_resume", ok=resumed_ok, saved_at=TRAIN_MESH_SAVE_AT,
         run_to=TRAIN_MESH_RESUME_STEPS,
         killed="every rank SIGKILLed inside its loop once the step "
                f"{TRAIN_MESH_SAVE_AT} save was published",
         killed_inside_loop=killed_inside,
         last_step_logged_by_rank=[max((e["step"] for e in r), default=None)
                                   for r in looped],
         saves_started_by_rank=[[e["step"] for e in s] for s in saves],
         save_blocked_ms_by_rank=[s[0]["blocked_ms"] if s else None
                                  for s in saves],
         pinned_bytes_by_rank=[s[0]["pinned_bytes"] if s else None
                               for s in saves],
         save_to_published_seen_s=first["t_until"] - max(
             s[0]["t"] for s in saves) if killed_inside else None,
         loop_losses=[e["loss"] for e in looped[0]],
         loop_max_loss_rel_diff=loop_rel,
         restored_from=[r[0]["step"] if r else None for r in restored],
         losses=[e["loss"] for e in steps[0]],
         uninterrupted_losses=dense_losses[TRAIN_MESH_SAVE_AT:
                                           TRAIN_MESH_RESUME_STEPS],
         max_loss_rel_diff=rel, tolerance=f"losses {RESUME_LOSS_RTOL} rel",
         read_s_by_rank=[r[0]["read_s"] if r else None for r in restored],
         restart_to_restored_s=max(r[0]["t"] for r in restored)
         - second["t_spawn"] if all(restored) else None,
         restart_to_first_step_s=max(s[0]["t"] for s in steps)
         - second["t_spawn"] if all(steps) else None,
         launches_by_rank=[d["launches"] for d in done], gpu=smi)
    if not resumed_ok:
        failures.append("resume")
    # Each leg's seconds on rank 0: from the event before it to its own.
    ends = [(e.get("name"), e["t"]) for e in first["events"][0]
            if e["event"] in ("device_ready", "parity", "flagship")]
    leg_seconds = {name: t - before for (_, before), (name, t)
                   in zip(ends, ends[1:])}
    for phase, kind in (("train_sp", "sp"), ("train_pp", "pp")):
        names = {leg["name"] for leg in parity_legs + flagship_legs
                 if leg.get(kind)}
        seconds = {name: leg_seconds[name] for name in sorted(names)}
        emit(phase, legs=sorted(names), seconds=sum(seconds.values()),
             seconds_by_leg=seconds,
             failures=[f for f in failures if f.split()[-1] in names],
             gpu=smi)
    emit("train_mesh", ranks=n, seconds=time.perf_counter() - t0,
         sp_legs_seconds=sum(leg_seconds[leg["name"]] for leg in
                             parity_legs + flagship_legs if leg.get("sp")),
         pp_legs_seconds=sum(leg_seconds[leg["name"]] for leg in
                             parity_legs + flagship_legs if leg.get("pp")),
         timeline_rank0={"first": rank_timeline(first),
                         "second": rank_timeline(second)},
         failures=failures, gpu=smi)
    if failures:
        raise AssertionError(f"train_mesh: {failures}")
    return (out["dense"], {leg["name"]: out[leg["name"]]
                           for leg in flagship_legs if leg.get("sp")},
            out[pp_flagship["name"]])


def pp_report(leg: dict, lines: list) -> dict:
    """Phase 36's flagship fields from its ranks' lines: the bubble's
    share of the ticks in theory, (P - 1) / (M + P - 1), against each
    rank's measured share of its profiled step spent waiting in hand-offs;
    each rank's collectives a step by kind; whether every rank made M +
    2P - 2 hops a step."""
    n_stages = dict(zip(leg["axes"], leg["sizes"]))["pp"]
    m = leg["pp"]
    per_step = [{k: {"calls": v["calls"] / leg["timed"],
                     "ms": v["ms"] / leg["timed"],
                     "bytes": v["bytes"] / leg["timed"]}
                 for k, v in line["collectives"].items()} for line in lines]
    idle = []
    for line in lines:
        ticks = line["ticks"]
        wait = sum(w for _, w in ticks)
        idle.append(wait / (wait + sum(c for c, _ in ticks)))
    return dict(
        stages=n_stages, microbatches=m,
        layers_per_stage=leg["model"]["n_layers"] // n_stages,
        stage_by_rank=[line["stage"] for line in lines],
        bubble_share_theory=(n_stages - 1) / (m + n_stages - 1),
        idle_share_measured_by_rank=idle,
        ticks_ms_by_rank=[line["ticks"] for line in lines],
        collectives_per_step_by_rank=per_step,
        hops_per_step_expected=m + 2 * n_stages - 2,
        hops_as_expected=all(
            s["pipeline_hop"]["calls"] == m + 2 * n_stages - 2
            for s in per_step))

def main() -> int:
    import shutil

    # The processes this script starts (trainers, a gang's followers, the
    # replica, the SPMD ranks) each import torch anew. The card's image sets
    # PYTHONDONTWRITEBYTECODE, so each compiled torch's modules afresh
    # (on an H100 host, 9.4 s an import with four at once against 6.2 s
    # from compiled bytecode): they keep their bytecode under the
    # checkout's build directory instead.
    os.environ["PYTHONPYCACHEPREFIX"] = str(HERE / "build" / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    # The bucket phases 6 and 14 publish into and phase 24 imports from.
    bucket = tempfile.mkdtemp(prefix="tpu-task-kvfleet-")
    try:
        return run_phases(bucket)
    finally:
        shutil.rmtree(bucket, ignore_errors=True)


def run_phases(bucket: str) -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    import_port()
    device = torch.device("cuda")
    phase_build()
    fwd_build = phase_flash_fwd_build()
    bwd_build = phase_flash_bwd_build()
    max_err, combine_err = phase_kernel(device)
    timing = phase_timing(device, smi)
    spec_times = phase_timing_spec(device, smi)
    phase_parity(device)
    launches, combine_launches, serve_streams, published, serve_median, \
        serve_seed2 = phase_serve(device, smi, bucket)
    flash_err = phase_flash_kernel(device)
    flash_times = phase_flash_timing(device, smi)
    phase_flash_fwd_shapes(device, smi)
    phase_flash_bwd_shapes(device, smi)
    phase_train_parity(device)
    train_counts = phase_train(device, smi)
    with tempfile.TemporaryDirectory(prefix="tpu-task-train-") as root:
        ckpt_counts = phase_train_checkpoint(device, smi, Path(root))
        resume_counts = phase_train_resume_process(device, smi, Path(root))
        window_counts = phase_train_profile_window(device, smi, Path(root))
    quant_err = phase_kernel_quant(device)
    quant_times = phase_timing_quant(device, smi)
    phase_parity_quant(device)
    pipelined_launches, pipelined_combines, quant_streams, \
        published_quant, quant_median = phase_serve_quant(device, smi,
                                                          bucket)
    micro, traced = phase_serve_micro(device, smi)
    trace_lines = phase_serve_trace(traced, smi)
    del traced
    micro_quant = phase_serve_micro_quant(device, smi)
    phase_parity_spec(device)
    spec = phase_serve_spec(device, smi, serve_streams)
    spec_quant = phase_serve_spec_quant(device, smi, quant_streams)
    phase_parity_resume(device)
    resume = phase_serve_resume(device, smi, serve_streams, quant_streams)
    phase_parity_kvfleet(device)
    kvfleet = phase_serve_kvfleet(device, smi, bucket, published,
                                  published_quant)
    parity_replica = phase_parity_replica(device)
    replica = phase_serve_replica(device, smi, serve_streams, quant_streams,
                                  {"bf16": serve_median,
                                   "int8": quant_median})
    roll = phase_serve_roll(device, smi, serve_streams, quant_streams,
                            {"bf16": serve_median, "int8": quant_median},
                            replica["bf16"])
    lora = phase_serve_lora(device, smi, serve_streams, serve_seed2,
                            serve_median)
    overlap = phase_serve_overlap(device, smi, trace_lines[MICRO_KS[-1]])
    tier = phase_serve_tier(device, smi)
    moe = phase_serve_moe(device, smi, serve_median)
    bucketed = phase_serve_bucketed(device, smi)
    mesh = phase_serve_mesh(device, smi)
    torch.cuda.empty_cache()
    train_mesh, train_sp, train_pp = phase_train_mesh(device, smi)

    def spec_scoring(kernel: str) -> dict:
        row = spec_times[kernel]
        return {f"spec_scoring_{key}": row[key] for key in (
            "w", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "splits", "unsplit_ms")}

    def micro_launches(lines: dict, key: str) -> dict:
        return {f"micro_k_{k}": line[key] for k, line in lines.items()}

    def mesh_ranks(route: str, key: str = "rank_launches") -> dict:
        """Phase 33's per-rank launches: each flagship leg through
        ``route`` and each gang's tiny legs."""
        return {leg: line[key] for leg, line in mesh["flagship"].items()
                if line["kernel"] == route or key != "rank_launches"}

    def by_storage(kernel: str) -> dict:
        return {storage: {key: rows[16][key] for key in (
                    "ms", "plain_ms", "bound_ms", "library_ms")}
                for storage, rows in quant_times[kernel].items()}

    int8 = quant_times["paged_decode_pipelined"]["int8"][16]
    int8_chunk = quant_times["paged_decode_pipelined"]["int8"][CHUNK_ROWS]
    batch16, combine = timing[16], timing["combine"]
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "tpu_task_torch/csrc/paged_decode.cu",
        "replaces": "tpu_task/ml/ops/paged_attention.py:175",
        "launches": launches,
        "max_abs_err": max(max_err, quant_err["paged_decode"]),
        "ms": batch16["ms"], "plain_ms": batch16["plain_ms"],
        "bound_ms": batch16["bound_ms"], "bound_by": batch16["bound_by"],
        "library_ms": batch16["library_ms"],
        "splits_batch16": batch16["splits"],
        "unsplit_ms": batch16["unsplit_ms"],
        "chunk_step_ms": timing[CHUNK_ROWS]["ms"],
        "chunk_step_splits": timing[CHUNK_ROWS]["splits"],
        "chunk_step_unsplit_ms": timing[CHUNK_ROWS]["unsplit_ms"],
        "by_storage_batch16": by_storage("paged_decode"),
        "launches_serve_micro": micro_launches(micro, "kernel_launches"),
        "launches_serve_spec": {name: line["kernel_launches"]
                                for name, line in spec.items()},
        "launches_serve_resume": resume["bf16"]["kernel_launches"],
        "launches_serve_kvfleet": kvfleet["bf16"]["kernel_launches"],
        "launches_parity_replica": parity_replica["cuda"],
        "launches_serve_replica": replica["bf16"]["kernel_launches"],
        "launches_serve_roll": roll["cuda"],
        "launches_serve_lora": lora["flagship"]["cuda"],
        "launches_parity_lora": lora["parity"]["cuda"][0],
        "launches_serve_overlap": overlap["flagship"]["cuda"],
        "launches_parity_overlap": overlap["parity"]["cuda"],
        "launches_serve_tier": tier["flagship"]["cuda"],
        "launches_parity_tier": tier["parity"]["cuda"],
        "launches_serve_moe": moe["flagship"]["cuda"],
        "launches_parity_moe": moe["parity"]["cuda"],
        "launches_serve_bucketed": bucketed["flagship"]["cuda"],
        "launches_parity_bucketed": bucketed["parity"]["cuda"],
        "launches_serve_mesh_by_rank": mesh_ranks("cuda"),
        "launches_parity_mesh_by_rank": {
            g: t["cuda"] for g, t in mesh["parity"].items()},
        **spec_scoring("paged_decode")}]
    for name, line in (("flash_fwd", 186), ("flash_bwd_dq", 344),
                       ("flash_bwd_dkv", 394)):
        row = flash_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpu_task_torch/csrc/flash_attention.cu",
            "replaces": f"tpu_task/ml/ops/attention.py:{line}",
            "launches": train_counts[name], "max_abs_err": flash_err[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "fraction_of_bound": row["fraction_of_bound"],
            "launches_train_checkpoint": ckpt_counts[name],
            "launches_train_resume_process": resume_counts[name],
            "launches_train_profile_window": window_counts[name],
            "launches_train_moe": moe["train"][name],
            "launches_train_mesh_by_rank": {
                rank: counts[name] for rank, counts in train_mesh.items()},
            "launches_train_sp_by_rank": {
                leg: {rank: counts[name] for rank, counts in ranks.items()}
                for leg, ranks in train_sp.items()},
            "launches_train_pp_by_rank": {
                rank: counts[name] for rank, counts in train_pp.items()}})
        # B1, B2 and B3 v3: wgmma fed by TMA rings
        build = fwd_build if name == "flash_fwd" else bwd_build[name]
        kernels[-1].update(version="v3", kernel=f"{name}_wgmma_kernel",
                           registers_d128=build[128]["registers"],
                           ctas_per_sm_d128=build[128]["ctas_per_sm"])
    kernels.append({
        "name": "paged_decode_pipelined", "route": "cuda",
        "source": "tpu_task_torch/csrc/paged_decode_pipelined.cu",
        "replaces": "tpu_task/ml/ops/paged_attention.py:339",
        "launches": pipelined_launches,
        "max_abs_err": quant_err["paged_decode_pipelined"],
        "ms": int8["ms"], "plain_ms": int8["plain_ms"],
        "bound_ms": int8["bound_ms"], "bound_by": int8["bound_by"],
        "library_ms": int8["library_ms"], "storage": "int8",
        "splits_batch16": int8["splits"], "unsplit_ms": int8["unsplit_ms"],
        "tensor_cores": int8["tensor_cores"],
        "chunk_step_ms": int8_chunk["ms"],
        "chunk_step_splits": int8_chunk["splits"],
        "chunk_step_unsplit_ms": int8_chunk["unsplit_ms"],
        "by_storage_batch16": by_storage("paged_decode_pipelined"),
        "launches_serve_micro_quant": micro_launches(micro_quant,
                                                     "kernel_launches"),
        "launches_serve_spec_quant": spec_quant["kernel_launches"],
        "launches_serve_resume_quant": resume["int8"]["kernel_launches"],
        "launches_serve_kvfleet_quant": kvfleet["int8"]["kernel_launches"],
        "launches_parity_replica": parity_replica["pipelined"],
        "launches_serve_replica_quant": replica["int8"]["kernel_launches"],
        "launches_serve_roll_quant": roll["pipelined"],
        "launches_serve_lora_quant": lora["flagship"]["pipelined"],
        "launches_parity_lora": lora["parity"]["pipelined"][0],
        "launches_serve_overlap_quant": overlap["flagship"]["pipelined"],
        "launches_parity_overlap": overlap["parity"]["pipelined"],
        "launches_serve_tier_quant": tier["flagship"]["pipelined"],
        "launches_parity_tier": tier["parity"]["pipelined"],
        "launches_serve_moe_quant": moe["flagship"]["pipelined"],
        "launches_parity_moe": moe["parity"]["pipelined"],
        "launches_serve_bucketed_quant": bucketed["flagship"]["pipelined"],
        "launches_parity_bucketed": bucketed["parity"]["pipelined"],
        "launches_serve_mesh_by_rank": mesh_ranks("pipelined"),
        "launches_parity_mesh_by_rank": {
            g: t["pipelined"] for g, t in mesh["parity"].items()},
        "spec_scoring_tensor_cores":
            spec_times["paged_decode_pipelined"]["tensor_cores"],
        **spec_scoring("paged_decode_pipelined")})
    # The split walk's second pass: the merge that _paged_decode_kernel's
    # _finalize does at the end of its sequential block axis.
    kernels.append({
        "name": "paged_decode_combine", "route": "cuda",
        "source": "tpu_task_torch/csrc/paged_kv.cuh",
        "replaces": "tpu_task/ml/ops/paged_attention.py:252",
        "launches": combine_launches,
        "launches_after_pipelined": pipelined_combines,
        "launches_serve_micro": micro_launches(micro, "combine_launches"),
        "launches_serve_micro_quant": micro_launches(micro_quant,
                                                     "combine_launches"),
        "launches_serve_spec": {name: line["combine_launches"]
                                for name, line in spec.items()},
        "launches_serve_spec_quant": spec_quant["combine_launches"],
        "launches_serve_resume": resume["bf16"]["combine_launches"],
        "launches_serve_resume_quant": resume["int8"]["combine_launches"],
        "launches_serve_kvfleet": kvfleet["bf16"]["combine_launches"],
        "launches_serve_kvfleet_quant": kvfleet["int8"]["combine_launches"],
        "launches_parity_replica": parity_replica["combine"],
        "launches_serve_replica": replica["bf16"]["combine_launches"],
        "launches_serve_replica_quant": replica["int8"]["combine_launches"],
        "launches_serve_roll": roll["cuda_combine"],
        "launches_serve_roll_quant": roll["pipelined_combine"],
        "launches_serve_lora": lora["flagship"]["cuda_combine"],
        "launches_serve_lora_quant": lora["flagship"]["pipelined_combine"],
        "launches_parity_lora": (lora["parity"]["cuda"][1]
                                 + lora["parity"]["pipelined"][1]),
        "launches_serve_overlap": overlap["flagship"]["cuda_combine"],
        "launches_serve_overlap_quant":
            overlap["flagship"]["pipelined_combine"],
        "launches_parity_overlap": overlap["parity"]["combine"],
        "launches_serve_tier": tier["flagship"]["cuda_combine"],
        "launches_serve_tier_quant": tier["flagship"]["pipelined_combine"],
        "launches_parity_tier": tier["parity"]["combine"],
        "launches_serve_moe": moe["flagship"]["cuda_combine"],
        "launches_serve_moe_quant": moe["flagship"]["pipelined_combine"],
        "launches_parity_moe": moe["parity"]["combine"],
        "launches_serve_bucketed": bucketed["flagship"]["cuda_combine"],
        "launches_serve_bucketed_quant":
            bucketed["flagship"]["pipelined_combine"],
        "launches_parity_bucketed": bucketed["parity"]["combine"],
        "launches_serve_mesh_by_rank": mesh_ranks(
            "", "rank_combine_launches"),
        "launches_parity_mesh_by_rank": {
            g: t["combine"] for g, t in mesh["parity"].items()},
        "max_abs_err": max(combine_err, quant_err["paged_decode_combine"]),
        "ms": combine["ms"], "plain_ms": combine["plain_ms"],
        "bound_ms": combine["bound_ms"], "bound_by": combine["bound_by"],
        "library_ms": None, "splits": combine["splits"]})
    emit("total", seconds=time.perf_counter() - t_start, gpu=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
