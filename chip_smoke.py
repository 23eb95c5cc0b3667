#!/usr/bin/env python3
"""chip_smoke — the quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository's ``src/repro_torch``. Phases, each of which must pass:

  1. print the card (``nvidia-smi``: name, power limit) and build every
     CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each,
     in parallel), logging what ``ptxas`` gave each kernel (registers,
     shared memory, spills; a spill in the flash (forward or backward),
     decode, GEMV or wkv source fails the run);
  2. hold each kernel against its plain PyTorch version on the card, at
     the full-width shapes of the serving paths (llama3.2-1b's; rwkv6-7b's
     and jamba-v0.1-52b's decode FCs, norms and jamba's decode attention;
     rwkv6-7b's full-sequence prefill for ``rwkv_chunk``, also at the
     model's strong decays, and jamba-v0.1-52b's for ``mamba_chunk`` and
     for flash: S 2048, head dim 128, causal, beside SDPA with
     ``is_causal``; both prefill steps' norms; flash in both modes at the
     head dims that are no multiple of 64: gpt2-2.5b's prefill chunk (D
     96), kimi-k2's and pixtral-12b's prefill steps (D 112 and 160, S
     1024 causal); flash's non-causal mode at whisper-medium's encoder (B 2,
     16 heads, 1,500 frames) and cross-attention (448 queries against the
     frames) shapes and a ragged one, beside SDPA without a mask, where
     the plain version with one KV tile dropped must fail the bound;
     decode attention at whisper's cross cache (B 8, 1,500 frames, G 1) and
     pixtral's (D 160), and in its partial mode (o and the log-sum-exp) at
     phase 21a's shard (B 8, 48 heads on one KV head of 128, 512
     positions, lengths 0 to 512 in it; the lse to 1e-4 / 1e-3, beside
     PyTorch's memory-efficient attention with its log-sum-exp, where the
     plain version with the second split's keys dropped must fail the
     bound); flash's segmented mode at phase 21a's packed chunk on a rank
     (R 8, C 128, 24 heads on one KV head of 128, a prefix of 512 rows),
     bitwise over two calls, beside SDPA with the mask; gpt2-xl's,
     gpt2-2.5b's, whisper's and pixtral's
     decode FCs and norms, qwen3-moe's k/v FC, kimi-k2's prefill norm and
     whisper's and pixtral's prefill-step norms) plus ragged cases, in
     float32 and bfloat16 (tolerances of the reference's kernel tests:
     1e-4, 2e-3 for the chunked wkv (in bf16 too where y is f32), and
     5e-2; flash, decode_attention, pim_matvec and rwkv_chunk's bf16 y in
     bf16 1e-2 + 2e-2 |want|, which a kernel that drops one KV tile,
     split, K-slice or block of the wkv fails; the last three must give
     the same bits on a second call), and time the
     kernel, the plain version and one PyTorch library call computing the
     same function where there is one (in bfloat16; ``mamba_chunk`` in
     float32, the type its path gives it), and what the timing gives for
     an empty kernel and for a device copy (the floor under the norm);
     the training path's kernels: flash's static mode with its ``lse``
     output at llama's training shape (B 4, S 1024 causal), the flash
     backward there, at a ragged S 1000, non-causal at whisper's
     encoder shape (G 1) and its cross attention (448 queries against
     1,500 frames), at phase 16c's reduced llama (B 8, S 64, 4 / 2 heads
     of 16) and at a ragged S 321 with G 8 and head dim 32, bitwise over
     two calls, where the plain backward with one KV tile's dK and dV
     dropped must fail the bound, beside the
     autograd backward of SDPA with ``is_causal``; the norm backward in
     all three modes at rows 4096 x d 2048 and a ragged row count,
     bitwise over two calls, beside the autograd backward of
     ``F.rms_norm`` / ``F.layer_norm``; the flash backward also at
     jamba's attention layer (B 2, S 2048, 32 / 8 heads of 128) and at the
     head dims above 64 that are no multiple of it, each on the tensor
     cores at the padded width: gpt2-2.5b's (20 heads of 96), kimi-k2's
     (64 / 8 heads of 112) and pixtral-12b's (32 / 8 heads of 160) at B 2,
     S 1024 causal, and a ragged S 1000 at D 160; the recurrences' backward
     kernels against their plain
     adjoint recurrences, bitwise over two calls (no spill): the wkv's at
     rwkv6-7b's training call (BH 128, T 2048, K 64, u (H, K)), a ragged
     T with dS_T, U < BH at K 16 and the model's strong decays, the
     Mamba scan's at jamba's (B 2, T 2048, d 8192, n 16, in float32), a
     ragged T with dh_T and the reduced widths, from the checkpoints that
     its forward kernel writes under a gradient (f32 within 2e-3, bf16
     within 1e-2 + 2e-2 |want|; no library call computes either); the
     forward's checkpoints (h every 16 steps) against h of the plain
     recurrence at those steps, and its time with them beside the serving
     call's;
  2b. call ``ops.masked_softmax`` on a llama prefill chunk's scores with
     the launch counts set to 0 just before: the kernel must launch, give
     exact zeros where masked and rows that sum to 1;
  3. serve 8 requests through ``ServeEngine`` at full llama3.2-1b width
     (bf16, random weights from a seed) with the launch counts set to 0
     just before and read just after; every kernel of the unpacked path
     must have launched;
  3b. serve the same prompts with packed prefill (``pack=True``): the
     segmented flash kernel must have launched, and the run must make
     exactly one host sync per decode step and no hidden one;
  3c. serve them again with the int8 KV cache (``kv_dtype="int8"``);
  3d. on the same weights in bf16, the first decode step after the
     prompts' prefill and the prefill step (B 2, S 1024), through the
     kernels and through the plain versions on the card, each against the
     same step's plain path in float32: the kernel path's max |error| at
     most twice the bf16 plain path's own (the packed prefill's first step
     too, and its difference from the unpacked one logged) -- the check
     of the tensor-core routes (flash, the GEMV) at model level, which the
     float32 parity phases never run;
  4. serve prompts through llama3.2-1b at full width and depth 2 in
     float32 on the card and, through the plain versions, on the CPU,
     unpacked, packed and with the int8 cache: greedy tokens, dispatch
     counts and host syncs must be identical, and on the card the packed
     serve must give the unpacked one's tokens, decode dispatches and
     host syncs;
  5. serve 8 requests (prompts of 8-64 tokens cut to 24, 16 new tokens
     each) through rwkv6-7b at full width (bf16, random weights from a seed):
     sequential prefill and decode through ``pim_matvec`` and the norm
     kernel, one host sync per decode step and no hidden one;
  5b. run rwkv6-7b's full-sequence prefill step (B 2, S 2048,
     ``last_only=True``): ``rwkv_chunk`` must launch once per layer; then
     profile one step and a short serve with ``torch.profiler`` (the
     device's busy share and the ops that take its time);
  6. rwkv6-7b at full width and depth 2 in float32, the kernels on the
     card against the plain versions on the CPU: the serve gives identical
     greedy tokens, dispatch counts and host syncs, the prefill step at
     S 256 logits within 1e-4;
  7. serve 8 requests (prompts of 8-64 tokens cut to 24, 16 new tokens
     each) through jamba-v0.1-52b at full width cut to depth 8 (one whole Jamba
     period: 7 Mamba layers, attention at layer 4, MoE on layers 1, 3, 5,
     7; bf16, random weights from a seed; its 32 layers do not fit one
     card): sequential prefill and decode through ``pim_matvec``, the norm
     kernel and ``decode_attention``, one host sync per decode step and no
     hidden one;
  7b. run its full-sequence prefill step (B 2, S 2048, ``last_only=True``):
     ``mamba_chunk`` must launch once per Mamba layer (7) and
     ``flash_attention`` once; then profile as in 5b;
  7c. as 3d, at jamba's depth 8 (prompts cut to 16 tokens, sequential
     prefill; no packing);
  8. jamba-v0.1-52b at full width and depth 2 in float32 (one mamba/dense
     and one attn/moe layer), the kernels on the card against the plain
     versions on the CPU: the serve gives identical greedy tokens,
     dispatch counts and host syncs, the prefill step at S 256 logits and
     the MoE aux loss within 1e-4;
  9. on phase 3's weights (before 3d casts them), an open-loop workload
     (``repro_torch.trace.poisson_arrivals``: rate 0.25 over 48 steps,
     prompts of 64-700 tokens, 16-32 new; about 12 requests) driven by
     ``repro_torch.trace.drive`` three times: ``serial`` + pack,
     ``interleaved`` + pack + fuse + superstep 4, and ``pim_aware`` with the
     same knobs, each twice in turns after an unmeasured serve, under
     CUDA's sync debug mode. Each serve: the launches are exactly phase
     3's per decode round and phase 3b's per packed prefill (a fused step
     is one of each), so every path kernel launched; host syncs equal the
     decode + fused dispatches; no hidden sync; the interleaving policies
     ran fused steps and supersteps. Logged against ``serial``: decode
     tok/s and ms per round of the pure-decode steps, decode rounds per
     host sync, prefill tok/s, TTFT in steps, and (one profiled serve
     each) the device's busy share. Each measured serve is recorded with
     ``repro_torch.trace.TraceRecorder`` beside its hooks, for phase 13;
  9b. the same workload at full width, depth 2, float32: ``interleaved``
     and ``pim_aware`` through the kernels on the card and the plain
     versions on the CPU give identical greedy tokens, dispatch counts,
     host syncs, step kinds, (``pim_aware``) decision logs and recorded
     traces, event for event, and on the card the tokens of the
     ``serial`` serve;
  10. serve phase 3's prompts through gpt2-xl (the paper's model: 48
     layers, d 1536, 24 heads of 64, layernorm with bias, gelu, tied) at
     full width and depth, unpacked and packed, each twice in turns: each
     decode step and prefill dispatch launches exactly decode attention
     and flash once a layer, the norm twice a layer (and once at the end
     of a step) and the GEMV 6 times a layer; then phase 9's arrivals
     under ``serial`` + pack and ``pim_aware`` + pack + fuse + superstep
     4, held to these launches a round and a chunk as phase 9 holds its
     own and recorded as phase 9's, and one profiled short serve;
  10b. as 10 without the policies, through gpt2-2.5b (54 layers, d 1920,
     20 heads of 96): flash in both modes and decode attention at D 96;
  10c. gpt2-2.5b at full width and depth 2 in float32, unpacked and
     packed, the kernels on the card against the plain versions on the
     CPU, as phase 8 (the float32 flash route at D 96 in the model);
  11. serve phase 3's prompts through qwen3-moe-30b-a3b at its published
     widths (128 experts top-8, 32 / 4 heads of 64) cut to 12 of 48
     layers, unpacked and packed (batched and packed prefill through MoE),
     with 10's launch checks (no GEMV for the experts, batched matmuls as
     in the reference), then one profiled serve;
  11b. qwen3-moe-30b-a3b at depth 2 in float32, card against CPU, as 10c,
     with the MoE aux loss within 1e-4;
  11c. on a card emptied of every earlier phase's tensors, kimi-k2's
     prefill step (B 2, S 1024) at its published widths (d 7168, 64 / 8
     heads of 112, 384 experts) cut to 1 of 61 layers: flash at D 112
     once, logits finite, its peak memory logged;
  12. the chaos guard's fleet (``benchmarks/data/chaos_baseline.json``'s
     serve, bursty workload, 3 replicas, ``least_loaded``, the plan read
     from ``chaos_plan.json``) at full llama3.2-1b width and depth in
     bf16: fault-free, under the plan, and under the plan with mirrored
     KV snapshots every 4 ticks; then ``fleet_baseline.json``'s
     two-replica fleet under each routing policy. The workloads end by
     budget, so the tick schedule does not depend on the weights: the
     chaos counts, the snapshot events, rows, restores, saved and paid
     tokens and the fleet's requests, tokens and tick latencies must
     equal the baselines', the snapshot bytes rows x 32,768; goodput 1.0,
     saved + paid = the from-zero re-prefill; the kernels launch exactly
     a decode round's and a packed chunk's count for the rounds and
     chunks the nodes' traces record; one host sync per decode,
     superstep or fused dispatch, and beside them one blocking transfer
     per KV export and no other (CUDA's sync debug mode). Logged: ms per
     fleet tick, bf16 token agreement of each chaos run with the
     fault-free run;
  12b. a fleet at phase 3's serving shape and knobs (``SERVING_FLEET``:
     bursty prompts of 64-700 tokens, 16-32 new, 3 replicas, node 1
     crashing at tick 18, after the second snapshot interval of 8):
     fault-free, crashed from zero, crashed with mirrored snapshots; the
     same launch and sync gates, goodput 1.0, a restore, saved + paid =
     from zero. Logged: ms per fleet tick and per decode round of each
     node, the KV exports' bytes, device ms and GB/s to the host, each
     restore's device ms, each recovered request's ticks and device ms
     to its first new token, p50/p99 TTFT/TPOT/queue wait in ticks
     (``FleetMetrics``), peak memory. The nodes' traces of every fleet
     run of 12 and 12b go to phase 13;
  12c. phase 12's fleet at full llama3.2-1b width, depth 2, float32:
     the chaos and snapshot runs give the fault-free run's tokens for
     every arrival, and the fault-free fleet's tokens, assignments,
     dispatches and host syncs on the card equal the port's on the CPU;
  13. (run last, after 15b) the port's own ``verify`` over every trace
     phases 9, 9b, 10, 12, 12b, 12c, 14c and 15 recorded, in worker
     processes after the measured phases: the
     protocol lint (``lint_trace``), the span hazards of the lowered
     steps (``analyze_lowered(trace_to_commands(trace))``), each lowered
     step against its reference DAG (``verify_lowered_step``), and for
     each fleet run ``check_exactly_once`` and
     ``check_snapshot_provenance`` over its nodes' traces: any finding
     fails the run; the host-sync lint over the port's ``serve``,
     ``sched``, ``obs``, ``fleet`` and ``chaos`` with its allowlist must
     find nothing; and phase 9's first ``pim_aware`` trace, lowered
     against llama3.2-1b's full config, replays through ``TraceReplayer``
     on the simulated IANUS and NPU-MEM machines (the paper's models, as
     ``benchmarks/trace_replay.py`` replays): their makespans and splits
     by tag, the FC routes' agreement, logged beside the card's measured
     ms per decode round of the same serve. The lint's
     ``gather_before_scatter`` findings on the packed dispatches after an
     unaligned KV-snapshot restore (phase 12b), where the re-derived plan
     reads no row that was neither restored nor scattered, are the
     reference's known false alarm: they are counted and printed, and any
     other finding fails;
  14. whisper-medium at full width and depth (24 encoder and 24 decoder
     layers, bf16, weights from a seed, frames from ``batch_for``; the
     earlier phases' garbage collected first, so that its peak memory is
     its own, as 15's): (a) its
     prefill step at B 2, 1,500 frames, 448 decoder tokens, launching flash
     exactly 72 times (24 non-causal in the encoder, 24 causal, 24
     non-causal cross) and the norm 122 times, its ms and peak memory
     logged, then profiled; (b) ``prefill_with_cache`` for 8 rows of 16
     tokens with frames, then 32 greedy decode steps against the filled
     cross cache,
     twice, identical tokens, each step launching decode attention 48
     times (self and cross), the GEMV 192 and the norm 73; (c) the engine
     serves 8 requests (prompts of 4-32 tokens, 16 new, ``max_len`` 448)
     twice: identical tokens, sequential prefill (a dispatch a prompt
     token but the last), those launches in every dispatch, one host sync
     a decode step and no hidden one; the bf16 bound of 3d on the prefill
     step and a decode step;
  14b. whisper-medium at full width, depth 2, float32, card against CPU:
     prefill-step logits within 1e-4, (b)'s and (c)'s tokens, dispatches
     and host syncs identical;
  15. pixtral-12b at full width and depth (40 layers, 25.5 GB in bf16):
     (a) its prefill step at B 2 with 256 patches and 768 text tokens,
     flash at D 160 40 times and the norm 81 times; (b) phase 3's serve
     unpacked and packed, each twice, with exactly ``path_launches``'s
     kernels a decode step and a prefill chunk (decode attention 40, the
     GEMV 280, the norm 81; flash or its segmented mode 40), tokens
     repeated; a profiled short serve;
  15b. pixtral-12b at full width, depth 2, float32, card against CPU: the
     prefill step with patches within 1e-4, unpacked and packed serves
     identical; the bf16 bound of 3d at depth 2.

  16. training llama3.2-1b at full width and depth (16 layers, d 2048,
     vocab 128,256, bf16 weights from a seed, ``remat="full"``): AdamW
     under ``linear_warmup_cosine``, ``SyntheticLM`` batches of 4 x 1024,
     30 steps. Step 1's gradient has every leaf finite and nonzero; every
     loss is finite and the last 5 average below the first 5; each step
     launches flash 32 times (16, and 16 again in the remat's
     recomputation), its backward 16, the norm 65 and its backward 33,
     and no other kernel; ms a step, tokens/s, the share of 989 TFLOP/s
     that 6 N tokens a step reach, peak memory and the busy share (a
     profiled step) logged;
  16b. the same at depth 2 in float32, card against CPU, 3 steps at a
     constant rate: losses, every gradient leaf of step 1 and the
     parameters after each step within 1e-4, the launches exact;
  16c. ``python -m repro_torch.launch.train --arch llama3.2-1b --smoke
     --steps 60 --ckpt-every 20 --fail-at-step 45`` on the card exits 17
     after its checkpoint at step 40, and the rerun prints "resumed from
     step 40" and "done:" and exits 0.
  17. training rwkv6-7b at full width cut to 8 of 32 layers (bf16 weights
     from a seed, ``remat="full"``), AdamW under a 2-step warmup to 1e-3,
     10 steps on one ``SyntheticLM`` batch of 2 x 2048: the losses finite
     and the last 3 below the first 3, the gradient at the trained
     weights finite and nonzero in every leaf, each step launching
     ``rwkv_chunk`` 16 times (forward and recomputed), ``rwkv_chunk_bwd``
     8, the norm 33 and its backward 17; logged as 16's;
  17b. rwkv6-7b at depth 2, float32, S 128: step 1's gradient and 3 AdamW
     steps through the kernels against the plain versions on the card
     (every gradient leaf, the losses and the parameters within 1e-4);
  18. training jamba-v0.1-52b's two-layer stack at full widths (a Mamba +
     dense layer and an attention + MoE layer, 16 experts top-2; 3.66 G
     parameters), B 2 x S 2048, 10 steps as 17: ``mamba_chunk`` 2 and
     ``mamba_chunk_bwd`` 1 a step, flash 2 and its backward 1 at D 128
     (the tensor cores), the MoE's gradient in plain PyTorch;
  18b. that stack in float32 at B 1 x S 128, as 17b but through the
     launcher's ``"train"`` step (Adafactor: AdamW's f32 moments beside
     two float32 copies of the stack do not fit);
  19. training whisper-medium at full size, phase 14's step shape (B 2,
     1,500 bf16 frames, 448 tokens), 10 steps as 17: the encoder under
     remat, the flash backward 72 times a step, at 1,500 x 1,500 and 448
     x 1,500 non-causal (24 each) and 448 causal (24);
  20. training pixtral-12b at full width cut to 4 of 40 layers (d 5120,
     32 / 8 heads of 160, d_ff 14336, vocab 131,072 untied; 2.49 G
     parameters), B 2 x (256 bf16 patch embeddings + 768 tokens), 10
     steps as 17: flash 8 and its backward 4 a step at D 160, the norm 17
     and its backward 9;
  20b. pixtral-12b at depth 2, float32, 256 patches + 32 tokens, as 17b
     (AdamW);
  20c. training gpt2-2.5b at full width cut to 2 of 54 layers (d 1920,
     20 heads of 96, tied), ``SyntheticLM`` batches of 4 x 1024, 10 steps
     as 17: flash 4 and its backward 2 a step at D 96.
  21. two ranks on the one card, spawned once for phases 21, 22 and 23
     (gloo over a file store; a 150 s limit on the group, on a rank 300 s
     for phase 21, 120 for 22 and 150 for 23; a rank that fails fails the
     run). Every collective is an all-gather over gloo, its CUDA
     payload staged through pinned host buffers and counted
     (``sharding/comm.py``); whether gloo also takes CUDA tensors itself
     is logged. (a) granite-20b at full width (d 6144, 48 heads on one KV
     head of 128) cut to 4 of 52 layers, bf16, mesh (data 1, model 2):
     layout B, each rank 512 of the 1,024 cache positions; phase 3's 8
     prompts, 32 new tokens: decode attention in its partial mode exactly
     once a layer a decode step, flash, the GEMV and the norm launched,
     one gather a layer a dispatch and no other collective, both ranks'
     tokens equal; at depth 2 in float32 the tokens, dispatches and host
     syncs of one rank's layout-A serve; then the same prompts served
     packed and with the int8 cache (``layout_b_serve``: twice each, 8
     new tokens, the second repeating the first's tokens; each rank
     writes the positions its shard owns and gathers the prefix it reads
     in one collective a layer, an int8 cache's scales with its codes, a
     packed chunk only where it has a prefix; flash in its segmented
     mode once a layer a packed chunk, decode attention once a layer a
     decode step; the collective plan; both ranks' tokens equal; the
     depth-2 float32 parity of each); (b) qwen3-moe-30b-a3b at its
     widths (128 experts, top 8, d_ff 768) cut to 4 of 48 layers,
     ``moe_impl="ep"``, 64 experts a rank: the same serve, one psum over
     'model' a MoE layer a dispatch, and at depth 2 in float32 the
     one-rank serve's tokens; (c) llama3.2-1b at full width cut to 4 of
     16 layers, bf16, ``remat="full"``, AdamW at 1e-3 on one
     ``SyntheticLM`` batch, mesh (data 2, model 1), B 2 x S 1024 a rank, 5
     steps with the plain all-reduce and 5 with ``compress_grads``: the
     plain first step's loss and gradient norm within 1e-2 of one rank's
     on the whole batch (a float32 depth-2 variant at S 64 within 1e-4),
     losses falling and equal on both ranks, 2 collectives a plain step
     (gradients, metrics) and 3 a compressed one (amaxes, the int8
     payload, a quarter of float32's bytes, metrics). Logged for each:
     ms a decode or train step, each rank's peak memory, the collectives
     and their ms (CUDA events), rank 0's busy share (a profiled serve or
     step), and the phase's seconds.
  22. the same ranks, tensor-parallel on (1, 2): (a) llama3.2-1b at full
     size served, (b) 4 of its 16 layers trained.
  23. the same ranks, tensor-parallel on (1, 2), the other families at
     full width: (a) rwkv6-7b cut to 4 of 32 layers (32 of 64 heads and
     half of d_ff a rank): a serve of 4 prompts of at most 12 tokens, 8
     new, its 2-layer training (B 1 x 2048, 3 AdamW steps: the first
     step's loss within 1e-2 of one rank's; its gradient on uniform
     tokens within 1e-2 of one rank's, on the train batch, whose stream
     falls onto one token, off float32's by at most twice one rank's bf16
     error; float32 at S 64 within 1e-4), the prefill step at B 1 x 2048;
     (b)
     jamba-v0.1-52b at one period (8 of 32; d_inner 4,096, 16 / 4 heads
     and 8 of 16 experts a rank): the same serve, the prefill step at B 2
     x 2048; (c) whisper-medium whole (8 of 16 heads, its odd vocabulary
     whole): a generate of 8 rows over 1,500 frames, the prefill step;
     (d) pixtral-12b cut to 4 of 40 (16 / 4 heads of 160): phase 3's
     serve and the prefill step with 256 patches. Each: its collectives
     exactly the plan (``tp_layer_collectives``), one rank's launches a
     step (``tp_step_launches``) and, by shape, its plan
     (``launch_shapes``: ``tp_serve_shapes`` and each run's own), the
     rank's ``local_defs`` bytes and
     share, depth-2 float32 serves equal one rank's, and the bf16 logit
     error at most twice one rank's at depth 2.

``--phases 2,12,12b,12c,14,15,16,17,18,19,20,20c,21,22,23,21-23`` (any
of them) builds the kernels and runs only the named phases (14 with 14b,
15 with 15b, 16 with 16b and 16c, 17 with 17b, 18 with 18b, 20 with 20b,
21-23 the three in one spawn; 21, 22, 23 each in its own) and
phase 13's checks of their traces, printing no result lines (a
development run).

The last two lines of standard output are the kernel table as one JSON
object (a row a kernel at its main-path shape, then flash at D 96 in both
modes, launched by phase 10b, at D 112, by phase 11c, and at D 160 in
both modes and decode attention at D 160, by phase 15, then flash's
non-causal mode at whisper's encoder and cross shapes and decode
attention at its cross cache, by phase 14, then the training path's
forward with ``lse``, flash backward and norm backward, by phase 16, the
wkv's backward by phase 17, the Mamba scan's and the flash backward at D
128 by phase 18, the flash backward at whisper's two non-causal
shapes by phase 19, the flash backward at D 96 by phase 20c and at D
160 by phase 20, and at D 112, which no path launches: 0 launches, its
``checked_calls`` those of phase 2; then decode attention's partial mode
with rank 0's launches in phase 21a's serve, flash's segmented mode at a
layout-B rank's heads with those of 21a's packed serve, the kernels at llama's
tensor-parallel shapes with the launches rank 0 counted at each shape in
phase 22a, and each kernel at phase 23's shapes with those rank 0
counted there, the Mamba scan's backward at a rank's shape with none),
then
``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when there is no CUDA device, when the port's sources are missing,
or when any phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
# dense bf16 and TF32 tensor cores, f32 CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
# exps on the special function units: 132 SMs x 16 results per clock per SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) x the 1.98 GHz boost clock of the H100 SXM data sheet
SFU_PER_S = 132 * 16 * 1.98e9
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# flash, decode_attention and pim_matvec: bf16 as (atol, rtol). Attention
# outputs are means over hundreds of keys, about 0.05 in size, so 5e-2
# would pass a kernel that drops a 64-key tile or a split of the keys, and
# a GEMV that drops a K-slice; 1e-2 + 2e-2 |want| holds bf16 rounding
# (PERF.md has the readings of the sound kernels and of broken copies)
TIGHT_TOL = {"float32": 1e-4, "bfloat16": (1e-2, 2e-2)}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #
# cycles the card spins before each timed call (about 0.5 ms)
SPIN_CYCLES = 1_000_000


def time_ms(torch, fn, iters: int = 21, warmup: int = 3) -> float:
    """Median device time of one call, each call after an L2 flush (the
    serving path finds its weights and cache cold), by CUDA events. The
    flush and a spin of ``SPIN_CYCLES`` keep the card busy while the host
    enqueues the call, so that the host's time to launch it (several
    kernels, or an autograd backward) does not enter; the median drops
    the odd call that the shared host held back."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in zip(starts, ends))[iters // 2]


# --------------------------------------------------------------------------- #
# phase 2: every kernel against its plain version
# --------------------------------------------------------------------------- #
# the norm's (mode, rows, d) on the paths: llama's prefill rows (8 slots x
# 128-token chunk) and decode rows (rmsnorm, d 2048); rwkv6-7b's
# (layernorm) and jamba's (rmsnorm) decode rows and prefill-step rows
# (B 2 x S 2048) at d 4096
# (B 2 x S 2048) at d 4096; gpt2-xl's and gpt2-2.5b's (layernorm with
# bias, d 1536 and 1920) prefill and decode rows; kimi-k2's prefill-step
# rows (B 2 x S 1024, d 7168); whisper-medium's encoder rows in its prefill
# step (B 2 x 1500 frames) and decode rows (layernorm with bias, d 1024);
# pixtral-12b's prefill-step rows (B 2 x 1024) and decode rows (rmsnorm,
# d 5120)
NORM_SHAPES = (("rmsnorm", 1024, 2048), ("rmsnorm", 8, 2048),
               ("layernorm", 8, 4096), ("rmsnorm", 8, 4096),
               ("layernorm", 4096, 4096), ("rmsnorm", 4096, 4096),
               ("layernorm", 1024, 1536), ("layernorm", 8, 1536),
               ("layernorm", 1024, 1920), ("layernorm", 8, 1920),
               ("rmsnorm", 2048, 7168), ("layernorm", 3000, 1024),
               ("layernorm", 8, 1024), ("rmsnorm", 2048, 5120),
               ("rmsnorm", 8, 5120), ("layernorm", 896, 1024),
               ("layernorm", 12000, 1024))
# the flash shapes at the reference's head dims that are no multiple of 64,
# as (B, S, cache L, offset, H, KH, D): gpt2-2.5b's prefill chunk (MHA, 20
# heads of 96), kimi-k2's prefill step (S 1024 causal, 64 / 8 heads of
# 112) and pixtral-12b's (32 / 8 heads of 160), each with a ragged chunk
WIDE_FLASH = ((8, 128, 1024, 512, 20, 20, 96), (2, 37, 300, 128, 20, 20, 96),
              (2, 1024, 1024, 0, 64, 8, 112), (2, 37, 300, 128, 64, 8, 112),
              (2, 1024, 1024, 0, 32, 8, 160), (2, 37, 300, 128, 32, 8, 160))
# the non-causal static mode, as (B, Sq, Skv, H, KH, D): whisper-medium's
# encoder (1,500 frames, 16 / 16 heads of 64) and its decoder's cross
# attention in the prefill step (448 queries against the 1,500 frames),
# and a small ragged case
NON_CAUSAL_FLASH = ((2, 1500, 1500, 16, 16, 64), (2, 448, 1500, 16, 16, 64),
                    (2, 100, 300, 16, 16, 64), (2, 1500, 1500, 8, 8, 64),
                    (2, 448, 1500, 8, 8, 64), (8, 1500, 1500, 8, 8, 64))
# the causal flash calls of phase 23's prefill steps and pixtral's serve on
# one of two tensor-parallel ranks, as (B, S, cache L, offset, H, KH, D):
# jamba's attention layer (16 / 4 heads of 128), pixtral-12b's step (256
# patches + 768 tokens) and prefill chunk (16 / 4 heads of 160), and
# whisper-medium's decoder (448 tokens, 8 / 8 heads of 64)
FAMILY_TP2_FLASH = ((2, 2048, 2048, 0, 16, 4, 128),
                    (2, 1024, 1024, 0, 16, 4, 160),
                    (8, 128, 1024, 512, 16, 4, 160),
                    (2, 448, 448, 0, 8, 8, 64))
# a layout-B rank's heads (H, KH, D): phase 21a's granite-20b, 48 query
# heads split over two ranks, on its one KV head of 128
LAYOUT_B_HEADS = (24, 1, 128)
# the flash backward, as (B, S, Skv, H, KH, D, causal): llama3.2-1b's
# training shape (phase 16's batch of 4 x 1024), a ragged S, jamba's
# attention layer in phase 18 (B 2 x S 2048, 32 / 8 heads of 128), the
# non-causal mode at G 1: whisper-medium's encoder shape and its decoder's
# cross attention (448 queries against the 1,500 frames); the reduced
# llama that phase 16c trains (batch 8 x 64, 4 / 2 heads of 16), and a
# ragged S (two 128-key CTAs and one key more than a 64-row tile) at G 8
# and head dim 32, so that each head dim of the tensor-core route is held;
# the head dims above 64 that are no multiple of it, at the shapes their
# configs train or step at: gpt2-2.5b's (phase 20c, 20 heads of 96),
# kimi-k2's (phase 11c's step, 64 / 8 heads of 112), pixtral-12b's (phase
# 20, 32 / 8 heads of 160) and a ragged S at D 160
FLASH_BWD = ((4, 1024, 1024, 32, 8, 64, True),
             (4, 1000, 1000, 32, 8, 64, True),
             (2, 2048, 2048, 32, 8, 128, True),
             (2, 1500, 1500, 16, 16, 64, False),
             (2, 448, 1500, 16, 16, 64, False),
             (8, 64, 64, 4, 2, 16, True),
             (2, 321, 321, 64, 8, 32, True),
             (4, 1024, 1024, 20, 20, 96, True),
             (2, 1024, 1024, 64, 8, 112, True),
             (2, 1024, 1024, 32, 8, 160, True),
             (1, 1000, 1000, 32, 8, 160, True))
# the norm backward, as (mode, rows, d): llama's training rows (4 x 1024)
# and a ragged row count, in each mode
# the wkv backward, as (BH, T, K, U, strong decays, with dS_T): rwkv6-7b's
# training call in phase 17 (B 2 x 64 heads of 64, S 2048, u (H, K)
# broadcast over the batch, no gradient of S_T), a ragged last sub-chunk
# with dS_T, U < BH at K 16 and T 37, the model's strong decays, and
# phase 23a's training call on one of two tensor-parallel ranks (B 1 x 32
# heads)
RWKV_BWD = ((128, 2048, 64, 64, False, False), (4, 200, 64, 4, False, True),
            (6, 37, 16, 3, False, True), (16, 512, 64, 16, True, False),
            (32, 2048, 64, 32, False, False))
# the Mamba scan's backward, as (B, T, d_inner, d_state, with dh_T): jamba's
# training call in phase 18 (B 2 x S 2048), a ragged last checkpoint with
# dh_T at full width, and the reduced widths at a ragged T; then jamba's
# B 2 x S 2048 on one of two tensor-parallel ranks (d_inner 4,096)
MAMBA_BWD = ((2, 2048, 8192, 16, False), (1, 200, 8192, 16, True),
             (2, 37, 128, 4, True), (2, 37, 100, 5, False),
             (2, 2048, 4096, 16, False))
NORM_BWD_SHAPES = tuple((m, r, 2048) for m in ("rmsnorm", "layernorm",
                                               "np_layernorm")
                        for r in (4096, 1027))


def partial_flat(torch, out):
    """The partial mode's (o, lse) as one float tensor, lse's -inf (a row
    of length 0) as -1e30 so that equal answers subtract to 0."""
    o, lse = out
    return torch.cat([o.float().flatten(),
                      torch.nan_to_num(lse, neginf=-1e30).flatten()])


def efficient_attention_lse(torch, q, k, v, lengths):
    """The library call for the partial mode: PyTorch's memory-efficient
    attention with its log-sum-exp, the key mask as an additive bias and
    the KV head expanded to the query heads; None (logged) where it
    refuses the shape."""
    B, H, D = q.shape
    L = k.shape[2]
    bias = torch.where(torch.arange(L, device="cuda")[None, :]
                       < lengths[:, None], 0.0, float("-inf")).to(q.dtype)
    bias = bias[:, None, None, :].expand(B, H, 1, L)
    kx = k.expand(B, H, L, D)
    vx = v.expand(B, H, L, D)

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q[:, :, None], kx, vx, bias, True)
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"the partial mode's library call refused: {str(e)[:160]}")
        return None
    return call


def kernel_cases(torch, dtype):
    """(kernel, label, kernel call, plain call, library call, bytes, flops)
    at the serving path's full-width shapes and ragged ones."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention import plan as decode_plan
    from repro_torch.kernels.decode_attention import share as decode_share
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_segmented)
    from repro_torch.kernels.layernorm import layernorm
    from repro_torch.kernels.mamba_chunk import CK as MAMBA_CK
    from repro_torch.kernels.mamba_chunk import mamba_chunk
    from repro_torch.kernels.masked_softmax import masked_softmax
    from repro_torch.kernels.pim_matvec import pim_matvec

    g = torch.Generator(device="cuda").manual_seed(1)
    es = torch.finfo(dtype).bits // 8

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    H, KH, D, d, f = 32, 8, 64, 2048, 8192
    cases = []
    # flash: (B, chunk S, cache L, offset, heads, KV heads, head dim) --
    # llama's prefill chunks (the third overhangs L), jamba's prefill step
    # (S 2048 from 0, hd 128; its yardstick SDPA with is_causal, the same
    # mask), llama's training shape (B 4, S 1024: the forward without the
    # lse that phase 16 writes), llama's prefill chunk on one of two
    # tensor-parallel ranks (16 / 4 heads, phase 22a), and WIDE_FLASH
    for B, S, L, off, h, kh, hd in ((8, 128, 1024, 512, H, KH, D),
                                    (8, 128, 1024, 512, H // 2, KH // 2, D),
                                    (4, 128, 300, 256, H, KH, D),
                                    (2, 37, 300, 128, H, KH, D),
                                    (2, 2048, 2048, 0, H, KH, 128),
                                    (4, 1024, 1024, 0, H, KH, D)) \
            + WIDE_FLASH + FAMILY_TP2_FLASH:
        q = rn(B, h, S, hd)
        kc, vc = rn(B, kh, L, hd), rn(B, kh, L, hd)
        span = min(off + S, L)
        k, v = kc[:, :, :span], vc[:, :, :span]
        pos_q = off + torch.arange(S, device="cuda")
        mask = pos_q[:, None] >= torch.arange(span, device="cuda")[None, :]
        pairs = sum(min(span, off + r + 1) for r in range(S))
        library = (
            (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)) if off == 0
            and span == S else
            (lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True)))
        cases.append(dict(
            kernel="flash_attention", tol=TIGHT_TOL,
            label=f"B{B} S{S} span{span} off{off}" + heads_label(h, kh, hd),
            run=lambda q=q, k=k, v=v, off=off: flash_attention(
                q, k, v, causal=True, q_offset=off),
            plain=lambda q=q, k=k, v=v, off=off: ref.flash_attention_ref(
                q, k, v, causal=True, q_offset=off),
            library=library,
            bytes=(2 * q.numel() + 2 * B * kh * span * hd) * es,
            flops=4.0 * B * h * pairs * hd))
    # non-causal flash, beside SDPA without a mask; the plain version with
    # the second 64-key tile dropped must fail the tolerance (the bound
    # sees a lost tile at 1,500 keys too)
    for B, Sq, Skv, h, kh, hd in NON_CAUSAL_FLASH:
        q = rn(B, h, Sq, hd)
        k, v = rn(B, kh, Skv, hd), rn(B, kh, Skv, hd)
        kept = torch.cat([torch.arange(64), torch.arange(128, Skv)]).cuda()
        cases.append(dict(
            kernel="flash_attention", tol=TIGHT_TOL,
            label=f"B{B} Sq{Sq} Skv{Skv} non-causal"
            + heads_label(h, kh, hd),
            run=lambda q=q, k=k, v=v: flash_attention(q, k, v, causal=False),
            plain=lambda q=q, k=k, v=v: ref.flash_attention_ref(
                q, k, v, causal=False),
            broken=lambda q=q, k=k, v=v, i=kept: ref.flash_attention_ref(
                q, k[:, :, i], v[:, :, i], causal=False),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True),
            bytes=(2 * q.numel() + 2 * B * kh * Skv * hd) * es,
            flops=4.0 * B * h * Sq * Skv * hd))
    # segmented flash: the packed layouts the planner gives -- the packed
    # serve's widest dispatch (phase 3b's prompts), and a ragged one with
    # padding columns, lanes without a prefix and Skv off the 32-key tile;
    # both at llama's heads and at WIDE_FLASH's; and the widest dispatch
    # at a layout-B rank's heads (phase 21a's packed granite-20b: 24 of
    # 48 query heads on its one KV head of 128, over the 512 prefix rows
    # gathered from both shards), bitwise over two calls
    layouts = (([len(p) for p in serve_prompts(2)], 128),
               ((80, 30, 12, 9, 3), 37))
    heads = ((H, KH, D), (20, 20, 96), (64, 8, 112), (32, 8, 160))
    for (h, kh, hd), (plens, C) in list(itertools.product(heads, layouts)) \
            + [(LAYOUT_B_HEADS, layouts[0])]:
        info, R, span = packed_layout(torch, plens, C)
        Skv = span + C
        q = rn(R, h, C, hd)
        k, v = rn(R, kh, Skv, hd), rn(R, kh, Skv, hd)
        mask = ((info[1][:, :, None] == info[3][:, None, :])
                & (info[0][:, :, None] >= info[2][:, None, :]))
        rows = (info[1] >= 0)[:, None, :, None].expand(R, h, C, hd)
        cases.append(dict(
            kernel="flash_attention_segmented", tol=TIGHT_TOL,
            label=f"R{R} C{C} span{span}" + heads_label(h, kh, hd),
            rows=rows, deterministic=(h, kh, hd) == LAYOUT_B_HEADS,
            run=lambda q=q, k=k, v=v, i=info: flash_attention_segmented(
                q, k, v, i),
            plain=lambda q=q, k=k, v=v, i=info: ref.segment_attention_ref(
                q, k, v, *i),
            library=lambda q=q, k=k, v=v, m=mask[:, None]:
                F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                               enable_gqa=True),
            bytes=(2 * q.numel() + 2 * R * kh * Skv * hd) * es
            + 4 * 2 * R * (C + Skv),
            flops=4.0 * h * hd * float(mask.sum())))
    # decode: llama's cache (lengths of 1 and off every tile) and a ragged
    # one; jamba's (head dim 128, max_len 256, lengths off every tile);
    # whisper-medium's cross cache (16 / 16 heads, every length the 1,500
    # frames), pixtral-12b's cache (32 / 8 heads of 160) and llama's on
    # one of two tensor-parallel ranks (16 / 4 heads, phase 22a)
    for B, L, lens, h, kh, hd in (
            (8, 1024, (1, 77, 700, 1023, 1024, 5, 333, 512), H, KH, D),
            (8, 1024, (1, 77, 700, 1023, 1024, 5, 333, 512), H // 2,
             KH // 2, D),
            (3, 300, (1, 299, 130), H, KH, D),
            (8, 256, (3, 67, 130, 200, 255, 19, 101, 250), H, KH, 128),
            (8, 1500, (1500,) * 8, 16, 16, D),
            (8, 1024, (1, 77, 700, 1023, 1024, 5, 333, 512), 32, 8, 160),
            # phase 23 on one of two tensor-parallel ranks: whisper's
            # cross and self caches (8 / 8 heads), jamba's (16 / 4 of 128,
            # the mesh serve's max_len 1024) and pixtral's (16 / 4 of 160)
            (8, 1500, (1500,) * 8, 8, 8, D),
            (8, 448, (1, 8, 9, 24, 63, 64, 65, 448), 8, 8, D),
            (8, 1024, (1, 64, 65, 341, 342, 700, 1023, 1024), 16, 4, 128),
            (8, 1024, (1, 77, 700, 1023, 1024, 5, 333, 512), 16, 4, 160)):
        q, k, v = rn(B, h, hd), rn(B, kh, L, hd), rn(B, kh, L, hd)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        mask = (torch.arange(L, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        cases.append(dict(
            kernel="decode_attention", tol=TIGHT_TOL, deterministic=True,
            label=f"B{B} L{L}" + heads_label(h, kh, hd),
            run=lambda q=q, k=k, v=v, n=lengths: decode_attention(q, k, v, n),
            plain=lambda q=q, k=k, v=v, n=lengths:
                ref.decode_attention_ref(q, k, v, n),
            library=lambda q=q, k=k, v=v, m=mask:
                F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=m, enable_gqa=True),
            bytes=(2 * q.numel() + 2 * kh * hd * sum(lens)) * es + 4 * B,
            flops=4.0 * h * hd * sum(lens)))
    # decode's partial mode (a layout-B shard, phase 21a's granite-20b:
    # 48 heads on one KV head of 128, the 512 positions of one shard of a
    # 1,024 cache), at lengths in the shard of 0, 1, 63, 64, 65, 511, 512
    # and 300: o held as above, the lse to 1e-4 (f32) and 1e-3 (bf16) and
    # -inf exactly where the length is 0; the plain version with the keys
    # of the second split dropped must fail the bound
    B, L, h, kh, hd = 8, 512, 48, 1, 128
    lens = (0, 1, 63, 64, 65, 511, 512, 300)
    q, k, v = rn(B, h, hd), rn(B, kh, L, hd), rn(B, kh, L, hd)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    lo, hi = decode_share(L, 1, decode_plan(B, h, kh, L))
    kept = torch.cat([torch.arange(lo), torch.arange(hi, L)]).cuda()
    cut = torch.where(lengths > hi, lengths - (hi - lo),
                      torch.clamp(lengths, max=lo)).to(torch.int32)
    lse_tol = {"float32": 1e-4, "bfloat16": 1e-3}
    cases.append(dict(
        kernel="decode_attention", tol=TIGHT_TOL, deterministic=True,
        label=f"B{B} L{L}" + heads_label(h, kh, hd) + " partial",
        run=lambda q=q, k=k, v=v, n=lengths: partial_flat(
            torch, decode_attention(q, k, v, n, return_lse=True)),
        plain=lambda q=q, k=k, v=v, n=lengths: partial_flat(
            torch, ref.decode_attention_ref(q, k, v, n, return_lse=True)),
        broken=lambda q=q, k=k, v=v, i=kept, n=cut: partial_flat(
            torch, ref.decode_attention_ref(q, k[:, :, i], v[:, :, i], n,
                                            return_lse=True)),
        limit=lambda want, dname, n=q.numel(): torch.cat([
            TIGHT_TOL[dname][0] + TIGHT_TOL[dname][1] * want[:n].abs()
            if dname == "bfloat16" else torch.full_like(want[:n], 1e-4),
            torch.full_like(want[n:], lse_tol[dname])]),
        library=efficient_attention_lse(torch, q, k, v, lengths),
        bytes=(2 * q.numel() + 2 * kh * hd * sum(lens)) * es + 4 * B
        + 4 * B * h,
        flops=4.0 * h * hd * sum(lens)))
    # matvec: llama's decode FCs -- wg/wi (d -> f), wo of the MLP (f -> d),
    # wq/wo of attention (d -> d), wk/wv (d -> KH*D) -- at n in {1, 3, 8}
    # slot rows; then rwkv6-7b's (4096 -> 4096, 4096 -> 14336, 14336 ->
    # 4096) and jamba-v0.1-52b's (4096 -> 8192, 8192 -> 4096, 4096 -> 1024);
    # gpt2-xl's and gpt2-2.5b's (d -> d for q, k, v and o; d -> 4d gelu and
    # 4d -> d, the non-gated MLP), qwen3-moe-30b-a3b's k and v (2048 ->
    # 256), whisper-medium's (1024 -> 1024 for q, k, v, o and the cross
    # attention's q and o; 1024 -> 4096 gelu, 4096 -> 1024) and
    # pixtral-12b's (5120 -> 5120 for q and o, 5120 -> 1280 for k and v,
    # 5120 -> 14336 silu, 14336 -> 5120), and llama's on one of two
    # tensor-parallel ranks (phase 22a: q d -> d/2, k and v d -> 256 as
    # qwen3-moe's, the row-parallel o d/2 -> d, wg and wi d -> f/2, wo
    # f/2 -> d), at the 8 rows the engine decodes
    shapes = [(n, d, f, "silu") for n in (1, 3, 8)] \
        + [(n, f, d, "none") for n in (1, 3, 8)] \
        + [(8, d, d, "none"), (8, d, KH * D, "none")] \
        + [(8, 4096, 4096, "none"), (8, 4096, 14336, "silu"),
           (8, 14336, 4096, "none"), (8, 4096, 8192, "none"),
           (8, 8192, 4096, "none"), (8, 4096, 1024, "none")] \
        + [s for dm in (1536, 1920) for s in (
            (8, dm, dm, "none"), (8, dm, 4 * dm, "gelu"),
            (8, 4 * dm, dm, "none"))] + [(8, d, 256, "none")] \
        + [(8, 1024, 1024, "none"), (8, 1024, 4096, "gelu"),
           (8, 4096, 1024, "none"), (8, 5120, 5120, "none"),
           (8, 5120, 1280, "none"), (8, 5120, 14336, "silu"),
           (8, 14336, 5120, "none")] \
        + [(8, d, d // 2, "none"), (8, d // 2, d, "none"),
           (8, d, f // 2, "silu"), (8, d, f // 2, "none"),
           (8, f // 2, d, "none")]
    # and phase 23's: each family's decode FCs on one of two
    # tensor-parallel ranks (``tp_gemv_plan``), those not already above
    for label in family_tp2_gemv():
        n_, dims, act = label.split()
        shape = (int(n_[1:]), *map(int, dims.split("->")), act)
        if shape not in shapes:
            shapes.append(shape)
    for n, din, dout, act in shapes:
        x, w = rn(n, din), rn(din, dout, scale=din ** -0.5)
        lib_act = {"silu": F.silu, "none": lambda t: t,
                   "gelu": lambda t: F.gelu(t, approximate="tanh")}[act]
        cases.append(dict(
            kernel="pim_matvec", label=f"n{n} {din}->{dout} {act}",
            tol=TIGHT_TOL, deterministic=True,
            run=lambda x=x, w=w, a=act: pim_matvec(x, w, None, a),
            plain=lambda x=x, w=w, a=act: ref.matvec_ref(x, w, None, a),
            library=lambda x=x, w=w, a=lib_act: a(torch.matmul(x, w)),
            bytes=(x.numel() + w.numel() + n * dout) * es,
            flops=2.0 * n * din * dout))
    # rwkv_chunk: the full-sequence prefill step's call as rwkv_time_mix
    # makes it (B 2 x H 64 heads of 64, T 2048; u (H, K) broadcast over the
    # batch; y in f32), B 1 on one of two tensor-parallel ranks (32 heads:
    # phase 23a's prefill step and training), a ragged T with u per row
    # and y in r's dtype, a narrow head, and the model's strong decays;
    # r, k, v in the case's
    # dtype, decays in f32: exp(-exp(w0)) with w0 = log U(1e-3, 1) (many
    # near 1), or ("strong") w0 over ssm.py's clamp [-10, 4], down to about
    # 2e-24 a step. f32 takes the CUDA cores, bf16 the tensor-core route:
    # both held to the reference's 2e-3 for the chunked form where y is in
    # f32 (the model's call), bf16 y to the bound of the other tensor-core
    # kernels
    for BH, T_, K, U, y_dtype, strong in (
            (128, 2048, 64, 64, torch.float32, False),
            (32, 2048, 64, 32, torch.float32, False),
            (4, 200, 64, 4, None, False), (6, 37, 16, 6, None, False),
            (16, 512, 64, 16, torch.float32, True)):
        r, k, v = (rn(BH, T_, K, scale=0.5) for _ in range(3))
        w0 = (torch.rand((BH, T_, K), generator=g, device="cuda") * 14 - 10
              if strong else
              torch.log(torch.rand((BH, T_, K), generator=g, device="cuda")
                        * (1 - 1e-3) + 1e-3))
        w = torch.exp(-torch.exp(w0))
        u = torch.randn((U, K), generator=g, device="cuda") * 0.1
        u_rows = u.repeat(BH // U, 1)       # u per row for the plain version
        flops, exps = rwkv_operations(BH, T_, K)
        ys = 4 if y_dtype == torch.float32 else es
        cases.append(dict(
            kernel="rwkv_chunk", deterministic=True,
            label=f"BH{BH} T{T_} K{K}" + (" strong" if strong else ""),
            tol={"float32": 2e-3, "bfloat16": (2e-3, 2e-3)
                 if y_dtype == torch.float32 else TIGHT_TOL["bfloat16"]},
            run=lambda r=r, k=k, v=v, w=w, u=u, o=y_dtype: ops.rwkv_chunk(
                r, k, v, w, u, out_dtype=o),
            plain=lambda r=r, k=k, v=v, w=w, u=u_rows, o=y_dtype:
                ref.rwkv_chunk_ref(r, k, v, w, u, out_dtype=o),
            library=None, exps=exps,
            math="tfloat32" if dtype == torch.bfloat16 else "float32",
            bytes=BH * T_ * K * (3 * es + 4 + ys) + 4 * U * K
            + 4 * BH * K * K,
            flops=flops))
    # mamba_chunk: the full-sequence prefill step's call as mamba_mix makes
    # it (B 2, T 2048, d_inner 8192, d_state 16; a, u and C in f32 whatever
    # the model's dtype), a ragged T, the reduced config's widths, and the
    # step's call on one of two tensor-parallel ranks (d_inner 4,096,
    # phase 23b); the model's discretization (a = exp(dt A), u = dt x B).
    # Timed in f32.
    # Under a gradient the kernel also writes h before every 16 steps, the
    # checkpoints of mamba_chunk_bwd ("ck"): held against h of the plain
    # recurrence at those steps (mamba_checkpoints_ref), and timed beside
    # the serving call that writes none
    for B, T_, di, n in ((2, 2048, 8192, 16), (1, 200, 8192, 16),
                         (2, 37, 128, 4), (2, 2048, 4096, 16)):
        if dtype == torch.bfloat16 and T_ == 2048:
            continue              # the bf16 instantiation: the small cases
        a, u, C = mamba_inputs(torch, g, B, T_, di, n, dtype)
        moved = es * (2 * B * T_ * di * n + B * T_ * n + B * T_ * di) \
            + 4 * B * di * n
        cases.append(dict(
            kernel="mamba_chunk", label=f"B{B} T{T_} d{di} n{n}",
            run=lambda a=a, u=u, C=C: ops.mamba_chunk(a, u, C),
            plain=lambda a=a, u=u, C=C: ref.mamba_chunk_ref(a, u, C),
            library=None, math="float32", timed="float32",
            bytes=moved, flops=4.0 * B * T_ * di * n))
        cases.append(dict(
            kernel="mamba_chunk", label=f"B{B} T{T_} d{di} n{n} ck",
            deterministic=True,
            run=lambda a=a, u=u, C=C: mamba_chunk(a, u, C, checkpoints=True),
            plain=lambda a=a, u=u, C=C: (
                *ref.mamba_chunk_ref(a, u, C),
                ref.mamba_checkpoints_ref(a, u, MAMBA_CK)),
            library=None, math="float32", timed="float32",
            bytes=moved + 4 * B * -(-T_ // MAMBA_CK) * di * n,
            flops=4.0 * B * T_ * di * n))
    # masked_softmax: the scores of a llama prefill chunk (8 slots x 32
    # heads x 128 queries against 640 keys at offset 512: the causal
    # bitmap with random holes), and rows of 4096 with fully masked ones
    for rows, n, dead in ((8 * 32 * 128, 640, 0), (999, 4096, 3)):
        x = rn(rows, n, scale=3.0)
        keep = softmax_mask(torch, g, rows, n, dead)
        xm = x.masked_fill(~keep, float("-inf"))
        cases.append(dict(
            kernel="masked_softmax",
            label=f"rows{rows} n{n}" + (f" ({dead} fully masked)"
                                        if dead else ""),
            run=lambda x=x, m=keep: masked_softmax(x, m),
            plain=lambda x=x, m=keep: ref.masked_softmax_ref(x, m),
            library=lambda xm=xm: torch.softmax(xm, dim=-1),
            check=lambda got, m=keep: softmax_invariants(torch, got, m),
            math="float32",
            bytes=rows * n * (2 * es + 1), flops=5.0 * rows * n))
    # norm: every shape the paths launch (NORM_SHAPES), beside F.rms_norm
    # or F.layer_norm
    for mode, rows, dn in NORM_SHAPES:
        x, s, b = rn(rows, dn, scale=3.0), rn(dn), rn(dn)
        b = b if mode == "layernorm" else None
        library = (
            (lambda x=x, s=s, dn=dn: F.rms_norm(x, (dn,), s, 1e-6))
            if mode == "rmsnorm" else
            (lambda x=x, s=s, b=b, dn=dn: F.layer_norm(x, (dn,), s, b, 1e-5)))
        cases.append(dict(
            kernel="layernorm", label=f"{mode} rows{rows} d{dn}",
            run=lambda x=x, s=s, b=b, m=mode: layernorm(x, s, b, mode=m),
            plain=lambda x=x, s=s, b=b, m=mode: ref.norm_ref(x, s, b,
                                                             mode=m),
            library=library,
            bytes=(2 * x.numel() + dn * (1 if b is None else 2)) * es,
            flops=(4.0 if b is None else 7.0) * rows * dn))
    return cases + training_cases(torch, dtype, rn)


def training_cases(torch, dtype, rn):
    """Phase 2's cases of the training path: the static flash mode with
    its lse at llama's training shape; the flash backward (from the
    kernel forward's o and lse: the same inputs for the kernel and the
    plain version) at ``FLASH_BWD``'s shapes; the norm backward at
    ``NORM_BWD_SHAPES``. The library calls are autograd backwards of
    SDPA (its K and V repeated to the query heads outside the timed call)
    and of ``F.rms_norm`` / ``F.layer_norm``, each on a graph built once."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    from repro_torch.kernels.layernorm import layernorm_bwd

    es = torch.finfo(dtype).bits // 8
    cases = []
    B, S, _, H, KH, D = FLASH_BWD[0][:6]
    q, k, v = rn(B, H, S, D), rn(B, KH, S, D), rn(B, KH, S, D)
    pairs = B * H * S * (S + 1) // 2
    cases.append(dict(
        kernel="flash_attention", tol=TIGHT_TOL,
        label=f"B{B} S{S} span{S} off0 lse",
        run=lambda q=q, k=k, v=v: flash_attention(q, k, v, causal=True,
                                                  return_lse=True),
        plain=lambda q=q, k=k, v=v: ref.flash_attention_ref(
            q, k, v, causal=True, return_lse=True),
        library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        bytes=(2 * q.numel() + 2 * k.numel()) * es + 4 * B * H * S,
        flops=4.0 * pairs * D))
    for B, S, Skv, H, KH, D, causal in FLASH_BWD:
        q, k, v = rn(B, H, S, D), rn(B, KH, Skv, D), rn(B, KH, Skv, D)
        do = rn(B, H, S, D)
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        lib_in = [t.detach().clone().requires_grad_() for t in (
            q, k.repeat_interleave(H // KH, 1),
            v.repeat_interleave(H // KH, 1))]
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=causal)
        pairs = B * H * (S * (S + 1) // 2 if causal else S * Skv)

        def dropped(q=q, k=k, v=v, o=o, lse=lse, do=do, c=causal,
                    lo=64 if Skv > 64 else 0):
            # a kernel that lost keys 64-127 (0-63 where they are all) in
            # its KV pass
            dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, c)
            dk[:, :, lo:lo + 64], dv[:, :, lo:lo + 64] = 0, 0
            return dq, dk, dv
        cases.append(dict(
            kernel="flash_attention_bwd", tol=TIGHT_TOL, deterministic=True,
            label=(f"B{B} S{S}" if S == Skv else f"B{B} Sq{S} Skv{Skv}")
            + ("" if causal else " non-causal") + heads_label(H, KH, D),
            run=lambda a=(q, k, v, o, lse, do), c=causal: flash_attention_bwd(
                *a, causal=c),
            plain=lambda a=(q, k, v, o, lse, do), c=causal:
                ref.flash_attention_bwd_ref(*a, causal=c),
            broken=dropped,
            library=lambda y=lib_out, x=lib_in, g=do: torch.autograd.grad(
                y, x, g, retain_graph=True),
            bytes=(4 * q.numel() + 4 * k.numel()) * es + 4 * B * H * S,
            flops=10.0 * pairs * D))
    for mode, rows, dn in NORM_BWD_SHAPES:
        x, dy = rn(rows, dn, scale=3.0), rn(rows, dn)
        s = rn(dn) if mode != "np_layernorm" else None
        b = rn(dn) if mode == "layernorm" else None
        lib_in = [t.detach().clone().requires_grad_() for t in (x, s, b)
                  if t is not None]
        lib_out = (F.rms_norm(lib_in[0], (dn,), lib_in[1], 1e-6)
                   if mode == "rmsnorm" else
                   F.layer_norm(lib_in[0], (dn,), s if s is None
                                else lib_in[1], b if b is None
                                else lib_in[2], 1e-5))
        n_affine = len(lib_in) - 1
        cases.append(dict(
            kernel="layernorm_bwd", label=f"{mode} rows{rows} d{dn}",
            deterministic=True,
            run=lambda x=x, s=s, b=b, dy=dy, m=mode: tuple(
                t for t in layernorm_bwd(x, s, b, dy, mode=m)
                if t is not None),
            plain=lambda x=x, s=s, b=b, dy=dy, m=mode: tuple(
                t for t in ref.norm_bwd_ref(x, s, b, dy, mode=m)
                if t is not None),
            library=lambda y=lib_out, i=lib_in, g=dy: torch.autograd.grad(
                y, i, g, retain_graph=True),
            bytes=(3 * x.numel() + 2 * n_affine * dn) * es,
            flops=10.0 * rows * dn))
    return cases + recurrent_bwd_cases(torch, dtype, rn)


def recurrent_bwd_cases(torch, dtype, rn):
    """Phase 2's cases of the recurrences' backward kernels against their
    plain adjoint recurrences, bitwise over two calls: the wkv's at
    ``RWKV_BWD`` (r, k, v in the case's dtype, w, u and dy in f32 as the
    model gives them; the decays as ``kernel_cases``' wkv makes them), the
    Mamba scan's at ``MAMBA_BWD`` (a, u, C as ``mamba_inputs`` makes them,
    dy in their dtype; timed in float32, the model's call, and bf16 only
    at the small shapes). f32 within the chunked wkv's 2e-3, bf16 within
    1e-2 + 2e-2 |want|. No single PyTorch call computes either gradient,
    so there is no library column. Operations: 14 flops an element of
    the wkv's state a step (state and G advanced, 3 each; S dy, G v, G^T
    k, G * S, 2 each), 8 an element of the scan's a step."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_chunk import mamba_chunk
    from repro_torch.kernels.mamba_chunk_bwd import mamba_chunk_bwd
    from repro_torch.kernels.rwkv_chunk_bwd import rwkv_chunk_bwd

    g = torch.Generator(device="cuda").manual_seed(3)
    es = torch.finfo(dtype).bits // 8
    cases = []
    tol = {"float32": 2e-3, "bfloat16": TIGHT_TOL["bfloat16"]}
    for BH, T_, K, U, strong, final in RWKV_BWD:
        r, k, v = (rn(BH, T_, K, scale=0.5) for _ in range(3))
        w0 = (torch.rand((BH, T_, K), generator=g, device="cuda") * 14 - 10
              if strong else
              torch.log(torch.rand((BH, T_, K), generator=g, device="cuda")
                        * (1 - 1e-3) + 1e-3))
        w = torch.exp(-torch.exp(w0))
        u = torch.randn((U, K), generator=g, device="cuda") * 0.1
        dy = torch.randn((BH, T_, K), generator=g, device="cuda")
        ds = torch.randn((BH, K, K), generator=g, device="cuda") \
            if final else None
        args = (r, k, v, w, u, dy, ds)
        cases.append(dict(
            kernel="rwkv_chunk_bwd", deterministic=True, tol=tol,
            label=f"BH{BH} T{T_} K{K}"
            + ("" if (BH, U) == (128, 64) else f" U{U}")
            + (" strong" if strong else "") + (" dS" if final else ""),
            run=lambda a=args: rwkv_chunk_bwd(*a),
            plain=lambda a=args: ref.rwkv_chunk_bwd_ref(*a),
            library=None, math="float32",
            bytes=BH * T_ * K * (6 * es + 12) + 8 * U * K
            + (4 * BH * K * K if final else 0),
            flops=14.0 * BH * T_ * K * K))
    for B, T_, di, n, final in MAMBA_BWD:
        if dtype == torch.bfloat16 and T_ == 2048:
            continue              # the bf16 instantiation: the small cases
        a, u, C = mamba_inputs(torch, g, B, T_, di, n, dtype)
        dy = torch.randn((B, T_, di), generator=g, device="cuda").to(dtype)
        dh = torch.randn((B, di, n), generator=g, device="cuda") \
            if final else None
        args = (a, u, C, dy, dh)
        # the checkpoints as the training path makes them: by the forward
        # kernel (phase 2 holds them against the plain recurrence)
        _, _, ck = mamba_chunk(a, u, C, checkpoints=True)
        cases.append(dict(
            kernel="mamba_chunk_bwd", deterministic=True, tol=tol,
            label=f"B{B} T{T_} d{di} n{n}" + (" dh" if final else ""),
            run=lambda a=args, ck=ck: mamba_chunk_bwd(*a, ck=ck),
            plain=lambda a=args: ref.mamba_chunk_bwd_ref(*a),
            library=None, math="float32", timed="float32",
            bytes=es * (4 * B * T_ * di * n + 2 * B * T_ * n + B * T_ * di)
            + (4 * B * di * n if final else 0),
            flops=8.0 * B * T_ * di * n))
    return cases


def heads_label(h: int, kh: int, hd: int) -> str:
    """A flash case's label suffix where its heads differ from llama's (H
    32, KH 8, D 64)."""
    return ("" if hd == 64 else f" D{hd}") \
        + ("" if (h, kh) == (32, 8) else f" H{h}/{kh}")


def timing_floor(torch) -> dict:
    """What ``time_ms`` gives for no work and for pure data movement: an
    empty Triton kernel (launch alone, after the L2 flush), and a device
    copy of llama's prefill-chunk rows (1024 x 2048 bf16, the norm's
    bytes): the floor under the norm kernel at that shape."""
    import triton

    @triton.jit
    def empty_kernel(x_ptr):
        pass

    x = torch.zeros((1024, 2048), dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    return dict(empty_triton_ms=time_ms(torch, lambda: empty_kernel[(1,)](x)),
                copy_ms=time_ms(torch, lambda: out.copy_(x)),
                shape="rows1024 d2048 bf16")


def mamba_inputs(torch, g, B, T, d, n, dtype):
    """a, u, C as ``mamba_mix`` makes them from random activations: dt =
    softplus(.), A = -exp(a_log) with the model's ``"decay"`` init (so a =
    exp(dt A) lies in (0, 1), much of it near 1), u = dt x B."""
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, d), generator=g, device="cuda") - 2)
    A = 1.0 / (torch.rand((d, n), generator=g, device="cuda") * (1 - 1e-3)
               + 1e-3)
    a = (dt[..., None] * -A).exp_()
    u = (dt * torch.randn((B, T, d), generator=g, device="cuda"))[..., None] \
        * (torch.randn((B, T, 1, n), generator=g, device="cuda") * 0.1)
    C = torch.randn((B, T, n), generator=g, device="cuda")
    return a.to(dtype), u.to(dtype), C.to(dtype)


def rwkv_operations(BH: int, T: int, K: int):
    """(FLOPs, exps) of the chunked wkv for these shapes, for any
    implementation: the sub-chunked form's work at the port's chunk and
    sub-chunk (``kernels/rwkv_chunk.py``). Per chunk of n valid steps, in
    sub-chunks of m_I: exps -- the pairwise decay ratios of the diagonal
    triangles (m_I (m_I - 1) / 2 per channel), two decays per (step,
    channel) (r to the chunk's start, k to its end), one log per (step,
    channel), and the off-diagonal factors (k of each sub-chunk but the
    last to its end, r of each later row to each earlier sub-chunk's
    end); FLOPs (2 per multiply-add) -- the diagonal triangles (3 per
    pair and channel), the off-diagonal blocks, the bonus, (r Q) S0, the
    triangle of A v, the state advance and the decays' multiplies."""
    from repro_torch.kernels.rwkv_chunk import CHUNK, SUB
    flops = exps = 0
    for t0 in range(0, T, CHUNK):
        n = min(CHUNK, T - t0)
        subs = [min(SUB, n - s0) for s0 in range(0, n, SUB)]
        tri = sum(m * (m - 1) // 2 for m in subs)
        off = sum(subs[I] * subs[J] for I in range(len(subs))
                  for J in range(I))
        ends = [min(s0 + SUB, n) for s0 in range(0, n, SUB)]
        exps += K * (tri + 3 * n + sum(subs[:-1])
                     + sum(n - e for e in ends[:-1]))
        flops += 3 * tri * K + 2 * off * K + 3 * n * K + 2 * n * K * K \
            + 2 * K * n * (n + 1) // 2 + 2 * K * K * n + 4 * n * K
    return float(BH * flops), float(BH * exps)


def softmax_mask(torch, g, rows: int, n: int, dead: int):
    """A causal bitmap over rows of queries (query i sees keys up to
    offset + i, offset n - 128) with 10 % random holes; ``dead`` rows
    fully masked."""
    q = torch.arange(rows, device="cuda")[:, None] % 128 + (n - 128)
    keep = (torch.arange(n, device="cuda")[None, :] <= q) \
        & (torch.rand((rows, n), generator=g, device="cuda") > 0.1)
    keep[:, 0] = True
    if dead:
        keep[torch.arange(dead, device="cuda") * (rows // dead)] = False
    return keep


def softmax_invariants(torch, got, keep):
    """Masked entries exactly 0, fully masked rows all 0, others summing
    to 1 (1e-3 in bf16, 1e-5 in f32); None when they hold."""
    if bool((got[~keep] != 0).any()):
        return "a masked entry is not exactly 0"
    sums = got.float().sum(-1)
    live = keep.any(-1)
    if bool((sums[~live] != 0).any()):
        return "a fully masked row is not all 0"
    tol = 1e-5 if got.dtype == torch.float32 else 1e-2
    if bool(((sums[live] - 1).abs() > tol).any()):
        return f"rows do not sum to 1 within {tol}"
    return None


def serve_prompts(vocab: int):
    """The 8 prompts of the full-width serves (phases 3, 3b, 3c)."""
    import numpy as np
    rng = np.random.default_rng(0)
    plens = [int(p) for p in rng.integers(64, 701, 8)]
    return [rng.integers(0, vocab, p) for p in plens]


def packed_layout(torch, plens, chunk: int):
    """The segment ids of the widest dispatch (largest prefix span) that the
    packing planner makes of a wave of these prompt lengths, as the packed
    prefill builds them, on the card. Returns (ids, lanes, prefix span)."""
    from types import SimpleNamespace

    import numpy as np
    from repro_torch.models.attention import packed_segment_info
    from repro_torch.sched import plan_packed_job

    wave = [(i, SimpleNamespace(prompt=np.zeros(p, np.int32)))
            for i, p in enumerate(plens)]
    job = plan_packed_job(wave, max_slots=8, chunk=chunk, sub_batch=0)
    d = max(job.dispatches, key=lambda d: (d.prefix_span, d.rows))
    dev = [torch.from_numpy(a).to("cuda")
           for a in (d.seg_pos, d.seg_ids, d.valid, d.prefix_len)]
    info = packed_segment_info(*dev, d.prefix_span)
    return [t.contiguous() for t in info], d.rows, d.prefix_span


SOURCES = {
    "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:127"),
    "flash_attention_segmented": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:127 (segment_info)"),
    "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:64"),
    "pim_matvec": ("cuda", "src/repro_torch/kernels/csrc/pim_matvec.cu",
                   "src/repro/kernels/pim_matvec.py:52"),
    "layernorm": ("triton", "src/repro_torch/kernels/layernorm.py",
                  "src/repro/kernels/layernorm.py:29"),
    "rwkv_chunk": ("cuda", "src/repro_torch/kernels/csrc/rwkv_chunk.cu",
                   "src/repro/kernels/rwkv_chunk.py:75"),
    "masked_softmax": ("triton", "src/repro_torch/kernels/masked_softmax.py",
                       "src/repro/kernels/masked_softmax.py:27"),
    "mamba_chunk": ("cuda", "src/repro_torch/kernels/csrc/mamba_chunk.cu",
                    "src/repro/kernels/mamba_chunk.py:51"),
    # the training path's backward kernels replace the reference's XLA
    # gradients: its custom VJP's _flash_bwd, autodiff of apply_norm
    "flash_attention_bwd": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:190 (_flash_bwd, XLA)"),
    "layernorm_bwd": ("triton", "src/repro_torch/kernels/layernorm.py",
                      "src/repro/models/layers.py:36 (apply_norm, XLA "
                      "autodiff)"),
    # the recurrences' gradients: XLA autodiff of the reference's scans
    "rwkv_chunk_bwd": (
        "cuda", "src/repro_torch/kernels/csrc/rwkv_chunk_bwd.cu",
        "src/repro/models/ssm.py:117 (_wkv_scan, XLA autodiff)"),
    "mamba_chunk_bwd": (
        "cuda", "src/repro_torch/kernels/csrc/mamba_chunk_bwd.cu",
        "src/repro/models/ssm.py:280 (mamba_mix's chunked_linear_scan, "
        "XLA autodiff)"),
}
# the sources whose kernels may not spill (the tensor-core routes, the
# redesigned decode kernels and the recurrences' backward kernels)
SPILL_GATED = ("flash_attention", "flash_attention_bwd", "decode_attention",
               "pim_matvec", "rwkv_chunk", "rwkv_chunk_bwd",
               "mamba_chunk_bwd")
# the registers a thread of the flash backward's dK/dV kernel (and of its
# dQ kernel above D 64) must enter with: their warpgroups trade registers
# by setmaxnreg within the CTA's launch allocation (384 x 168), and with
# fewer the consumers' request could wait forever
DKDV_ENTRY_REGS = 168


def trades_registers(kernel: str) -> bool:
    """Whether a ptxas entry (``name[template args]``) is a flash backward
    kernel whose warpgroups trade registers by setmaxnreg."""
    if kernel.startswith("bwd_dkdv_tc_kernel"):
        return True
    return kernel.startswith("bwd_dq_tc_kernel[") and \
        int(kernel.split("[")[1].split("]")[0]) > 64
# the case of each kernel that the JSON line reports (a main-path shape)
REPORTED = {"flash_attention": "B8 S128 span640 off512",
            "flash_attention_segmented": "R8 C128 span512",
            "decode_attention": "B8 L1024",
            "pim_matvec": "n8 2048->8192 silu",
            "layernorm": "rmsnorm rows1024 d2048",
            "rwkv_chunk": "BH128 T2048 K64",
            "masked_softmax": "rows32768 n640",
            "mamba_chunk": "B2 T2048 d8192 n16",
            "flash_attention_bwd": "B4 S1024",
            "layernorm_bwd": "rmsnorm rows4096 d2048",
            "rwkv_chunk_bwd": "BH128 T2048 K64",
            "mamba_chunk_bwd": "B2 T2048 d8192 n16"}


def ptxas_entries(log_text: str):
    """Each kernel's registers, static shared memory and spills from
    ``nvcc -Xptxas -v``, its template arguments (head dim, segmented) read
    off the mangled name. The bf16 flash route's shared memory is dynamic:
    2 Q tiles (1 in the segmented mode at D 160) and 3 K and 3 V tiles (2
    above D 64) of 64 rows of DP bf16 (D padded to a multiple of 64 above
    64), and 1 KB to align them (the segmented mode adds its key ids and
    tile ranges)."""
    import re
    out, name, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and name:
            kernel = re.search(r"[a-z_]+_kernel", name)
            args = re.findall(r"L([ib])(\d+)E", name)
            entry = dict(kernel=(kernel.group(0) if kernel else name)
                         + str([int(v) for _, v in args]),
                         registers=int(m.group(1)),
                         smem=int(m.group(2) or 0),
                         spill_stores=spills[0], spill_loads=spills[1])
            if kernel and kernel.group(0) == "wgmma_flash_kernel" and args:
                d, seg = int(args[0][1]), int(args[1][1])
                dp = d if d <= 64 else -(-d // 64) * 64
                stages = 2 if dp >= 128 else 3
                nwg = 1 if seg and dp > 128 else 2
                entry["dynamic_smem"] = \
                    (nwg + 2 * stages) * 64 * dp * 2 + 1024
            out.append(entry)
            name, spills = None, (0, 0)
    return out


def flat(torch, out):
    """A kernel's output as one tensor (rwkv_chunk returns y and S_T, the
    flash backward dq, dk and dv)."""
    if isinstance(out, tuple):
        return torch.cat([t.float().flatten() for t in out])
    return out


def check_kernels(torch) -> dict:
    """Every case of ``kernel_cases`` in both dtypes: fails on a kernel
    that disagrees with its plain version; returns the timed rows by
    (kernel, label), each with the launches its checked calls made (the
    call and, for a deterministic kernel, the second; not the timed
    ones)."""
    from repro_torch.kernels import ops

    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for c in kernel_cases(torch, dtype):
            tol = c.get("tol", TOL)[dname]
            atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
            before = ops.launch_counts().get(c["kernel"], 0)
            got = flat(torch, c["run"]())
            t0 = time.perf_counter()
            want = flat(torch, c["plain"]())
            torch.cuda.synchronize()
            # a plain version slower than 50 ms a call is timed over 5,
            # one slower than 0.5 s (the recurrences' step loops at T 2048)
            # over 3
            slow = time.perf_counter() - t0
            plain_kw = dict(iters=3, warmup=0) if slow > 0.5 else \
                dict(iters=5, warmup=1) if slow > 0.05 else {}
            # a kernel that merges splits in a fixed order: a second call
            # gives the same bits
            again = flat(torch, c["run"]()) if c.get("deterministic") \
                else got
            torch.cuda.synchronize()
            checked = ops.launch_counts().get(c["kernel"], 0) - before
            if not torch.equal(got, again):
                fail(f"{c['kernel']} [{dname} {c['label']}]: two calls on "
                     f"the same inputs differ")
            broken = c["check"](got) if "check" in c else None
            if broken:
                fail(f"{c['kernel']} [{dname} {c['label']}]: {broken}")
            finite = bool(torch.isfinite(got).all())
            if "rows" in c:       # padded query rows: finite garbage
                got, want = got[c["rows"]], want[c["rows"]]
            err = (got.float() - want.float()).abs()
            limit = c["limit"](want.float(), dname) if "limit" in c \
                else atol + rtol * want.float().abs()
            bad = err > limit
            max_err = float(err.max())
            if not finite or bool(bad.any()):
                fail(f"{c['kernel']} [{dname} {c['label']}] disagrees with "
                     f"its plain version: max |err| {max_err:.3g}, tol "
                     f"{atol} + {rtol} |want|")
            broken_share = None
            if "broken" in c:     # a known-wrong output must fail the bound
                wrong = (flat(torch, c["broken"]()).float()
                         - want.float()).abs()
                broken_share = float((wrong / limit).max())
                if broken_share <= 1:
                    fail(f"{c['kernel']} [{dname} {c['label']}]: the bound "
                         f"passes the plain version with a KV tile dropped "
                         f"(share {broken_share:.3g})")
            # the largest share of its bound that an element's error takes
            row = dict(kernel=c["kernel"], dtype=dname, label=c["label"],
                       max_abs_err=max_err, checked_launches=checked,
                       tol_share=float((err / limit).max()),
                       deterministic=bool(c.get("deterministic")))
            if broken_share is not None:
                row["dropped_tile_tol_share"] = broken_share
            if dname == c.get("timed", "bfloat16"):
                row["ms"] = time_ms(torch, c["run"])
                row["plain_ms"] = time_ms(torch, c["plain"], **plain_kw)
                row["library_ms"] = (None if c["library"] is None
                                     else time_ms(torch, c["library"]))
                # a kernel that computes in f32 whatever its inputs (the
                # softmax, the wkv's f32 route) is bounded by the f32 rate,
                # the wkv's bf16 route by the TF32 one (products at f32
                # precision on the tensor cores), and one that counts its
                # exps also by the SFU rate: the slower
                peak = PEAK_FLOPS[c.get("math", dname)]
                bytes_s = c["bytes"] / HBM_BYTES_PER_S
                ops_s = max(c["flops"] / peak, c.get("exps", 0) / SFU_PER_S)
                row["bound_ms"] = 1e3 * max(bytes_s, ops_s)
                row["bound_by"] = ("bytes" if bytes_s >= ops_s
                                   else "operations")
                if "exps" in c:
                    row["exps"] = c["exps"]
                report[c["kernel"], c["label"]] = row
            log("kernel " + json.dumps(row))
    return report


# --------------------------------------------------------------------------- #
# phase 3: full-width serve
# --------------------------------------------------------------------------- #
class PhaseClock:
    """A recorder (the engine's trace hooks) that marks phase boundaries
    with CUDA events on the engine's stream and snapshots the kernels'
    launch counts -- no host syncs of its own."""

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops
        self.marks = []       # (kind, event, launch counts, peak bytes)

    def _mark(self, kind: str) -> None:
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        # the allocator's peak is host bookkeeping: reading it waits for
        # nothing
        self.marks.append((kind, ev, self.ops.launch_counts(),
                           self.torch.cuda.max_memory_allocated()))

    def bind(self, engine) -> None:
        pass

    def on_request(self, *a, **k) -> None:
        pass

    def on_admit(self, *a, **k) -> None:
        self._mark("admit")

    def on_prefill(self, *a, **k) -> None:
        self._mark("prefill")

    def on_decode(self, *a, **k) -> None:
        self._mark("decode")

    def on_complete(self, *a, **k) -> None:
        pass


def serve_engine(cfg, params, recorder=None, prompts=None, max_new=32,
                 **scfg_kw):
    """An engine holding ``prompts`` (the llama serves' 8 by default),
    ``max_new`` new tokens each, at ``ServeConfig(**scfg_kw)`` over the
    llama serves' settings (``max_slots=8, max_len=1024,
    prefill_chunk=128``)."""
    from repro_torch.serve import ServeConfig, ServeEngine

    scfg = ServeConfig(**{**dict(max_slots=8, max_len=1024,
                                 prefill_chunk=128), **scfg_kw})
    eng = ServeEngine(cfg, params, scfg, recorder=recorder, device="cuda")
    for p in (serve_prompts(cfg.vocab_size) if prompts is None else prompts):
        eng.add_request(p, max_new_tokens=max_new)
    return eng


def full_width_serve(torch, cfg, params, name: str, required,
                     record: bool = False, **engine_kw) -> dict:
    """One measured serve of ``serve_engine``'s requests. The kernels in
    ``required`` must launch. Launch counts are set to 0 just before the
    run and read just after; CUDA's sync debug mode counts every
    synchronizing call the run makes besides the engine's own fetch, and
    there must be none. With ``record``, a ``TraceRecorder`` records the
    serve beside the clock (its trace under ``"trace"``, for phase 13)."""
    import warnings

    from repro_torch.kernels import ops
    from repro_torch.trace import TraceRecorder

    clock = PhaseClock(torch, ops)
    rec = TraceRecorder() if record else None
    eng = serve_engine(cfg, params,
                       recorder=clock if rec is None else Tee(clock, rec),
                       **engine_kw)
    plens = [len(r.prompt) for r in eng.queue]
    n_req, n_new = len(plens), eng.queue[0].max_new_tokens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            results = eng.run_until_done()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    hidden = [str(w.message) for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]

    if sorted(results) != list(range(n_req)) or any(
            len(v) != n_new or not all(0 <= t < cfg.vocab_size for t in v)
            for v in results.values()):
        fail(f"{name}: serve returned "
             f"{({k: len(v) for k, v in results.items()})}")
    for leaf in leaves(eng.cache):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            fail(f"{name}: non-finite values in the cache")
    if any(counts[k] == 0 for k in required):
        fail(f"{name}: a kernel of its path never launched: {counts}")
    n_chunks = eng.dispatch_counts["prefill"]
    n_steps = eng.dispatch_counts["decode"]
    if eng.host_syncs != n_steps or hidden:
        fail(f"{name}: {eng.host_syncs} host syncs for {n_steps} decode "
             f"steps, and {len(hidden)} hidden ones ({hidden[:1]})")

    kinds = [m[0] for m in clock.marks]
    admit = kinds.index("admit")
    last_prefill = max(i for i, k in enumerate(kinds) if k == "prefill")
    decodes = [i for i, k in enumerate(kinds) if k == "decode"]
    ev = [m[1] for m in clock.marks]
    prefill_s = ev[admit].elapsed_time(ev[last_prefill]) / 1e3
    decode_s = ev[last_prefill].elapsed_time(ev[decodes[-1]]) / 1e3

    def delta(a, b):
        return {k: clock.marks[b][2][k] - clock.marks[a][2][k] for k in counts}
    peak = torch.cuda.max_memory_allocated()
    per_chunk = {k: v / n_chunks for k, v in delta(admit, last_prefill).items()}
    per_step = {k: v / (len(decodes) - 1)
                for k, v in delta(decodes[0], decodes[-1]).items()}
    st = eng.prefill_stats
    prefill_tokens = sum(p - 1 for p in plens)
    out = dict(phase=name, prompt_lens=plens, wall_s=wall,
               prefill_s=prefill_s, prefill_tok_s=prefill_tokens / prefill_s,
               decode_s=decode_s, decode_tok_s=n_req * n_new / decode_s,
               ms_per_decode_step=1e3 * decode_s / n_steps,
               dispatch_counts=eng.dispatch_counts, host_syncs=eng.host_syncs,
               host_syncs_per_decode_step=eng.host_syncs / n_steps,
               hidden_syncs=len(hidden),
               async_fetches=eng.async_fetches,
               prefill_valid_fraction=st["valid_tokens"] / st["token_slots"],
               prefill_stats=dict(st),
               max_memory_allocated=peak,
               max_memory_allocated_prefill=clock.marks[last_prefill][3],
               launches=counts, launches_per_prefill_dispatch=per_chunk,
               launches_per_decode_step=per_step, tokens=results)
    if rec is not None:
        out["trace"] = rec.to_trace()
    del eng
    torch.cuda.empty_cache()
    return out


TIMED = ("wall_s", "prefill_s", "prefill_tok_s", "decode_s", "decode_tok_s",
         "ms_per_decode_step")


def two_serves(a: dict, b: dict) -> dict:
    """Two measured serves of one kind as one record: the first's counts,
    the means and both runs of the times, whether the tokens repeated."""
    a = {k: v for k, v in a.items() if k != "trace"}
    return dict(a, **{k: (a[k] + b[k]) / 2 for k in TIMED},
                **{f"{k}_runs": [a[k], b[k]] for k in TIMED},
                same_tokens_both_runs=a["tokens"] == b["tokens"])


def full_width_serves(torch, checks) -> dict:
    """Phases 3, 3b and 3c on one set of full-width bf16 weights, then 3d
    on the same weights (which it casts to float32)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_arch("llama3.2-1b")
    params = init_params(T.param_defs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    decode = ["decode_attention", "pim_matvec", "layernorm"]
    unpacked, packed = ["flash_attention"] + decode, \
        ["flash_attention_segmented"] + decode
    variants = (("3 unpacked", cfg, unpacked, {}),
                ("3b packed", cfg, packed, dict(pack=True)),
                ("3c int8", dataclasses.replace(cfg, kv_dtype="int8"),
                 unpacked, {}))
    # one unmeasured serve of each first: CUDA loads a kernel's module at
    # its first launch, and cuBLAS picks an algorithm per new shape
    t0 = time.perf_counter()
    for _, c, _, kw in variants:
        serve_engine(c, params, **kw).run_until_done()
    log(f"phase 3 warm-up took {time.perf_counter() - t0:.1f} s")
    # then two measured serves of each, in turns (3, 3b, 3c, 3c, 3b, 3),
    # so that a drift of the shared host weighs on all three alike
    runs = {name: [] for name, *_ in variants}
    for name, c, required, kw in variants + variants[::-1]:
        t0 = time.perf_counter()
        runs[name].append(full_width_serve(torch, c, params, name, required,
                                           **kw))
        log(f"phase {name} took {time.perf_counter() - t0:.1f} s")
    out = {}
    for name, (a, b) in runs.items():
        out[name] = two_serves(a, b)
        log(f"serve {name} " + json.dumps(
            {k: v for k, v in out[name].items() if k != "tokens"}))
    base, pk, i8 = out["3 unpacked"], out["3b packed"], out["3c int8"]
    log("packed against unpacked (means of two serves): " + json.dumps(dict(
        prefill_dispatches=[pk["dispatch_counts"]["prefill"],
                            base["dispatch_counts"]["prefill"]],
        prefill_valid_fraction=[pk["prefill_valid_fraction"],
                                base["prefill_valid_fraction"]],
        prefill_tok_s=[pk["prefill_tok_s"], base["prefill_tok_s"]],
        same_tokens=pk["tokens"] == base["tokens"])))
    log("int8 against bf16 cache (means of two serves): " + json.dumps(dict(
        decode_tok_s=[i8["decode_tok_s"], base["decode_tok_s"]],
        ms_per_decode_step=[i8["ms_per_decode_step"],
                            base["ms_per_decode_step"]],
        max_memory_allocated=[i8["max_memory_allocated"],
                              base["max_memory_allocated"]],
        max_memory_allocated_prefill=[i8["max_memory_allocated_prefill"],
                                      base["max_memory_allocated_prefill"]],
        saved_bytes=base["max_memory_allocated"]
        - i8["max_memory_allocated"])))
    t0 = time.perf_counter()
    out["9 policies"] = policy_serves(torch, cfg, params, base, pk, checks)
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 1024))).to("cuda")
    out["3d bf16 steps"] = bf16_steps(torch, cfg, params, "llama",
                                      serve_prompts(cfg.vocab_size),
                                      {"tokens": tokens}, pack=True)
    log(f"phase 3d took {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phases 9 and 9b: the interleaving policies, fused steps and supersteps
# --------------------------------------------------------------------------- #
POLICY_SERVES = (
    ("serial", dict(policy="serial", pack=True)),
    ("interleaved", dict(policy="interleaved", pack=True, fuse=True,
                         superstep=4)),
    ("pim_aware", dict(policy="pim_aware", pack=True, fuse=True,
                       superstep=4)),
)
# phase 9's interleaved serve again, sampling at temperature 0.8: the
# counter-based noise's cost a decode round, beside the greedy serve
SAMPLED = ("interleaved sampled", dict(POLICY_SERVES[1][1], temperature=0.8))
# the step kinds (``Scheduler.stats``) by what they carry
PURE_DECODE = ("decode_only", "superstep")
WITH_PREFILL = ("prefill_only", "serialized", "overlapped", "fused")


def policy_arrivals(vocab: int):
    """Phase 9's open-loop workload: requests arrive while others decode."""
    from repro_torch.trace import poisson_arrivals
    return poisson_arrivals(0.25, 48, vocab=vocab, prompt_len=(64, 700),
                            max_new=(16, 32), seed=11)


def policy_engine(cfg, params, recorder=None, **kw):
    from repro_torch.serve import ServeConfig, ServeEngine
    return ServeEngine(cfg, params, ServeConfig(
        max_slots=8, max_len=1024, prefill_chunk=128, **kw),
        recorder=recorder, device=params["embed"]["tok"].device)


class StepTally:
    """A recorder (the engine's trace hooks) and a hook around
    ``engine.step``: each step's kind (from the scheduler's counts), its
    decode rounds (engine ticks) and tokens, and a CUDA event at its end;
    each request's arrival tick and the tick of its first token; the k of
    each superstep. No host syncs of its own."""

    def __init__(self, torch):
        self.torch = torch
        self.arrival, self.first, self.supersteps = {}, {}, {}
        self.steps = []           # (kind, end event, rounds, tokens)

    def bind(self, engine) -> None:
        pass

    def on_request(self, step, rid, prompt_len, max_new, arrival_offset=0,
                   gid=None) -> None:
        self.arrival[rid] = step - arrival_offset

    def on_admit(self, *a, **k) -> None:
        pass

    def on_prefill(self, *a, **k) -> None:
        pass

    def on_complete(self, *a, **k) -> None:
        pass

    def on_decode(self, step, *, tokens, superstep=1, superstep_id=-1,
                  **k) -> None:
        for rid, _ in tokens:
            self.first.setdefault(rid, step)
        if superstep > 1:
            self.supersteps[superstep_id] = superstep

    def wrap(self, eng) -> None:
        step = eng.step

        def timed():
            before, tick = dict(eng.scheduler.stats), eng.step_idx
            out = step()
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            kind = next(k for k, v in eng.scheduler.stats.items()
                        if k != "steps" and v != before[k])
            rounds = eng.step_idx - tick if kind == "superstep" \
                else int(kind not in ("prefill_only", "idle"))
            self.steps.append((kind, ev, rounds, len(out)))
            return out
        eng.step = timed


def policy_serve(torch, cfg, params, name: str, kw: dict, per_round: dict,
                 per_chunk: dict, phase: str = "9") -> dict:
    """One measured serve of ``policy_arrivals`` under ``kw``, under CUDA's
    sync debug mode, with the launch counts set to 0 just before and read
    just after. Fails unless every kernel launched exactly ``per_round``
    times a decode round run on the card (a superstep's k, dead rounds
    included) plus ``per_chunk`` times a prefill chunk (a fused step is a
    round and a chunk), the host synced once per decode, superstep and
    fused dispatch and at no other point, and an interleaving policy ran
    fused steps and supersteps. The serve is recorded (``TraceRecorder``)
    beside the tally; the result's ``trace`` is its trace."""
    import warnings

    from repro_torch.kernels import ops
    from repro_torch.trace import TraceRecorder, drive

    arrivals = policy_arrivals(cfg.vocab_size)
    tally, rec = StepTally(torch), TraceRecorder()
    eng = policy_engine(cfg, params, recorder=Tee(tally, rec), **kw)
    tally.wrap(eng)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        start.record()
        try:
            results = drive(eng, arrivals)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    hidden = [str(w.message) for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]

    if sorted(results) != list(range(len(arrivals))) or any(
            len(results[i]) != ev.max_new
            or not all(0 <= t < cfg.vocab_size for t in results[i])
            for i, ev in enumerate(arrivals)):
        fail(f"{phase} {name}: serve returned "
             f"{({k: len(v) for k, v in results.items()})}")
    stats, dc = dict(eng.scheduler.stats), dict(eng.dispatch_counts)
    rounds = sum(r for _, _, r, _ in tally.steps)
    chunks = dc["prefill"] + dc["fused"]
    if rounds != (dc["decode"] - stats["superstep"] + dc["fused"]
                  + sum(tally.supersteps.values())):
        fail(f"{phase} {name}: {rounds} decode rounds do not add up: {dc}, "
             f"supersteps {tally.supersteps}")
    want = {k: round(per_round[k]) * rounds + round(per_chunk[k]) * chunks
            for k in counts}
    if counts != want or any(counts[k] == 0 for k in (
            "flash_attention_segmented", "decode_attention", "pim_matvec",
            "layernorm")):
        fail(f"{phase} {name}: launches {counts}, expected {want} for {rounds} "
             f"decode rounds and {chunks} prefill chunks")
    if eng.host_syncs != dc["decode"] + dc["fused"] or hidden:
        fail(f"{phase} {name}: {eng.host_syncs} host syncs for {dc}, and "
             f"{len(hidden)} hidden ones ({hidden[:1]})")
    if kw["policy"] == "interleaved" and not (stats["fused"]
                                              and stats["superstep"]):
        fail(f"{phase} {name}: no fused step or no superstep: {stats}")
    if kw["policy"] == "pim_aware" and (
            not stats["superstep"] or stats["fused"] + stats["overlapped"]
            != sum(d["overlap"] for d in eng.scheduler.decision_log)):
        fail(f"{phase} {name}: steps {stats} against its decisions")

    # each step's seconds (device timeline, host gaps included), rounds and
    # tokens, summed over the steps of the given kinds
    ends = [start] + [ev for _, ev, _, _ in tally.steps]
    rows = [(kind, a.elapsed_time(b) / 1e3, r, n) for (kind, _, r, n), a, b
            in zip(tally.steps, ends, ends[1:])]

    def total(kinds):
        return [sum(col) for col in zip(*[row[1:] for row in rows
                                          if row[0] in kinds])]
    pd_s, pd_rounds, pd_tokens = total(PURE_DECODE)
    pd_syncs = stats["decode_only"] + stats["superstep"]
    pf_s = total(WITH_PREFILL)[0]
    ttft = [tally.first[r] - tally.arrival[r] for r in results]
    out = dict(phase=f"{phase} {name}", serve=kw, requests=len(results),
               tokens=sum(len(v) for v in results.values()), wall_s=wall,
               tok_s=sum(len(v) for v in results.values()) / wall,
               decode_tok_s=pd_tokens / pd_s,
               ms_per_decode_round=1e3 * pd_s / pd_rounds,
               decode_rounds=rounds, pure_decode_rounds=pd_rounds,
               rounds_per_host_sync=rounds / eng.host_syncs,
               pure_decode_rounds_per_host_sync=pd_rounds / pd_syncs,
               prefill_s=pf_s,
               prefill_tok_s=eng.prefill_stats["valid_tokens"] / pf_s,
               ttft_steps_mean=sum(ttft) / len(ttft), ttft_steps_max=max(ttft),
               dispatch_counts=dc, host_syncs=eng.host_syncs,
               hidden_syncs=len(hidden), steps=stats,
               superstep_tokens=eng.superstep_tokens, launches=counts,
               results=results, trace=rec.to_trace())
    del eng
    return out


POLICY_TIMED = ("wall_s", "tok_s", "decode_tok_s", "ms_per_decode_round",
                "prefill_s", "prefill_tok_s")


def policy_serves(torch, cfg, params, unpacked: dict, packed: dict,
                  checks) -> dict:
    """Phase 9 on phase 3's bf16 weights: one unmeasured serve of each
    policy and of ``SAMPLED`` (new packed shapes, module loads), two
    measured ones in turns (serial, interleaved, sampled, pim_aware,
    pim_aware, sampled, interleaved, serial), then one profiled serve of
    each for the device's busy share. Launches per decode round are
    phase 3's per decode step, per prefill chunk phase 3b's per packed
    dispatch."""
    from repro_torch.trace import drive

    per_round = unpacked["launches_per_decode_step"]
    per_chunk = packed["launches_per_prefill_dispatch"]
    arrivals = policy_arrivals(cfg.vocab_size)
    serves = POLICY_SERVES[:2] + (SAMPLED,) + POLICY_SERVES[2:]
    t0 = time.perf_counter()
    for _, kw in serves:
        drive(policy_engine(cfg, params, **kw), arrivals)
    log(f"phase 9 warm-up took {time.perf_counter() - t0:.1f} s")
    runs = {name: [] for name, _ in serves}
    for name, kw in serves + serves[::-1]:
        t0 = time.perf_counter()
        r = policy_serve(torch, cfg, params, name, kw, per_round, per_chunk)
        runs[name].append(r)
        trace = r.pop("trace")
        checks.add(f"9 {name} #{len(runs[name])}", [trace])
        if name == "pim_aware" and checks.replay is None:
            checks.replay = (f"9 {name} #1", trace, r["ms_per_decode_round"])
        log(f"phase 9 {name} took {time.perf_counter() - t0:.1f} s")
    out = {}
    for name, kw in serves:
        a, b = runs[name]
        t0 = time.perf_counter()
        prof = device_profile(torch, lambda kw=kw: drive(
            policy_engine(cfg, params, **kw), arrivals))
        log(f"phase 9 profile {name} took {time.perf_counter() - t0:.1f} s")
        out[name] = dict(
            {k: v for k, v in a.items() if k != "results"},
            **{k: (a[k] + b[k]) / 2 for k in POLICY_TIMED},
            **{f"{k}_runs": [a[k], b[k]] for k in POLICY_TIMED},
            same_tokens_both_runs=a["results"] == b["results"],
            same_tokens_as_serial=a["results"] == runs["serial"][0]["results"],
            busy_share=prof["busy_share"], profile=prof)
        log("serve " + json.dumps(out[name]))
    keys = POLICY_TIMED[2:] + ("rounds_per_host_sync",
                               "pure_decode_rounds_per_host_sync",
                               "ttft_steps_mean", "ttft_steps_max",
                               "busy_share")
    for name in ("interleaved", "pim_aware"):
        log(f"9 {name} against serial (means of two serves): " + json.dumps(
            {k: [out[name][k], out["serial"][k]] for k in keys}))
    name = SAMPLED[0]
    log(f"9 {name} against greedy (two serves each; busy seconds of one "
        "profiled serve): " + json.dumps(
            {k: [out[name][k], out["interleaved"][k]] for k in (
                "ms_per_decode_round_runs", "decode_tok_s_runs",
                "ms_per_decode_round", "same_tokens_both_runs")}
            | {"busy_s": [out[name]["profile"]["busy_s"],
                          out["interleaved"]["profile"]["busy_s"]]}))
    return out


def policy_parity(torch, checks) -> None:
    """Phase 9b: phase 9's workload at full width, depth 2, float32. The
    serves are recorded: the card's and the CPU's traces must be equal
    event for event (so are their lowered commands and replays)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.trace import TraceRecorder, drive

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    params = init_params(T.param_defs(cfg),
                         torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")

    def tree(fn, t):
        return {k: tree(fn, v) for k, v in t.items()} \
            if isinstance(t, dict) else fn(t)
    params = {"cuda": tree(lambda a: a.float(), params)}
    params["cpu"] = tree(lambda a: a.cpu(), params["cuda"])
    arrivals = policy_arrivals(cfg.vocab_size)
    runs = {}
    for name, kw in POLICY_SERVES:
        for dev in ("cuda",) if name == "serial" else ("cuda", "cpu"):
            rec = TraceRecorder()
            eng = policy_engine(cfg, params[dev], recorder=rec, **kw)
            runs[name, dev] = dict(
                tokens=drive(eng, arrivals), dispatches=eng.dispatch_counts,
                host_syncs=eng.host_syncs, steps=eng.scheduler.stats,
                decisions=getattr(eng.scheduler, "decision_log", None))
            tr = rec.to_trace()
            runs[name, dev]["trace"] = [tr.header, tr.events, tr.summary]
            checks.add(f"9b {name} {dev}", [tr])
        if name == "serial":
            continue
        if runs[name, "cuda"] != runs[name, "cpu"]:
            diff = [k for k in runs[name, "cuda"]
                    if runs[name, "cuda"][k] != runs[name, "cpu"][k]]
            fail(f"9b {name}: kernel path != plain path in {diff}")
        if runs[name, "cuda"]["tokens"] != runs["serial", "cuda"]["tokens"]:
            fail(f"9b {name}: tokens differ from the serial serve's")
        r = runs[name, "cuda"]
        log(f"parity float32 depth 2, 9b {name}: tokens, dispatches "
            f"{r['dispatches']}, {r['host_syncs']} host syncs, steps "
            f"{r['steps']}" + (f", {len(r['decisions'])} decisions"
                               if r["decisions"] else "")
            + f", and a trace of {len(r['trace'][1])} events identical on "
            "cuda and cpu; tokens == serial's")
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phases 3d and 7c: bf16 steps, kernel path against plain path on the card
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def plain_path(ops):
    """Within it, ``ops`` sends CUDA tensors to the plain versions. The port
    has no such switch (a CUDA tensor goes to its kernel); this test puts
    one in for the comparison and takes it out again."""
    routed = ops._use_kernel
    ops._use_kernel = lambda t: False
    try:
        yield
    finally:
        ops._use_kernel = routed


def bf16_steps(torch, cfg, params, name: str, prompts, step_batch,
               pack: bool, **engine_kw) -> dict:
    """A decode step and a prefill step of ``cfg`` in bf16, through the
    kernels and through the plain versions, both on the card, each against
    the same step's plain path in float32. The decode step is the first
    one after a wave's prefill (``prompts``, through the engine's own
    prefill: flash chunks, or sequential decode steps for the recurrent
    stacks); the prefill step is ``step_fn_for(cfg, "prefill")`` on
    ``step_batch`` (its stub embeddings cast to float32 for the float32
    pass). The kernel path's max |error| may be at most twice
    the bf16 plain path's own. With ``pack``, the packed prefill's first
    step is held to the same bound and set beside the unpacked one. The
    float32 pass casts ``params`` in place, leaf by leaf (a float32 copy of
    jamba's depth-8 weights beside the bf16 ones would not fit the card),
    so the caller is done with them."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import step_fn_for
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def first_step(c, p, **kw):
        eng = serve_engine(c, p, prompts=prompts, max_new=1,
                           **{**engine_kw, **kw})
        eng.prefill_wave(eng.admit_wave())
        logits, _ = T.decode_step(c, p, eng.last_tok[:, None], eng.cache,
                                  eng.lens)
        return logits.float()

    def both(c, p, plain: bool, **kw):
        batch = {k: v.float() if c.dtype == "float32"
                 and v.is_floating_point() else v
                 for k, v in step_batch.items()}
        with plain_path(ops) if plain else contextlib.nullcontext():
            out = {"decode": first_step(c, p, **kw),
                   "prefill": step_fn_for(c, "prefill")(p, batch).float()}
        torch.cuda.synchronize()
        return out

    runs = {"kernel": both(cfg, params, False),
            "plain": both(cfg, params, True)}
    if pack:
        runs["kernel packed"] = {"decode": first_step(cfg, params,
                                                      pack=True).float()}
    leaves_to_f32(torch, params)
    f32 = dataclasses.replace(cfg, dtype="float32")
    runs["plain f32"] = both(f32, params, True)
    out = {}
    for step in ("decode", "prefill"):
        ref32 = runs["plain f32"][step]
        err = {k: float((r[step] - ref32).abs().max())
               for k, r in runs.items() if step in r and k != "plain f32"}
        if not all(bool(torch.isfinite(r[step]).all()) for r in runs.values()
                   if step in r):
            fail(f"{name} bf16 {step} step: non-finite logits")
        bound = 2 * err["plain"]
        for k, e in err.items():
            if k != "plain" and e > bound:
                fail(f"{name} bf16 {step} step: the {k} path's max |err| "
                     f"{e:.4g} against float32 exceeds twice the plain "
                     f"path's {err['plain']:.4g}")
        out[step] = dict(max_abs_err=err, bound=bound,
                         max_abs_f32=float(ref32.abs().max()),
                         shape=list(ref32.shape))
    if pack:
        diff = float((runs["kernel packed"]["decode"]
                      - runs["kernel"]["decode"]).abs().max())
        errs = out["decode"]["max_abs_err"]
        out["packed_vs_unpacked"] = dict(
            max_abs_diff=diff,
            within_route_error=diff <= max(errs["kernel"],
                                           errs["kernel packed"]))
    log(f"bf16 steps {name} " + json.dumps(out))
    return out


def leaves_to_f32(torch, tree) -> None:
    """Cast a nested dict's tensors to float32 in place, one leaf at a
    time, handing each bf16 leaf's memory back before the next cast."""
    for key, val in tree.items():
        if isinstance(val, dict):
            leaves_to_f32(torch, val)
        else:
            tree[key] = val.float()
            del val
            torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 4: kernel path == plain path, float32
# --------------------------------------------------------------------------- #
def parity_serve(torch) -> None:
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServeConfig, ServeEngine

    # full-precision matmuls on the card: the comparison is the kernels'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    params = init_params(T.param_defs(cfg),
                         torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")

    def tree(fn, t):
        return {k: tree(fn, v) for k, v in t.items()} \
            if isinstance(t, dict) else fn(t)
    params = {"cuda": tree(lambda a: a.float(), params)}
    params["cpu"] = tree(lambda a: a.cpu(), params["cuda"])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (5, 37, 130, 280)]
    runs = {}
    for variant, c, kw in (("unpacked", cfg, {}),
                           ("packed", cfg, dict(pack=True)),
                           ("int8", dataclasses.replace(cfg, kv_dtype="int8"),
                            {})):
        for dev in ("cuda", "cpu"):
            eng = ServeEngine(c, params[dev], ServeConfig(
                max_slots=4, max_len=300, prefill_chunk=128, **kw),
                device=dev)
            for pr in prompts:
                eng.add_request(pr, max_new_tokens=8)
            runs[variant, dev] = (eng.run_until_done(),
                                  dict(eng.dispatch_counts), eng.host_syncs)
        if runs[variant, "cuda"] != runs[variant, "cpu"]:
            fail(f"{variant}: kernel path != plain path: "
                 f"{runs[variant, 'cuda']} != {runs[variant, 'cpu']}")
        log(f"parity float32 depth 2, {variant}: tokens, dispatches "
            f"{runs[variant, 'cuda'][1]} and {runs[variant, 'cuda'][2]} "
            f"host syncs identical on cuda and cpu")
    (tok_p, disp_p, sync_p), (tok_u, disp_u, sync_u) = \
        runs["packed", "cuda"], runs["unpacked", "cuda"]
    if tok_p != tok_u or disp_p["decode"] != disp_u["decode"] \
            or sync_p != sync_u:
        fail(f"packed != unpacked on the card: {runs['packed', 'cuda']} "
             f"!= {runs['unpacked', 'cuda']}")
    log(f"parity float32 depth 2: packed == unpacked on the card (prefill "
        f"dispatches {disp_p['prefill']} against {disp_u['prefill']})")


# --------------------------------------------------------------------------- #
# phase 2b: the masked_softmax entry at a llama prefill chunk's scores
# --------------------------------------------------------------------------- #
def softmax_path(torch) -> dict:
    """``ops.masked_softmax``, the entry a caller uses (no model reaches
    the kernel, as in the reference), on (B 8, H 32, S 128, keys 640) bf16
    scores under the causal bitmap with holes. Launch counts are set to 0
    just before and read just after; the kernel must launch once."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(3)
    shape = (8, 32, 128, 640)
    x = (torch.randn(shape, generator=g, device="cuda") * 3).to(
        torch.bfloat16)
    keep = softmax_mask(torch, g, 8 * 32 * 128, 640, 0).reshape(shape)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = ops.masked_softmax(x, keep)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts["masked_softmax"] != 1 or got.shape != x.shape:
        fail(f"ops.masked_softmax: launches {counts}, shape {got.shape}")
    err = (got.float() - ref.masked_softmax_ref(x, keep).float()).abs()
    broken = softmax_invariants(torch, got.reshape(-1, 640),
                                keep.reshape(-1, 640))
    if broken or float(err.max()) > TOL["bfloat16"]:
        fail(f"ops.masked_softmax: {broken}, max |err| {float(err.max())}")
    out = dict(phase="2b masked_softmax path", shape=list(shape),
               launches=counts, max_abs_err=float(err.max()))
    log("path " + json.dumps(out))
    return out


# --------------------------------------------------------------------------- #
# phases 5 and 5b, 7 and 7b: rwkv6-7b and jamba-v0.1-52b at full width
# --------------------------------------------------------------------------- #
def recurrent_prompts(vocab: int):
    """The 8 prompts of the rwkv6-7b and jamba-v0.1-52b serves, lengths
    from a seed in 8-64."""
    import numpy as np
    rng = np.random.default_rng(4)
    plens = [int(p) for p in rng.integers(8, 65, 8)]
    return [rng.integers(0, vocab, p) for p in plens]


def prefill_step_run(torch, cfg, params, phase: str, expect: dict, B: int,
                     S: int, runs: int = 2, batch=None) -> dict:
    """The full-sequence prefill step (``step_fn_for(cfg, "prefill")``,
    ``forward_full(last_only=True)``) on (B, S) tokens from a seed, or on
    ``batch`` (tokens and a family's stub embeddings, on the card): one
    unmeasured call, then ``runs`` measured ones by CUDA events. Each
    kernel of ``expect`` must launch exactly that many times in each."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import step_fn_for

    step = step_fn_for(cfg, "prefill")
    if batch is None:
        batch = {"tokens": torch.from_numpy(np.random.default_rng(
            5).integers(0, cfg.vocab_size, (B, S))).to("cuda")}
    step(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(runs):
        ops.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits = step(params, batch)
        ev[1].record()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ms.append(ev[0].elapsed_time(ev[1]))
        if any(counts[k] != n for k, n in expect.items()):
            fail(f"{phase}: launches {counts}, expected {expect}")
    if tuple(logits.shape) != (B, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"{phase}: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    mean = sum(ms) / len(ms)
    return dict(phase=phase, B=B, S=S, ms=mean, ms_runs=ms,
                prefill_tok_s=B * S / (mean / 1e3),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches=counts)


# the device-side names of the port's kernels (CUDA and Triton)
PORT_KERNELS = ("pim_matvec_kernel", "decode_attention_kernel",
                "flash_attention_kernel", "wgmma_flash_kernel",
                "rwkv_chunk_kernel", "rwkv_chunk_tc_kernel",
                "mamba_chunk_kernel", "norm_kernel", "softmax_kernel",
                "bwd_delta_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel",
                "bwd_dkdv_tc_kernel", "bwd_dq_tc_kernel", "norm_bwd_kernel",
                "rwkv_chunk_bwd_kernel", "rwkv_du_kernel",
                "mamba_chunk_bwd_kernel", "mamba_dc_kernel")


def device_profile(torch, fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler``, tracing the device
    alone: its wall time, the device's busy seconds, the ``top`` device
    ops by time and the port's kernels' count and time."""
    from repro_torch.launch.serve import device_time

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, ranked = device_time(prof, 10**6)
    # the port's kernels summed over their template instances
    mine = {}
    for op, n, s in ranked:
        fam = next((f for f in PORT_KERNELS if f in op), None)
        if fam:
            c, t = mine.get(fam, (0, 0.0))
            mine[fam] = (c + n, t + s)
    return dict(wall_s=wall, busy_s=busy, busy_share=busy / wall,
                top=[dict(op=op[:80], count=n, ms=1e3 * s)
                     for op, n, s in ranked[:top]],
                port_kernels={f: dict(count=n, ms=1e3 * s)
                              for f, (n, s) in mine.items()})


def recurrent_full_width(torch, cfg, name: str, phases, required,
                         expect) -> dict:
    """A serve (phase ``phases[0]``: 8 requests, their prompts cut to 24
    tokens, 16 new tokens each, ``ServeConfig(max_slots=8, max_len=256)``;
    the kernels in ``required`` must launch) and the prefill step at B 2 x S 2048 (``phases[1]``;
    launches as in ``expect``) on one set of bf16 weights from a seed,
    then a profile of each; with a third phase name, ``bf16_steps`` last
    (the prompts cut to 16 tokens, the prefill step at B 2 x S 1024)."""
    from repro_torch.launch.steps import step_fn_for

    params, n_bytes = weights(torch, cfg, name)
    prompts = recurrent_prompts(cfg.vocab_size)
    kw = dict(max_slots=8, max_len=256)
    # one short unmeasured serve first (module loads, cuBLAS's choices)
    serve_engine(cfg, params, prompts=[prompts[0][:3]], max_new=2,
                 **kw).run_until_done()
    # each prompt token but the last is one dispatch of the whole stack
    # (the sequential prefill): 24 tokens keep the whole run in its limit
    t0 = time.perf_counter()
    serve = full_width_serve(torch, cfg, params, f"{phases[0]} {name} serve",
                             required, prompts=[p[:24] for p in prompts],
                             max_new=16, **kw)
    log(f"phase {phases[0]} took {time.perf_counter() - t0:.1f} s")
    log(f"serve {phases[0]} {name} " + json.dumps(
        {k: v for k, v in serve.items() if k != "tokens"}))
    t0 = time.perf_counter()
    step = prefill_step_run(torch, cfg, params,
                            f"{phases[1]} {name} prefill step", expect,
                            B=2, S=2048)
    log(f"phase {phases[1]} took {time.perf_counter() - t0:.1f} s")
    log("step " + json.dumps(step))
    # where the device time goes: one prefill step, and a short serve (8
    # prompts of 4 tokens, 4 new tokens each: 24 sequential prefill and 4
    # decode dispatches, each one decode step over the 8 slots)
    t0 = time.perf_counter()
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(7))
    prof = {"step": device_profile(torch, lambda: step_fn_for(
        cfg, "prefill")(params, {"tokens": tokens}))}
    eng = serve_engine(cfg, params, prompts=[p[:4] for p in prompts],
                       max_new=4, **kw)
    prof["serve"] = device_profile(torch, eng.run_until_done)
    prof["serve"]["dispatches"] = dict(eng.dispatch_counts)
    log(f"profile {phases[0]} {name} (took {time.perf_counter() - t0:.1f} "
        f"s) " + json.dumps(prof))
    steps = None
    if len(phases) > 2:
        t0 = time.perf_counter()
        steps = bf16_steps(torch, cfg, params, name,
                           [p[:16] for p in prompts],
                           {"tokens": tokens[:, :1024]}, pack=False, **kw)
        log(f"phase {phases[2]} took {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return {"serve": serve, "step": step, "profile": prof,
            "weight_bytes": n_bytes, "bf16_steps": steps}


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------- #
# phases 6 and 8: kernel path == plain path, float32, depth 2
# --------------------------------------------------------------------------- #
def depth2_parity(torch, cfg, name: str, variants=({},), S: int = 256,
                  stub=None) -> None:
    """``cfg`` (full width, depth 2) in float32, through the kernels on the
    card and the plain versions on the CPU: the serve with 4 slots and
    short prompts gives identical greedy tokens, dispatch counts and host
    syncs under each of ``variants`` (``ServeConfig`` changes: packed
    prefill for the attention stacks); the prefill step at S tokens (and
    ``stub``, a family's stub embeddings as numpy arrays) gives logits
    within 1e-4 (the plain scans are the sequential oracles), and, with
    MoE, the full-sequence forward's aux loss within 1e-4."""
    import numpy as np
    from repro_torch.launch.steps import step_fn_for
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServeConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = init_params(T.param_defs(cfg),
                         torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")

    def tree(fn, t):
        return {k: tree(fn, v) for k, v in t.items()} \
            if isinstance(t, dict) else fn(t)
    params = {"cuda": tree(lambda a: a.float(), params)}
    params["cpu"] = tree(lambda a: a.cpu(), params["cuda"])
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (3, 9, 17, 6)]
    tokens = rng.integers(0, cfg.vocab_size, (2, S))
    runs, logits, aux = {}, {}, {}
    for dev in ("cuda", "cpu"):
        runs[dev] = []
        for kw in variants:
            eng = ServeEngine(cfg, params[dev], ServeConfig(
                max_slots=4, max_len=64, **kw), device=dev)
            for pr in prompts:
                eng.add_request(pr, max_new_tokens=6)
            runs[dev].append((eng.run_until_done(),
                              dict(eng.dispatch_counts), eng.host_syncs))
        logits[dev] = step_fn_for(cfg, "prefill", device=dev)(
            params[dev], {"tokens": tokens, **(stub or {})}).cpu()
        if cfg.is_moe:
            aux[dev] = float(T.forward_full(
                cfg, params[dev], torch.from_numpy(tokens).to(dev),
                last_only=True)[1])
    if runs["cuda"] != runs["cpu"]:
        fail(f"{name} serve: kernel path != plain path: {runs['cuda']} != "
             f"{runs['cpu']}")
    err = (logits["cuda"] - logits["cpu"]).abs()
    worst = float((err / (1 + logits["cpu"].abs())).max())
    if worst > 1e-4:
        fail(f"{name} prefill step: kernel path != plain path, max |err| / "
             f"(1 + |plain|) {worst:.3g} > 1e-4")
    aux_err = abs(aux["cuda"] - aux["cpu"]) if aux else 0.0
    if aux_err > 1e-4:
        fail(f"{name} prefill step: aux loss {aux['cuda']} on the card, "
             f"{aux['cpu']} on the CPU")
    log(f"parity float32 depth 2, {name} {list(variants)}: tokens, "
        f"dispatches {[r[1] for r in runs['cuda']]} and host syncs "
        f"{[r[2] for r in runs['cuda']]} identical on cuda and cpu; prefill "
        f"step S {S} logits max |err| "
        f"{float(err.max()):.3g} (relative {worst:.3g})"
        + (f"; aux loss {aux['cuda']!r} against {aux['cpu']!r}" if aux
           else ""))
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phases 10-11c: the paper's GPT-2 models and the moe family
# --------------------------------------------------------------------------- #
def path_launches(cfg, packed: bool):
    """The launches of an attention stack's decode step and prefill chunk:
    a step runs decode attention once a layer, the norm twice a layer and
    once at the end, and the GEMV for q, k, v and o and the dense MLP's
    FCs (two non-gated, three gated; none for a MoE FFN, whose experts are
    batched matmuls) a layer; a chunk runs flash (segmented when packed)
    once a layer and the norm twice."""
    n = cfg.num_layers
    mlp = 0 if cfg.is_moe else (3 if cfg.act == "silu" else 2)
    flash = "flash_attention_segmented" if packed else "flash_attention"
    step = {"decode_attention": n, "layernorm": 2 * n + 1,
            "pim_matvec": (4 + mlp) * n}
    return step, {flash: n, "layernorm": 2 * n}


def check_launches(serve: dict, cfg, packed: bool) -> None:
    """A serve's launches a decode step and a prefill dispatch are exactly
    ``path_launches``'s, and no other kernel launched."""
    step, chunk = path_launches(cfg, packed)
    for got, want, what in ((serve["launches_per_decode_step"], step,
                             "decode step"),
                            (serve["launches_per_prefill_dispatch"], chunk,
                             "prefill dispatch")):
        if {k: v for k, v in got.items() if v} != want:
            fail(f"{serve['phase']}: launches a {what} {got}, expected "
                 f"{want}")


def weights(torch, cfg, name: str):
    """``cfg``'s bf16 weights from a seed on the card, with their bytes."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    t0 = time.perf_counter()
    params = init_params(T.param_defs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    log(f"{name} weights ({cfg.num_layers} layers): {n_bytes} bytes in "
        f"{time.perf_counter() - t0:.1f} s")
    return params, n_bytes


def attention_serves(torch, cfg, params, phase: str, name: str,
                     checks=None) -> dict:
    """Phase 3's serve and 3b's packed one on ``cfg``: one unmeasured serve
    of each, then two measured ones in turns (unpacked, packed, packed,
    unpacked), each with exactly ``path_launches``'s kernels; the two
    serves of a kind must give the same tokens. With ``checks``, each
    measured serve is recorded for phase 13."""
    decode = ["decode_attention", "pim_matvec", "layernorm"]
    variants = (("unpacked", ["flash_attention"] + decode, {}),
                ("packed", ["flash_attention_segmented"] + decode,
                 dict(pack=True)))
    t0 = time.perf_counter()
    for _, _, kw in variants:
        serve_engine(cfg, params, **kw).run_until_done()
    log(f"phase {phase} warm-up took {time.perf_counter() - t0:.1f} s")
    runs = {v: [] for v, *_ in variants}
    for v, required, kw in variants + variants[::-1]:
        t0 = time.perf_counter()
        r = full_width_serve(torch, cfg, params, f"{phase} {name} {v}",
                             required, record=checks is not None, **kw)
        if checks is not None:
            checks.add(f"{phase} {name} {v} {len(runs[v]) + 1}",
                       [r.pop("trace")])
        check_launches(r, cfg, packed=bool(kw))
        runs[v].append(r)
        log(f"phase {phase} {v} took {time.perf_counter() - t0:.1f} s")
    out = {}
    for v, (a, b) in runs.items():
        out[v] = two_serves(a, b)
        if not out[v]["same_tokens_both_runs"]:
            fail(f"{phase} {name} {v}: two serves of the same requests gave "
                 f"other tokens")
        log(f"serve {phase} {name} {v} " + json.dumps(
            {k: w for k, w in out[v].items() if k != "tokens"}))
    return out


def gpt2_serves(torch, checks) -> dict:
    """Phases 10 and 10b: gpt2-xl and gpt2-2.5b (the paper's Table 3) at
    full width and depth, bf16, unpacked and packed; gpt2-xl also under
    phase 9's arrivals with ``serial`` + pack and ``pim_aware`` + pack +
    fuse + superstep 4 (the launches of phase 10's own serves a decode
    round and a packed chunk), then one profiled short serve (phase 10's
    prompts, 8 new tokens each). Phase 10c: gpt2-2.5b at depth 2 in
    float32, card against CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.trace import drive

    out = {}
    for name, phase in (("gpt2-xl", "10"), ("gpt2-2.5b", "10b")):
        cfg = get_arch(name)
        t_phase = time.perf_counter()
        params, n_bytes = weights(torch, cfg, name)
        out[phase] = attention_serves(torch, cfg, params, phase, name)
        out[phase]["weight_bytes"] = n_bytes
        if phase == "10":
            per_round = out[phase]["unpacked"]["launches_per_decode_step"]
            per_chunk = out[phase]["packed"]["launches_per_prefill_dispatch"]
            arrivals = policy_arrivals(cfg.vocab_size)
            for pname, kw in (POLICY_SERVES[0], POLICY_SERVES[2]):
                t0 = time.perf_counter()
                drive(policy_engine(cfg, params, **kw), arrivals)
                r = policy_serve(torch, cfg, params, pname, kw, per_round,
                                 per_chunk, phase="10")
                checks.add(f"10 {name} {pname}", [r.pop("trace")])
                out[phase][pname] = {k: v for k, v in r.items()
                                     if k != "results"}
                log(f"phase 10 {pname} took {time.perf_counter() - t0:.1f} "
                    f"s; serve " + json.dumps(out[phase][pname]))
            t0 = time.perf_counter()
            eng = serve_engine(cfg, params, max_new=8)
            prof = device_profile(torch, eng.run_until_done)
            out[phase]["profile"] = prof
            del eng
            log(f"profile 10 {name} (8 new tokens each; took "
                f"{time.perf_counter() - t0:.1f} s) " + json.dumps(prof))
        del params
        torch.cuda.empty_cache()
        log(f"phase {phase} took {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    depth2_parity(torch, dataclasses.replace(
        get_arch("gpt2-2.5b"), num_layers=2, dtype="float32"), "gpt2-2.5b",
        variants=({}, dict(pack=True)))
    log(f"phase 10c took {time.perf_counter() - t0:.1f} s")
    return out


def moe_serves(torch) -> dict:
    """Phase 11: qwen3-moe-30b-a3b at its published widths, cut to 12 of
    48 layers, bf16, unpacked and packed (batched and packed prefill
    through MoE), then one profiled unpacked serve. Phase 11b: depth 2 in
    float32, card against CPU."""
    from repro_torch.configs import get_arch

    full = get_arch("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(full, num_layers=12)
    log(f"phase 11: {full.name} cut to {cfg.num_layers} of "
        f"{full.num_layers} layers")
    t_phase = time.perf_counter()
    params, n_bytes = weights(torch, cfg, full.name)
    out = attention_serves(torch, cfg, params, "11", full.name)
    out["weight_bytes"] = n_bytes
    t0 = time.perf_counter()
    eng = serve_engine(cfg, params)
    out["profile"] = device_profile(torch, eng.run_until_done)
    log(f"profile 11 {full.name} (took {time.perf_counter() - t0:.1f} s) "
        + json.dumps(out["profile"]))
    del eng, params
    torch.cuda.empty_cache()
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    depth2_parity(torch, dataclasses.replace(full, num_layers=2,
                                             dtype="float32"), full.name,
                  variants=({}, dict(pack=True)))
    log(f"phase 11b took {time.perf_counter() - t0:.1f} s")
    return out


def empty_card(torch) -> int:
    """Collect the earlier phases' garbage (an engine in a reference cycle
    with its recorder holds its cache until a collection) and hand the
    cached blocks back; returns the bytes still allocated."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def kimi_step(torch) -> dict:
    """Phase 11c: kimi-k2-1t-a32b's prefill step at its published widths
    (d 7168, 64 / 8 heads of 112, 384 experts), cut to 1 of 61 layers, on
    B 2 x S 1024: flash at D 112 once, logits finite. It runs on an empty
    card: every earlier phase's tensors must be gone first."""
    from repro_torch.configs import get_arch

    held = empty_card(torch)
    if held > 2**30:
        fail(f"11c: {held} bytes still allocated before kimi-k2's weights")
    full = get_arch("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(full, num_layers=1)
    log(f"phase 11c: {full.name} cut to {cfg.num_layers} of "
        f"{full.num_layers} layers; {held} bytes allocated before it")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params, n_bytes = weights(torch, cfg, full.name)
    init_peak = torch.cuda.max_memory_allocated()
    step = prefill_step_run(torch, cfg, params, "11c kimi-k2 prefill step",
                            {"flash_attention": 1}, B=2, S=1024)
    step.update(weight_bytes=n_bytes, allocated_before=held,
                max_memory_allocated_init=init_peak)
    log("step " + json.dumps(step))
    del params
    torch.cuda.empty_cache()
    log(f"phase 11c took {time.perf_counter() - t0:.1f} s")
    return step


# --------------------------------------------------------------------------- #
# phases 12-12c: fleet serving, chaos failover and KV snapshots
# --------------------------------------------------------------------------- #
BENCH_DATA = os.path.join(ROOT, "benchmarks", "data")
# the chaos guard's gated chaos counts and snapshot counts
CHAOS_GUARDED = ("goodput", "completed", "offered", "recovered",
                 "reprefill_tokens", "crash_inflight")
SNAP_GUARDED = ("events", "rows", "restores", "saved_tokens", "paid_tokens")
# phase 12b: a fleet at phase 3's serving shape and knobs, node 1 crashing
# after the second snapshot interval (a ready slot's prefix is restored)
SERVING_FLEET = dict(
    serve=dict(max_slots=8, max_len=1024, prefill_chunk=128,
               policy="interleaved", pack=True, fuse=True, superstep=4),
    workload=dict(rate=1.0, horizon=24, burst=6, idle=6, prompt_len=(64, 700),
                  max_new=(16, 32), seed=3),
    replicas=3, routing="least_loaded", crash="node_crash,node=1,step=18",
    snapshot=dict(snapshot_interval=8, snapshot_mirror=True))


def bench_json(name: str) -> dict:
    with open(os.path.join(BENCH_DATA, name)) as f:
        return json.load(f)


def fleet_inputs(serve: dict, wl: dict, vocab: int):
    """A ``ServeConfig`` and the bursty arrivals of a workload as the
    baselines write them (lists for tuples), prompts drawn below
    ``vocab``."""
    from repro_torch.serve import ServeConfig
    from repro_torch.trace import bursty_arrivals

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}
    wl = tup(wl)
    return ServeConfig(**tup(serve)), bursty_arrivals(
        wl["rate"], wl["horizon"], vocab=vocab, burst=wl["burst"],
        idle=wl["idle"], prompt_len=wl["prompt_len"],
        max_new=wl["max_new"], seed=wl["seed"])


def trace_work(trace):
    """Decode rounds run on the card (a superstep's k, dead rounds
    included; a fused step's one) and prefill chunks (a fused step's one)
    of one node's trace."""
    decodes = trace.of_type("decode")
    supersteps = {e["superstep_id"]: e["superstep"] for e in decodes
                  if e["superstep"] > 1}
    rounds = sum(e["superstep"] == 1 for e in decodes) \
        + sum(supersteps.values())
    return rounds, len(trace.of_type("prefill"))


@contextlib.contextmanager
def fleet_clocks(torch):
    """Within it, every ``ServeEngine.step``, KV export and KV import is
    bracketed by CUDA events (no host sync), with the step's kind and
    decode rounds; yields the records, keyed by ``id(engine)``."""
    from repro_torch.serve.engine import ServeEngine

    rec = {"steps": {}, "exports": [], "imports": []}
    orig = {n: getattr(ServeEngine, n) for n in
            ("step", "export_kv_snapshot", "import_kv_snapshot")}

    def events():
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        return a, b

    def step(self):
        before, tick = dict(self.scheduler.stats), self.step_idx
        a, b = events()
        out = orig["step"](self)
        b.record()
        kind = next(k for k, v in self.scheduler.stats.items()
                    if k != "steps" and v != before[k])
        rounds = self.step_idx - tick if kind == "superstep" \
            else int(kind not in ("prefill_only", "idle"))
        rec["steps"].setdefault(id(self), []).append(
            (kind, rounds, tick, a, b))
        return out

    def export(self, since=None):
        a, b = events()
        out = orig["export_kv_snapshot"](self, since)
        b.record()
        rec["exports"].append((sum(e["bytes"] for e in out), a, b))
        return out

    def restore(self, slot, snapshot, **kw):
        a, b = events()
        orig["import_kv_snapshot"](self, slot, snapshot, **kw)
        b.record()
        rec["imports"].append((int(snapshot["prefix_len"]),
                               int(snapshot.get("bytes", 0)), a, b))

    ServeEngine.step = step
    ServeEngine.export_kv_snapshot = export
    ServeEngine.import_kv_snapshot = restore
    try:
        yield rec
    finally:
        for n, fn in orig.items():
            setattr(ServeEngine, n, fn)


def measured_fleet(torch, name: str, cfg, run, launches_per=None) -> dict:
    """One fleet run (``run()`` returns a ``FleetResult`` or a
    ``ChaosResult``) under CUDA's sync debug mode, launch counts set to 0
    just before and read just after. Fails unless the host synced once per
    decode, superstep or fused dispatch of every node, a blocking transfer
    ran once per KV export and no other, and (``launches_per``: a decode
    round's and a packed chunk's) the kernels launched exactly that many
    times for the rounds and chunks the nodes' traces record. The run's
    engines (and their caches) are dropped from the result it returns, so
    that each run's peak memory is its own."""
    import gc
    import warnings

    from repro_torch.kernels import ops

    gc.collect()                    # earlier runs' engines (recorder cycles)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with fleet_clocks(torch) as clocks, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            res = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    hidden = [str(w.message) for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    engines = res.engines
    dc = {k: sum(e.dispatch_counts[k] for e in engines.values())
          for k in ("prefill", "decode", "fused")}
    syncs = sum(e.host_syncs for e in engines.values())
    transfers = sum(e.export_transfers for e in engines.values())
    export_syncs = sum(e.snapshot_stats["export_syncs"]
                       for e in engines.values())
    if syncs != dc["decode"] + dc["fused"] or len(hidden) != transfers:
        fail(f"{name}: {syncs} host syncs for {dc}; {len(hidden)} blocking "
             f"transfers beside them for {transfers} KV exports "
             f"({hidden[:1]})")
    work = [trace_work(t) for t in res.traces.values()]
    rounds, chunks = (sum(col) for col in zip(*work))
    if launches_per is not None:
        per_round, per_chunk = launches_per
        want = {k: per_round.get(k, 0) * rounds + per_chunk.get(k, 0) * chunks
                for k in counts}
        if counts != want:
            fail(f"{name}: launches {counts}, expected {want} for {rounds} "
                 f"decode rounds and {chunks} prefill chunks")
    ticks = max(e.step_idx for e in engines.values())
    node_of = {id(e): n for n, e in engines.items()}
    per_node, step_ms = {}, {}
    for key, steps in clocks["steps"].items():
        node = node_of[key]
        step_ms[node] = [(tick, a.elapsed_time(b))
                         for _, _, tick, a, b in steps]
        dec = [(r, a.elapsed_time(b)) for k, r, _, a, b in steps
               if k in PURE_DECODE]
        per_node[node] = dict(
            steps=len(steps), device_ms=sum(ms for _, ms in step_ms[node]),
            ms_per_decode_round=(sum(ms for _, ms in dec)
                                 / max(sum(r for r, _ in dec), 1)))
    res.engines = {}
    exp_bytes = sum(n for n, _, _ in clocks["exports"])
    exp_ms = sum(a.elapsed_time(b) for _, a, b in clocks["exports"])
    return dict(
        phase=name, result=res, step_ms=step_ms, wall_s=wall,
        fleet_ticks=ticks,
        ms_per_fleet_tick=1e3 * wall / ticks, dispatch_counts=dc,
        host_syncs=syncs, decode_rounds=rounds, prefill_chunks=chunks,
        launches=counts, export_transfers=transfers,
        blocking_transfers=len(hidden), export_syncs=export_syncs,
        export_bytes=exp_bytes, export_ms=exp_ms,
        export_gb_s=exp_bytes / exp_ms / 1e6 if exp_ms else None,
        restores=[dict(prefix_len=p, bytes=n, ms=a.elapsed_time(b))
                  for p, n, a, b in clocks["imports"]],
        nodes=dict(sorted(per_node.items())),
        max_memory_allocated=torch.cuda.max_memory_allocated())


def logged(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("result", "step_ms")}


def recovery_windows(run: dict) -> list:
    """Each recovered request on its survivor: from its placement to its
    first new token, the ticks and the device ms of the survivor's steps
    in between (its re-prefill, beside whatever else those steps ran)."""
    res, out = run["result"], []
    for r in res.recoveries:
        first = next(e["step"] for e in res.traces[r["node"]].of_type(
            "decode") if any(rid == r["rid"] for rid, _ in e["tokens"]))
        out.append(dict(
            gid=r["gid"], restored_tokens=r["restored_tokens"],
            reprefill_tokens=r["reprefill_tokens"],
            ticks=first - r["step"],
            device_ms=sum(ms for tick, ms in run["step_ms"][r["node"]]
                          if r["step"] <= tick <= first)))
    return out


def agreement(run, ref) -> float:
    """The share of arrivals whose tokens equal the fault-free run's."""
    got, want = run.tokens_by_gid(), ref.tokens_by_gid()
    return sum(got.get(g) == t for g, t in want.items()) / len(want)


def check_chaos(name: str, free, chaos, snap, row_bytes: int) -> dict:
    """The chaos guard's invariants that hold whatever the weights: goodput
    1.0, nothing failed or rejected, at least one restore, and saved +
    paid re-prefill equal to the from-zero run's; snapshot bytes are rows
    x the model's row size."""
    from repro_torch.fleet import FleetMetrics

    c = FleetMetrics.from_traces(chaos.traces).chaos_summary()
    sc = FleetMetrics.from_traces(snap.traces).chaos_summary()
    sn = sc["snapshots"]
    for label, s, run in (("chaos", c, chaos), ("snapshot", sc, snap)):
        if s["goodput"] != 1.0 or run.failed or run.rejected \
                or s["completed"] != len(free.tokens_by_gid()):
            fail(f"{name} {label}: goodput {s['goodput']}, failed "
                 f"{run.failed}, rejected {run.rejected}")
    if not sn["restores"] or sn["saved_tokens"] + sc["reprefill_tokens"] \
            != c["reprefill_tokens"]:
        fail(f"{name}: {sn['restores']} restores; saved "
             f"{sn['saved_tokens']} + paid {sc['reprefill_tokens']} != "
             f"from-zero {c['reprefill_tokens']}")
    if sn["bytes"] != sn["rows"] * row_bytes:
        fail(f"{name}: {sn['bytes']} snapshot bytes for {sn['rows']} rows "
             f"of {row_bytes} bytes")
    return dict(chaos=c, snapshot=sc)


def baseline_vocab() -> int:
    """The vocabulary the guards draw their prompts below: the reduced
    llama3.2-1b's (``prefix_affinity`` routes on the prompts' tokens, so a
    baseline's routing holds only for its own prompts; they are valid
    tokens of the full model too)."""
    from repro_torch.configs import get_arch
    return get_arch("llama3.2-1b").reduced().vocab_size


def kv_row_bytes(cfg) -> int:
    """One token's K and V over every layer, in the cache's type."""
    return cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2


def chaos_fleet(torch, checks) -> dict:
    """Phase 12: the chaos guard's fleet (``benchmarks/data/
    chaos_baseline.json``'s serve, workload, plan and snapshot knobs) at
    full llama3.2-1b width and depth in bf16, fault-free, under the plan,
    and under the plan with mirrored snapshots; then
    ``fleet_baseline.json``'s two-replica fleet under each routing
    policy. The tick schedule does not depend on the weights (the
    workload ends by budget), so the counts must equal the baselines'."""
    from repro_torch.chaos import FaultPlan, serve_fleet_chaos
    from repro_torch.configs import get_arch
    from repro_torch.fleet import FleetMetrics, serve_fleet

    base = bench_json("chaos_baseline.json")
    cfg = get_arch("llama3.2-1b")
    params, n_bytes = weights(torch, cfg, cfg.name)
    w = base["workload"]
    scfg, arrivals = fleet_inputs(w["serve"], w["workload"],
                                  baseline_vocab())
    plan = FaultPlan.load(os.path.join(BENCH_DATA, "chaos_plan.json"))
    if plan.to_dict() != w["plan"]:
        fail("12: chaos_plan.json is not the baseline's plan")
    kw = dict(replicas=w["replicas"], routing=w["routing"], device="cuda")
    per = path_launches(cfg, packed=True)
    t0 = time.perf_counter()
    serve_fleet(cfg, params, scfg, arrivals, **kw)       # warm-up
    log(f"phase 12 warm-up took {time.perf_counter() - t0:.1f} s")
    runs = {}
    for label, fn in (
            ("fault-free", lambda: serve_fleet(cfg, params, scfg, arrivals,
                                               **kw)),
            ("chaos", lambda: serve_fleet_chaos(cfg, params, scfg, arrivals,
                                                plan, **kw)),
            ("snapshot", lambda: serve_fleet_chaos(
                cfg, params, scfg, arrivals, plan, **w["snapshot"], **kw))):
        runs[label] = measured_fleet(torch, f"12 {label}", cfg, fn, per)
        checks.add(f"12 {label}", runs[label]["result"].traces.values(),
                   fleet=True)
        log(f"fleet 12 {label} " + json.dumps(logged(runs[label])))
    free, chaos, snap = (runs[k]["result"] for k in runs)
    sums = check_chaos("12", free, chaos, snap, kv_row_bytes(cfg))
    c, sc = sums["chaos"], sums["snapshot"]
    got = dict(chaos={k: c[k] for k in CHAOS_GUARDED},
               mttr_ticks=json.loads(json.dumps(c["mttr_ticks"])),
               faults=c["faults"], recoveries=len(chaos.recoveries),
               failed=sorted(chaos.failed), rejected=sorted(chaos.rejected))
    want = {k: base[k] for k in got}
    snap_got = {k: sc["snapshots"][k] for k in SNAP_GUARDED}
    if got != want or snap_got != {k: base["snapshots"][k]
                                   for k in SNAP_GUARDED}:
        fail(f"12: chaos {got} / snapshots {snap_got} against the baseline "
             f"{want} / {base['snapshots']}")
    out = {label: logged(r) for label, r in runs.items()}
    for label in ("chaos", "snapshot"):
        out[label]["bf16_token_agreement"] = agreement(
            runs[label]["result"], free)
    out["summary"] = dict(chaos=got, snapshots=sc["snapshots"],
                          reprefill_tokens=[c["reprefill_tokens"],
                                            sc["reprefill_tokens"]],
                          bf16_token_agreement=[out[k][
                              "bf16_token_agreement"] for k in
                              ("chaos", "snapshot")])
    log("fleet 12 summary " + json.dumps(out["summary"]))
    # fleet_baseline.json: 2 replicas under each routing policy
    fb = bench_json("fleet_baseline.json")
    fw = fb["workload"]
    fscfg, farr = fleet_inputs(fw["serve"], fw, baseline_vocab())
    for routing, want in fb["policies"].items():
        r = measured_fleet(torch, f"12 fleet {routing}", cfg,
                           lambda: serve_fleet(
                               cfg, params, fscfg, farr,
                               replicas=fw["replicas"], routing=routing,
                               device="cuda"), per)
        checks.add(f"12 fleet {routing}", r["result"].traces.values(),
                   fleet=True)
        fm = FleetMetrics()
        for n, hub in r["result"].hubs.items():
            fm.add(n, hub)
        s = json.loads(json.dumps(fm.summary()))
        got = dict(requests=s["requests"]["arrived"],
                   tokens=s["requests"]["tokens_generated"],
                   **{k: s[k] for k in ("ttft_ticks", "tpot_ticks",
                                        "queue_wait_ticks")})
        out[f"fleet {routing}"] = dict(logged(r), ttft_ticks=s["ttft_ticks"])
        log(f"fleet 12 fleet {routing} " + json.dumps(out[f"fleet {routing}"]))
        if got != {k: want[k] for k in got}:
            fail(f"12 fleet {routing}: {got} against the baseline {want}")
    del params
    torch.cuda.empty_cache()
    return out


def serving_fleet(torch, checks) -> dict:
    """Phase 12b: ``SERVING_FLEET``, a fleet at phase 3's serving shape
    (full llama3.2-1b, bf16), fault-free, crashed from zero and crashed
    with mirrored snapshots: goodput 1.0, a restore, saved + paid equal to
    the from-zero cost; the card's numbers logged (ms per fleet tick and
    per decode round of each node, the KV exports' bytes, ms and GB/s to
    the host, each restore's ms, the device ms of the steps that re-prefill
    recovered requests, p50/p99 TTFT/TPOT in ticks, peak memory)."""
    from repro_torch.chaos import FaultPlan, serve_fleet_chaos
    from repro_torch.configs import get_arch
    from repro_torch.fleet import FleetMetrics, serve_fleet

    cfg = get_arch("llama3.2-1b")
    params, _ = weights(torch, cfg, cfg.name)
    f = SERVING_FLEET
    scfg, arrivals = fleet_inputs(f["serve"], f["workload"],
                                  cfg.vocab_size)
    plan = FaultPlan.from_spec(f["crash"])
    kw = dict(replicas=f["replicas"], routing=f["routing"], device="cuda")
    per = path_launches(cfg, packed=True)
    runs = {}
    for label, fn in (
            ("fault-free", lambda: serve_fleet(cfg, params, scfg, arrivals,
                                               **kw)),
            ("from-zero", lambda: serve_fleet_chaos(
                cfg, params, scfg, arrivals, plan, **kw)),
            ("snapshot", lambda: serve_fleet_chaos(
                cfg, params, scfg, arrivals, plan, **f["snapshot"], **kw))):
        t0 = time.perf_counter()
        runs[label] = measured_fleet(torch, f"12b {label}", cfg, fn, per)
        checks.add(f"12b {label}", runs[label]["result"].traces.values(),
                   fleet=True)
        log(f"phase 12b {label} took {time.perf_counter() - t0:.1f} s")
    free, zero, snap = (runs[k]["result"] for k in runs)
    sums = check_chaos("12b", free, zero, snap, kv_row_bytes(cfg))
    out = {}
    for label, r in runs.items():
        fm = FleetMetrics()
        for n, hub in r["result"].hubs.items():
            fm.add(n, hub)
        s = fm.summary()
        out[label] = dict(logged(r), requests=len(arrivals), **{
            m: {q: s[m][q] for q in ("p50", "p99", "mean", "count")}
            for m in ("ttft_ticks", "tpot_ticks", "queue_wait_ticks")})
        if label != "fault-free":
            res = r["result"]
            out[label]["recoveries"] = recovery_windows(r)
            out[label]["bf16_token_agreement"] = agreement(res, free)
            out[label]["chaos"] = {k: v for k, v in
                                   sums["chaos" if label == "from-zero"
                                        else "snapshot"].items()
                                   if k not in ("mttr_ticks",)}
        log(f"fleet 12b {label} " + json.dumps(out[label]))
    log("12b re-prefill tokens paid from zero and with snapshots: "
        + json.dumps([sums["chaos"]["reprefill_tokens"],
                      sums["snapshot"]["reprefill_tokens"]]))
    del params
    torch.cuda.empty_cache()
    return out


def fleet_parity(torch, checks) -> None:
    """Phase 12c: the chaos guard's fleet at full llama3.2-1b width, depth
    2, float32: on the card the chaos and snapshot runs give the
    fault-free run's tokens for every arrival, and the fault-free fleet
    gives the same tokens, assignments, dispatches and host syncs as the
    port's plain versions on the CPU. The card's fleets go to phase 13."""
    from repro_torch.chaos import FaultPlan, serve_fleet_chaos
    from repro_torch.configs import get_arch
    from repro_torch.fleet import serve_fleet
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    params = init_params(T.param_defs(cfg),
                         torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")

    def tree(fn, t):
        return {k: tree(fn, v) for k, v in t.items()} \
            if isinstance(t, dict) else fn(t)
    params = {"cuda": tree(lambda a: a.float(), params)}
    params["cpu"] = tree(lambda a: a.cpu(), params["cuda"])
    base = bench_json("chaos_baseline.json")
    w = base["workload"]
    scfg, arrivals = fleet_inputs(w["serve"], w["workload"],
                                  baseline_vocab())
    plan = FaultPlan.from_dict(w["plan"])
    kw = dict(replicas=w["replicas"], routing=w["routing"])

    def facts(res):
        return dict(tokens=res.tokens_by_gid(), assignments=res.assignments,
                    dispatches={n: e.dispatch_counts
                                for n, e in res.engines.items()},
                    host_syncs={n: e.host_syncs
                                for n, e in res.engines.items()})
    runs = {dev: serve_fleet(cfg, params[dev], scfg, arrivals, device=dev,
                             **kw) for dev in ("cuda", "cpu")}
    checks.add("12c fault-free", runs["cuda"].traces.values(), fleet=True)
    free = {dev: facts(res) for dev, res in runs.items()}
    if free["cuda"] != free["cpu"]:
        diff = [k for k in free["cuda"] if free["cuda"][k] != free["cpu"][k]]
        fail(f"12c fault-free fleet: card != CPU in {diff}")
    for label, extra in (("chaos", {}), ("snapshot", w["snapshot"])):
        res = serve_fleet_chaos(cfg, params["cuda"], scfg, arrivals, plan,
                                device="cuda", **extra, **kw)
        checks.add(f"12c {label}", res.traces.values(), fleet=True)
        got = res.tokens_by_gid()
        bad = [g for g, t in free["cuda"]["tokens"].items() if got.get(g) != t]
        if bad or res.failed or res.rejected or not res.recoveries:
            fail(f"12c {label}: tokens differ from the fault-free run's for "
                 f"gids {bad}; {len(res.recoveries)} recoveries")
        log(f"parity float32 depth 2, 12c {label}: {len(got)} arrivals give "
            f"the fault-free tokens after {len(res.recoveries)} recoveries "
            f"(restored tokens "
            f"{[r['restored_tokens'] for r in res.recoveries]})")
    log(f"parity float32 depth 2, 12c fault-free fleet: tokens, "
        f"assignments, dispatches and host syncs identical on cuda and cpu")
    del params, runs, res
    torch.cuda.empty_cache()


FLEET_PHASES = {"12": chaos_fleet, "12b": serving_fleet, "12c": fleet_parity}


# --------------------------------------------------------------------------- #
# phases 14-15b: whisper-medium's encoder-decoder, pixtral-12b's patches
# --------------------------------------------------------------------------- #
def flash_key(B, H, KH, Sq, Skv, D, causal=True, off=0) -> str:
    return (f"flash_attention B{B} H{H}/{KH} Sq{Sq} Skv{Skv} off{off} D{D} "
            + ("causal" if causal else "non-causal"))


def decode_key(B, H, KH, L, D) -> str:
    return f"decode_attention B{B} H{H}/{KH} L{L} D{D}"


def gemv_key(label: str) -> str:
    return f"pim_matvec {label}"


def rwkv_key(BH, T, K, bwd: bool = False) -> str:
    return f"rwkv_chunk{'_bwd' if bwd else ''} BH{BH} T{T} K{K}"


def mamba_key(B, T, d, n) -> str:
    return f"mamba_chunk B{B} T{T} d{d} n{n}"


def bwd_key(B, H, KH, Sq, Skv, D, causal=True) -> str:
    return (f"flash_attention_bwd B{B} H{H}/{KH} Sq{Sq} Skv{Skv} D{D} "
            + ("causal" if causal else "non-causal"))


# the dispatch layer's kernel wrappers that ``launch_shapes`` wraps: the
# kernel whose launch count each adds to, and the key of a call from its
# arguments
SHAPE_KEYS = {
    "_flash": ("flash_attention", lambda q, k, v, causal=True, q_offset=0,
               **_: flash_key(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                              k.shape[2], q.shape[3], causal, q_offset)),
    "_decode": ("decode_attention", lambda q, k, v, lengths,
                return_lse=False: decode_key(
                    q.shape[0], q.shape[1], k.shape[1], k.shape[2],
                    q.shape[2]) + (" partial" if return_lse else "")),
    "_matvec": ("pim_matvec", lambda x, w, bias=None, activation="none":
                gemv_key(f"n{x.shape[0]} {w.shape[0]}->{w.shape[1]} "
                         f"{activation}")),
    "_rwkv_chunk": ("rwkv_chunk", lambda r, *_, **__: rwkv_key(*r.shape)),
    "_rwkv_chunk_bwd": ("rwkv_chunk_bwd", lambda r, *_, **__: rwkv_key(
        *r.shape, bwd=True)),
    "_mamba_chunk": ("mamba_chunk", lambda a, *_, **__: mamba_key(*a.shape)),
    "_flash_bwd": ("flash_attention_bwd", lambda q, k, v, o, lse, do,
                   causal=True: bwd_key(q.shape[0], q.shape[1], k.shape[1],
                                        q.shape[2], k.shape[2], q.shape[3],
                                        causal)),
}


@contextlib.contextmanager
def launch_shapes(ops, on: bool):
    """With ``on``, each launch of the flash kernel and its backward, decode
    attention, the GEMV, the wkv and its backward and the Mamba scan is
    tallied by its key in ``SHAPE_KEYS``: the kernels count their
    launches, this says at which shape they ran (a call adds what it
    added to its kernel's count: the GEMV launches once per 8 rows). The
    port has no such hook; this wraps the dispatch layer's wrappers and
    restores them after. The tally is None without ``on`` (on the CPU no
    kernel launches)."""
    import collections

    if not on:
        yield None
        return
    tally = collections.Counter()
    saved = {name: getattr(ops, name) for name in SHAPE_KEYS}

    def counted(name, fn):
        kernel, key = SHAPE_KEYS[name]

        def call(*a, **k):
            before = ops.KERNELS[kernel].launches
            out = fn(*a, **k)
            tally[key(*a, **k)] += ops.KERNELS[kernel].launches - before
            return out
        return call
    for name, fn in saved.items():
        setattr(ops, name, counted(name, fn))
    try:
        yield tally
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def check_shapes(tag: str, tally, plan: dict) -> dict:
    """The tally of a run (None off the card: nothing to check) against
    its ``plan`` {key: launches}: for every kernel the plan names, the
    tally's keys of that kernel must be the plan's, with its counts."""
    if tally is None:
        return None
    kinds = {k.split()[0] for k in plan}
    got = {k: n for k, n in tally.items() if k.split()[0] in kinds and n}
    want = {k: n for k, n in plan.items() if n}
    if got != want:
        diff = {k: [got.get(k, 0), want.get(k, 0)] for k in
                sorted(set(got) | set(want)) if got.get(k) != want.get(k)}
        raise RuntimeError(f"{tag}: launches by shape differ from the plan "
                           f"(counted, planned): {diff}")
    return dict(tally)


# what whisper-medium's steps launch: the prefill step runs flash once an
# encoder layer (non-causal, 1,500 frames) and twice a decoder layer (its
# causal self attention; its cross attention, non-causal, against the
# frames), the norm twice an encoder layer and three times a decoder layer
# and once after each stack; a decode step runs decode attention twice a
# layer (self, cross), the GEMV 8 times a layer (q, k, v, o; the cross
# attention's q and o; the MLP's two) and the norm 3 L + 1 times
NO_LAUNCH = {"flash_attention": 0, "flash_attention_segmented": 0,
             "decode_attention": 0, "pim_matvec": 0, "layernorm": 0,
             "rwkv_chunk": 0, "masked_softmax": 0, "mamba_chunk": 0,
             "flash_attention_bwd": 0, "layernorm_bwd": 0,
             "rwkv_chunk_bwd": 0, "mamba_chunk_bwd": 0}


def whisper_launches(cfg) -> tuple:
    L, E = cfg.num_layers, cfg.encoder_layers
    step = dict(NO_LAUNCH, flash_attention=E + 2 * L,
                layernorm=2 * E + 1 + 3 * L + 1)
    decode = dict(NO_LAUNCH, decode_attention=2 * L, pim_matvec=8 * L,
                  layernorm=3 * L + 1)
    return step, decode


def whisper_prompts(vocab: int):
    """The 8 prompts of the whisper serves, lengths from a seed in 4-32."""
    import numpy as np
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, int(p)) for p in rng.integers(4, 33, 8)]


def whisper_generate(torch, cfg, params, dev: str, frames, prompt,
                     n_steps: int) -> dict:
    """``prefill_with_cache`` of ``prompt`` (B, S) with ``frames`` (the
    encoder, each layer's cross cache filled once, S teacher-forced decode
    steps), then ``n_steps`` greedy ``decode_step``s against the filled
    cross cache, the next token chosen on the device. On the card: the
    launches of the prefill and of each decode step, the whole run's by
    shape (``launch_shapes``), and the decode's ms a step by CUDA
    events."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (init_params, local_defs,
                                           resident_axes)
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import _current_mesh

    # a vocabulary split over 'model' (the reduced config's 256 on a
    # mesh): the ranks' (max, global index) merged
    split, lo = L.vocab_shard(params["embed"], cfg.vocab_size)

    def argmax(logits):
        return comm.sharded_argmax(logits, lo, split)

    B = prompt.shape[0]
    # under a mesh (phase 23c) the rank's part of the cache
    cache = init_params(local_defs(T.cache_defs(cfg, B, 448),
                                   _current_mesh(), resident_axes(cfg)),
                        device=dev)
    prompt, frames = prompt.to(dev), frames.to(dev)
    on_card = dev == "cuda"
    if on_card:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
    with launch_shapes(ops, on_card) as tally:
        logits, cache, lens = T.prefill_with_cache(
            cfg, params, prompt, cache, frame_embeds=frames)
        tok = argmax(logits)
        out = {}
        if on_card:
            out["prefill_launches"] = ops.launch_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            ev[0].record()
        toks = [tok]
        for _ in range(n_steps):
            logits, cache = T.decode_step(cfg, params, tok[:, None], cache,
                                          lens)
            tok = argmax(logits)
            lens = lens + 1
            toks.append(tok)
    out["by_shape"] = tally
    if on_card:
        ev[1].record()
        torch.cuda.synchronize()
        out["decode_launches"] = ops.launch_counts()
        out["ms_per_decode_step"] = ev[0].elapsed_time(ev[1]) / n_steps
    if float(cache["pos0"]["ck"].float().abs().amax()) == 0:
        fail(f"whisper generate on {dev}: the cross cache was not filled")
    out["tokens"] = torch.stack(toks, 1).cpu().tolist()
    return out


def whisper_batch(torch, cfg, B: int, S: int, seed: int, dtype):
    """``batch_for``'s tokens and frames (in ``dtype``) on the card."""
    from repro_torch.data import batch_for
    b = batch_for(cfg, B, S, seed=seed)
    return {"tokens": torch.from_numpy(b["tokens"]).to("cuda"),
            "frame_embeds": torch.from_numpy(b["frame_embeds"]).to(
                "cuda", dtype)}


def whisper_phases(torch, checks) -> dict:
    """Phase 14: whisper-medium at full width and depth (24 encoder and 24
    decoder layers), bf16, weights from a seed, frames from ``batch_for``
    in bf16: (a) the prefill step at B 2, 1,500 frames and 448 decoder
    tokens, each call launching exactly ``whisper_launches``'s kernels,
    flash 48 times non-causal and 24 times causal, then one profiled
    call; (b) ``prefill_with_cache``
    for 8 rows of 16 tokens with frames, then 32 greedy decode steps
    against the filled cross cache, twice, with identical tokens and each
    step's launches exact (decode attention over the 1,500 frames once a
    layer); (c) the engine serves 8 requests (prompts of 4-32 tokens, 16
    new, ``max_len`` 448) twice after an unmeasured serve: identical
    tokens, sequential prefill (one dispatch a prompt token but the last),
    one host sync a decode step and no hidden one, the launches of a
    decode step in every dispatch, each serve recorded for phase 13; then
    the bf16 bound of 3d on the prefill step and on the first decode step
    after a wave of the prompts cut to 8 tokens (last: it casts the
    weights to float32). Phase 14b: ``whisper_parity``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import step_fn_for

    cfg = get_arch("whisper-medium")
    t_phase = time.perf_counter()
    held = empty_card(torch)
    params, n_bytes = weights(torch, cfg, cfg.name)
    step_launch, decode_launch = whisper_launches(cfg)
    out = {"weight_bytes": n_bytes, "allocated_before": held}
    log(f"phase 14: {held} bytes allocated before whisper's weights")
    # (a) the prefill step
    t0 = time.perf_counter()
    batch = whisper_batch(torch, cfg, 2, 448, 5, torch.bfloat16)
    runs = 2
    with launch_shapes(ops, True) as tally:
        step = prefill_step_run(torch, cfg, params, "14a whisper prefill "
                                "step", step_launch, B=2, S=448, runs=runs,
                                batch=batch)
    S_enc, L, E = cfg.encoder_seq, cfg.num_layers, cfg.encoder_layers
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    check_shapes("14a", tally, {
        flash_key(2, H, KH, S_enc, S_enc, D, False): E * (runs + 1),
        flash_key(2, H, KH, 448, 448, D): L * (runs + 1),
        flash_key(2, H, KH, 448, S_enc, D, False): L * (runs + 1)})
    step["flash_by_shape_per_step"] = {k: n // (runs + 1) for k, n in
                                       tally.items()}
    out["14a"] = step
    log(f"phase 14a took {time.perf_counter() - t0:.1f} s; step "
        + json.dumps(step))
    out["14a profile"] = device_profile(
        torch, lambda: step_fn_for(cfg, "prefill")(params, batch))
    log("profile 14a whisper-medium prefill step "
        + json.dumps(out["14a profile"]))
    # (b) prefill_with_cache, then greedy decode against the cross cache
    t0 = time.perf_counter()
    gen_in = whisper_batch(torch, cfg, 8, 16, 9, torch.bfloat16)
    gens = []
    for _ in range(2):
        gens.append(whisper_generate(torch, cfg, params, "cuda",
                                     gen_in["frame_embeds"],
                                     gen_in["tokens"], 32))
    g = gens[0]
    if g["decode_launches"] != {k: 32 * n for k, n in decode_launch.items()}:
        fail(f"14b: 32 decode steps launched {g['decode_launches']}, "
             f"expected 32 x {decode_launch}")
    pre = g["prefill_launches"]
    if pre["flash_attention"] != E or pre["decode_attention"] != 16 * 2 * L:
        fail(f"14b: prefill_with_cache launched {pre}")
    cross = g["by_shape"].get(decode_key(8, H, KH, S_enc, D), 0)
    if cross != (16 + 32) * L:
        fail(f"14b: decode attention over the frames {g['by_shape']}")
    if gens[0]["tokens"] != gens[1]["tokens"]:
        fail("14b: two runs of the same greedy decode gave other tokens")
    out["14b generate"] = dict(
        rows=8, prompt=16, steps=32, prefill_launches=pre,
        decode_launches_per_step={k: n // 32 for k, n in
                                  g["decode_launches"].items()},
        ms_per_decode_step=[x["ms_per_decode_step"] for x in gens],
        launches_by_shape=g["by_shape"], cross_launches=cross,
        same_tokens_both_runs=True)
    log(f"phase 14b took {time.perf_counter() - t0:.1f} s; generate "
        + json.dumps(out["14b generate"]))
    # (c) the engine
    prompts = whisper_prompts(cfg.vocab_size)
    kw = dict(prompts=prompts, max_new=16, max_slots=8, max_len=448)
    # a short unmeasured serve first: every dispatch of the sequential
    # prefill and of decode has the measured serves' shapes
    t0 = time.perf_counter()
    serve_engine(cfg, params, **dict(kw, prompts=[p[:3] for p in prompts],
                                     max_new=2)).run_until_done()
    log(f"phase 14c warm-up took {time.perf_counter() - t0:.1f} s")
    serves = []
    for i in range(2):
        t0 = time.perf_counter()
        r = full_width_serve(torch, cfg, params, "14c whisper serve",
                             ["decode_attention", "pim_matvec", "layernorm"],
                             record=True, **kw)
        checks.add(f"14c whisper-medium serve {i + 1}", [r.pop("trace")])
        nonzero = {k: v for k, v in decode_launch.items() if v}
        for what in ("launches_per_decode_step",
                     "launches_per_prefill_dispatch"):
            if {k: v for k, v in r[what].items() if v} != nonzero:
                fail(f"14c: {what} {r[what]}, expected {nonzero}")
        if r["dispatch_counts"]["prefill"] != sum(len(p) - 1
                                                   for p in prompts):
            fail(f"14c: {r['dispatch_counts']} for prompts "
                 f"{[len(p) for p in prompts]}")
        serves.append(r)
        log(f"phase 14c took {time.perf_counter() - t0:.1f} s")
    out["14c"] = two_serves(*serves)
    if not out["14c"]["same_tokens_both_runs"]:
        fail("14c: two serves of the same requests gave other tokens")
    log("serve 14c whisper-medium " + json.dumps(
        {k: v for k, v in out["14c"].items() if k != "tokens"}))
    # the bf16 bound (casts the weights to float32 in place)
    t0 = time.perf_counter()
    out["14a bf16 steps"] = bf16_steps(
        torch, cfg, params, "whisper-medium", [p[:8] for p in prompts],
        batch, pack=False, max_slots=8, max_len=448)
    log(f"phase 14a bf16 bound took {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    out["14b parity"] = whisper_parity(torch)
    log(f"phase 14b took {time.perf_counter() - t0:.1f} s")
    return out


def whisper_parity(torch) -> dict:
    """Phase 14b: whisper-medium at full width, depth 2 (2 encoder and 2
    decoder layers), 1,500 frames, float32, through the kernels on the
    card and the plain versions on the CPU: the prefill step (B 2, 448
    tokens) logits within 1e-4, phase 14's greedy decode and its serve
    with identical tokens, dispatch counts and host syncs."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for
    from repro_torch.launch.steps import step_fn_for
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServeConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("whisper-medium"), num_layers=2,
                              encoder_layers=2, dtype="float32")
    params = init_params(T.param_defs(cfg),
                         torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")

    def tree(fn, t):
        return {k: tree(fn, v) for k, v in t.items()} \
            if isinstance(t, dict) else fn(t)
    params = {"cuda": tree(lambda a: a.float(), params)}
    params["cpu"] = tree(lambda a: a.cpu(), params["cuda"])
    step_in = batch_for(cfg, 2, 448, seed=5)
    gen_in = batch_for(cfg, 8, 16, seed=9)
    prompts = whisper_prompts(cfg.vocab_size)
    logits, gens, serves = {}, {}, {}
    for dev in ("cuda", "cpu"):
        logits[dev] = step_fn_for(cfg, "prefill", device=dev)(
            params[dev], step_in).cpu()
        gens[dev] = whisper_generate(
            torch, cfg, params[dev], dev,
            torch.from_numpy(gen_in["frame_embeds"]),
            torch.from_numpy(gen_in["tokens"]), 32)["tokens"]
        eng = ServeEngine(cfg, params[dev], ServeConfig(
            max_slots=8, max_len=448), device=dev)
        for pr in prompts:
            eng.add_request(pr, max_new_tokens=16)
        serves[dev] = (eng.run_until_done(), dict(eng.dispatch_counts),
                       eng.host_syncs)
    err = (logits["cuda"] - logits["cpu"]).abs()
    worst = float((err / (1 + logits["cpu"].abs())).max())
    if worst > 1e-4:
        fail(f"14b whisper prefill step: kernel path != plain path, max "
             f"|err| / (1 + |plain|) {worst:.3g} > 1e-4")
    if gens["cuda"] != gens["cpu"]:
        fail("14b whisper greedy decode: kernel path != plain path")
    if serves["cuda"] != serves["cpu"]:
        fail(f"14b whisper serve: kernel path != plain path: "
             f"{serves['cuda'][1:]} != {serves['cpu'][1:]}")
    out = dict(prefill_step_max_abs_err=float(err.max()),
               prefill_step_relative_err=worst,
               dispatches=serves["cuda"][1], host_syncs=serves["cuda"][2])
    log("parity float32 depth 2, whisper-medium: prefill step logits within "
        f"{worst:.3g} (relative), greedy decode tokens, serve tokens, "
        f"dispatches and host syncs identical on cuda and cpu "
        + json.dumps(out))
    del params
    torch.cuda.empty_cache()
    return out


def pixtral_phases(torch, checks) -> dict:
    """Phase 15: pixtral-12b at full width and depth (40 layers, 32 / 8
    heads of 160), bf16, weights from a seed: (a) the prefill step at B 2
    with 256 patches and 768 text tokens, flash (D 160, causal) 40 times
    and the norm 81 times a call; (b) phase 3's serve, unpacked and
    packed, each twice after an unmeasured serve (``attention_serves``:
    each decode step and prefill chunk exactly ``path_launches``'s),
    recorded for phase 13, then one profiled serve (8 new tokens each).
    Phase 15b: depth 2, float32, card against CPU
    (the prefill step with patches, both serves), then the bf16 bound of
    3d at depth 2 (a float32 copy of the full depth does not fit beside
    the bf16 one)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for
    from repro_torch.kernels import ops

    cfg = get_arch("pixtral-12b")
    t_phase = time.perf_counter()
    held = empty_card(torch)
    params, n_bytes = weights(torch, cfg, cfg.name)
    out = {"weight_bytes": n_bytes, "allocated_before": held}
    log(f"phase 15: {held} bytes allocated before pixtral's weights")
    t0 = time.perf_counter()
    b = batch_for(cfg, 2, 1024, seed=5)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in b.items()
             if k in ("tokens", "patch_embeds")}
    L, runs = cfg.num_layers, 2
    with launch_shapes(ops, True) as tally:
        step = prefill_step_run(
            torch, cfg, params, "15a pixtral prefill step",
            dict(NO_LAUNCH, flash_attention=L, layernorm=2 * L + 1), B=2,
            S=1024, runs=runs, batch=batch)
    check_shapes("15a", tally, {flash_key(
        2, cfg.num_heads, cfg.num_kv_heads, 1024, 1024, cfg.head_dim):
        L * (runs + 1)})
    out["15a"] = step
    log(f"phase 15a took {time.perf_counter() - t0:.1f} s; step "
        + json.dumps(step))
    out.update(attention_serves(torch, cfg, params, "15", cfg.name, checks))
    t0 = time.perf_counter()
    eng = serve_engine(cfg, params, max_new=8)
    out["profile"] = device_profile(torch, eng.run_until_done)
    del eng
    log(f"profile 15 {cfg.name} (8 new tokens each; took "
        f"{time.perf_counter() - t0:.1f} s) " + json.dumps(out["profile"]))
    del params
    torch.cuda.empty_cache()
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    d2 = dataclasses.replace(cfg, num_layers=2)
    stub = {"patch_embeds": batch_for(d2, 2, cfg.num_patches + 32,
                                      seed=6)["patch_embeds"]}
    depth2_parity(torch, dataclasses.replace(d2, dtype="float32"), cfg.name,
                  variants=({}, dict(pack=True)), S=32, stub=stub)
    params, _ = weights(torch, d2, f"{cfg.name} depth 2")
    b = batch_for(d2, 2, 1024, seed=5)
    out["15b bf16 steps"] = bf16_steps(
        torch, d2, params, "pixtral-12b depth 2",
        serve_prompts(cfg.vocab_size),
        {k: torch.from_numpy(v).to("cuda") for k, v in b.items()
         if k in ("tokens", "patch_embeds")}, pack=True)
    del params
    torch.cuda.empty_cache()
    log(f"phase 15b took {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 13: the port's verify over the card's traces, and their replay
# --------------------------------------------------------------------------- #
# the machines phase 13 replays phase 9's trace on (the paper's models)
REPLAY_MACHINES = ("IANUS", "NPU-MEM")
# the replay's breakdown tags (``benchmarks/trace_replay.py``'s)
REPLAY_TAGS = ("fc_mha", "ffn", "self_attn", "norm_res", "lm_head")
# the directories the host-sync lint scans (``benchmarks/hazard_guard.py``'s)
LINTED = ("serve", "sched", "obs", "fleet", "chaos")


class Tee:
    """Hands each of the engine's recorder hooks to every recorder given,
    in turn."""

    def __init__(self, *recorders):
        self.recorders = recorders

    def __getattr__(self, hook):
        def call(*a, **k):
            for r in self.recorders:
                getattr(r, hook)(*a, **k)
        return call


def restore_false_alarms(trace) -> set:
    """The locations of the packed dispatches after a KV-snapshot restore
    at which the protocol lint's ``gather_before_scatter`` compares the
    padded prefix span with the rows restored and scattered so far, and
    the re-derived plan shows that the gather reads, unmasked, no more
    than those rows (its lanes' largest ``prefix_len``): the reference's
    rule, which the port's lint keeps, flags a restored prefix that is no
    chunk multiple although nothing unwritten is read."""
    import numpy as np
    from repro_torch.sched.packing import plan_packed_job

    class Req:
        def __init__(self, plen, start):
            self.prompt = np.zeros(plen, np.int32)
            self.prefill_start = start

    serve = trace.header.get("serve", {})
    jobs, admits, alarms = {}, -1, set()
    for ei, ev in enumerate(trace.events):
        if ev["type"] == "admit":
            admits += 1
            restored = {int(s): int(p) for s, _r, p in ev.get("restores", [])}
            if restored:
                plan = plan_packed_job(
                    [(int(s), Req(int(p), restored.get(int(s), 0)))
                     for s, _r, p in ev["wave"]],
                    max_slots=serve["max_slots"],
                    chunk=serve["prefill_chunk"], sub_batch=admits)
                if plan is not None:
                    jobs[admits] = [plan.dispatches, 0,
                                    sum(restored.values())]
        elif ev["type"] == "prefill" and ev.get("packed", False):
            job = jobs.get(int(ev.get("sub_batch", -1)))
            if job is None:
                continue
            dispatches, j, scattered = job
            scattered += int(ev["valid"])
            span = int(ev["kv"]) - int(ev["chunk"])
            if j < len(dispatches) and span > scattered >= int(
                    dispatches[j].prefix_len.max(initial=0)):
                alarms.add(f"event#{ei}@step{ev.get('step', '?')}")
            job[1:] = [j + 1, scattered]
    return alarms


def verify_traces(label: str, traces, fleet: bool) -> dict:
    """The port's verify passes over one serve's trace or one fleet's node
    traces: the protocol lint, the span hazards of the lowered steps, each
    step against its reference DAG, and (a fleet) the exactly-once and
    snapshot-provenance audits. The lint's ``gather_before_scatter``
    findings that ``restore_false_alarms`` explains are counted apart
    (accepted); every other finding fails the run. Runs in a worker
    process."""
    from repro_torch.trace.lower import trace_to_commands
    from repro_torch.trace.schema import model_config_from_header
    from repro_torch.verify import (analyze_lowered, check_exactly_once,
                                    check_snapshot_provenance, lint_trace,
                                    verify_lowered_step)

    t0 = time.perf_counter()
    findings, steps, accepted = [], 0, 0
    for tr in traces:
        alarms = restore_false_alarms(tr)
        for f in lint_trace(tr):
            if f.klass == "gather_before_scatter" and f.location in alarms:
                accepted += 1
            else:
                findings.append(f)
        lowered = trace_to_commands(tr)
        steps += len(lowered)
        findings += analyze_lowered(lowered)
        cfg = model_config_from_header(tr.header)
        for ls in lowered:
            findings += verify_lowered_step(ls, cfg)
    if fleet:
        findings += check_exactly_once(traces)
        findings += check_snapshot_provenance(traces)
    return dict(label=label, traces=len(traces), lowered_steps=steps,
                findings=[f.to_dict() for f in findings],
                accepted_restore_alarms=accepted,
                seconds=time.perf_counter() - t0)


def replay_trace(trace, machine: str) -> dict:
    """``benchmarks/trace_replay.py``'s recipe on one recorded trace: lower
    it against llama3.2-1b's full config for ``machine``'s model and
    replay it through ``TraceReplayer``. Every time in the result is the
    simulated machine's. Runs in a worker process."""
    from repro_torch.configs import get_arch
    from repro_torch.core import IANUS_HW, NPU_MEM_HW
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.trace import TraceReplayer, trace_to_commands

    hw = {"IANUS": IANUS_HW, "NPU-MEM": NPU_MEM_HW}[machine]
    t0 = time.perf_counter()
    lowered = trace_to_commands(trace, cfg=get_arch("llama3.2-1b"), hw=hw)
    rep = TraceReplayer(Simulator(SimConfig(
        hw=hw, issue_overhead=0.1e-6, trace=True))).replay(lowered)
    agree = sum(r["agree"] for r in rep.divergence)
    total = sum(r["n"] for r in rep.divergence)
    return dict(
        machine=machine, lowered_steps=len(lowered),
        simulated_makespan_s=rep.makespan,
        simulated_exposed_s_by_tag={t: rep.exposed_tags.get(t, 0.0)
                                    for t in REPLAY_TAGS},
        simulated_phase_s=dict(rep.phase_time),
        simulated_mu_util=rep.result.group_utilization("MU"),
        simulated_pim_util=rep.result.group_utilization("PIM"),
        overlap_stats=dict(rep.overlap_stats),
        superstep_stats=dict(rep.superstep_stats),
        route_agreement=agree / total if total else None,
        seconds=time.perf_counter() - t0)


class TraceChecks:
    """What the card's serves recorded, for phase 13: the traces of phases
    9, 9b, 10, 12, 12b and 12c, each to go through the port's verify, and
    phase 9's ``pim_aware`` trace to replay. ``run`` does it all at the
    end, in worker processes, so that it times nothing of the phases that
    measure the card."""

    def __init__(self):
        self.jobs = []            # (label, traces, fleet)
        self.replay = None        # (label, trace, measured ms per round)

    def add(self, label: str, traces, fleet: bool = False) -> None:
        self.jobs.append((label, list(traces), fleet))

    def run(self, card: str) -> dict:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        from repro_torch.verify import lint_host_syncs, load_allowlist

        t0 = time.perf_counter()
        port = os.path.join(SRC, "repro_torch")
        found = lint_host_syncs(
            [os.path.join(port, d) for d in LINTED],
            load_allowlist(os.path.join(port, "verify",
                                        "sync_allowlist.txt")), root=port)
        if found:
            fail(f"13: host-sync lint: {[f.to_dict() for f in found]}")
        log(f"13 host-sync lint over {list(LINTED)}: no finding "
            f"({time.perf_counter() - t0:.2f} s)")
        replays = REPLAY_MACHINES if self.replay is not None else ()
        workers = max(1, min(len(self.jobs) + len(replays),
                             (os.cpu_count() or 2) - 1, 7))
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")
                ) as pool:
            rep = {m: pool.submit(replay_trace, self.replay[1], m)
                   for m in replays}
            ver = [pool.submit(verify_traces, *job) for job in self.jobs]
            checked = [f.result() for f in ver]
            replayed = {m: f.result() for m, f in rep.items()}
        bad = [c for c in checked if c["findings"]]
        for c in checked:
            log(f"13 verify {c['label']}: {c['traces']} trace(s), "
                f"{c['lowered_steps']} lowered steps, "
                f"{len(c['findings'])} finding(s), "
                f"{c['accepted_restore_alarms']} accepted restore alarm(s) "
                f"(gather_before_scatter, the plan reads no unwritten row), "
                f"{c['seconds']:.2f} s")
        if bad:
            fail("13: the port's verify found "
                 + json.dumps([(c["label"], c["findings"][:3])
                               for c in bad]))
        out = dict(verify={c["label"]: {k: v for k, v in c.items()
                                        if k != "findings"}
                           for c in checked},
                   verify_cpu_s=sum(c["seconds"] for c in checked),
                   accepted_restore_alarms=sum(
                       c["accepted_restore_alarms"] for c in checked))
        log(f"13 accepted restore alarms in all: "
            f"{out['accepted_restore_alarms']}")
        if replays:
            label, _, ms = self.replay
            for m, r in replayed.items():
                if not r["simulated_makespan_s"] > 0:
                    fail(f"13: the {m} replay of {label} gave {r}")
                log(f"13 replay of {label} on simulated {m} (a model's "
                    "output, not the card's time): " + json.dumps(r))
            out["replay"] = dict(
                trace=label,
                simulated_makespan_s={m: r["simulated_makespan_s"]
                                      for m, r in replayed.items()},
                route_agreement=replayed["IANUS"]["route_agreement"],
                measured_h100_ms_per_decode_round=ms, card=card)
            log("13 simulated IANUS / NPU-MEM beside the measured H100 ("
                f"{card}), the same serve: " + json.dumps(out["replay"]))
        log(f"13 verify: {len(checked)} job(s) in {workers} worker(s), "
            f"{out['verify_cpu_s']:.1f} CPU s; phase 13 took "
            f"{time.perf_counter() - t0:.1f} s")
        return out


# --------------------------------------------------------------------------- #
# phases 16-16c: training llama3.2-1b
# --------------------------------------------------------------------------- #
def train_launches(cfg) -> dict:
    """What one train step launches at ``cfg.remat="full"``: each kernel of
    a block (flash, the wkv or the Mamba scan, the in-block norms; an
    encdec decoder block's cross attention and its norm; whisper's encoder
    blocks too) once in the forward and again in the block's
    recomputation, the final norms (the encoder's and the decoder's) once;
    each backward kernel once a forward launch it differentiates."""
    kinds = cfg.layer_kinds()
    enc = cfg.encoder_layers if cfg.family == "encdec" else 0
    cross = kinds.count("attn") if enc else 0
    flash = kinds.count("attn") + cross + enc
    norms = 2 * len(kinds) + cross + 2 * enc
    finals = 2 if enc else 1
    rwkv, mamba = kinds.count("rwkv"), kinds.count("mamba")
    return dict(NO_LAUNCH, flash_attention=2 * flash,
                flash_attention_bwd=flash, layernorm=2 * norms + finals,
                layernorm_bwd=norms + finals, rwkv_chunk=2 * rwkv,
                rwkv_chunk_bwd=rwkv, mamba_chunk=2 * mamba,
                mamba_chunk_bwd=mamba)


def train_phase(torch) -> dict:
    """Phase 16: llama3.2-1b at full width and depth, bf16, remat "full",
    AdamW under a 5-step warmup to 1e-3 and cosine decay, 30 steps of
    ``SyntheticLM`` 4 x 1024 (its rules change every step: what 30 steps
    can learn is to shrink the initial logits' spread, about 0.4 nats
    above log V)."""
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count
    from repro_torch.optim import adamw_init, linear_warmup_cosine
    from repro_torch.train import (TrainStepConfig, loss_and_grads,
                                   make_train_step)

    cfg = get_arch("llama3.2-1b")
    if cfg.remat != "full" or cfg.dtype != "bfloat16":
        fail(f"16: llama3.2-1b's config has remat {cfg.remat}, dtype "
             f"{cfg.dtype}")
    B, S, steps = 4, 1024, 30
    n_params = param_count(T.param_defs(cfg))
    params = init_params(T.param_defs(cfg), device="cuda", seed=0)
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainStepConfig(
        learning_rate=linear_warmup_cosine(1e-3, 5, steps)))
    data = SyntheticLM(cfg.vocab_size, S, B, seed=0)
    batches = [data.batch(i) for i in range(steps + 1)]
    # step 1's gradient: a leaf without one is a dead autograd path
    _, _, grads = loss_and_grads(cfg, params, {
        k: torch.from_numpy(v).cuda() for k, v in batches[0].items()})
    named = flatten_tree(grads)
    for name, g in named.items():
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            fail(f"16: gradient of {name} not finite and nonzero")
    n_leaves = len(named)
    del grads
    want = train_launches(cfg)
    losses, ms, total = [], [], dict.fromkeys(want, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ops.reset_launch_counts()
        ev[0].record()
        params, opt, m = step(params, opt, batches[i])
        ev[1].record()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts != want:
            fail(f"16: step {i} launched {counts}, expected {want}")
        total = {k: total[k] + counts[k] for k in total}
        losses.append(float(m["loss"]))
        ms.append(ev[0].elapsed_time(ev[1]))
    peak = torch.cuda.max_memory_allocated()
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        fail(f"16: losses {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        fail(f"16: the last 5 losses average {last}, the first 5 {first}")
    timed = ms[1:]                       # the first step builds Triton's
    mean = sum(timed) / len(timed)
    tokens = B * S
    out = dict(phase="16 train", B=B, S=S, steps=steps, params=n_params,
               grad_leaves=n_leaves, losses=losses, first5=first,
               last5=last, ms_per_step=mean, ms_runs=ms,
               tokens_per_s=tokens / (mean / 1e3),
               flops_share=6.0 * n_params * tokens / (mean / 1e3)
               / PEAK_FLOPS["bfloat16"],
               max_memory_allocated=peak, launches_per_step=want,
               launches=total)
    out["profile"] = device_profile(
        torch, lambda: step(params, opt, batches[steps]), top=12)
    del params, opt
    empty_card(torch)
    return out


def train_parity(torch) -> dict:
    """Phase 16b: llama3.2-1b at full width, depth 2, float32, 3 AdamW
    steps at a constant 1e-4 on the card (the kernels) and on the CPU (the
    plain versions) from the same weights and batches (2 x 128)."""
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import (TrainStepConfig, loss_and_grads,
                                   make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    params = init_params(T.param_defs(cfg), device="cuda", seed=4)

    def tree(fn, t):
        return {k: tree(fn, v) for k, v in t.items()} \
            if isinstance(t, dict) else fn(t)
    state = {"cuda": [tree(lambda a: a.float(), params)]}
    del params
    state["cpu"] = [tree(lambda a: a.cpu(), state["cuda"][0])]
    data = SyntheticLM(cfg.vocab_size, 128, 2, seed=5)

    def worst(a, b):
        return max(float(((x.cpu() - y).abs() / (1 + y.abs())).max())
                   for x, y in zip(flatten_tree(a).values(),
                                   flatten_tree(b).values()))
    grads = {}
    for dev in ("cuda", "cpu"):
        b0 = {k: torch.from_numpy(v).to(dev)
              for k, v in data.batch(0).items()}
        grads[dev] = loss_and_grads(cfg, state[dev][0], b0)[2]
    out = dict(phase="16b train parity", grad_err=worst(grads["cuda"],
                                                        grads["cpu"]))
    del grads
    want = train_launches(cfg)
    out["losses"], out["param_err"] = [], []
    for dev in ("cuda", "cpu"):
        state[dev].append(adamw_init(state[dev][0]))
        state[dev].append(make_train_step(cfg, TrainStepConfig(
            learning_rate=lambda s: 1e-4), device=dev))
    for i in range(3):
        losses = []
        for dev in ("cuda", "cpu"):
            ops.reset_launch_counts()
            p, o, step = state[dev]
            p, o, m = step(p, o, data.batch(i))
            state[dev][:2] = [p, o]
            losses.append(float(m["loss"]))
            if dev == "cuda" and ops.launch_counts() != want:
                fail(f"16b: step {i} launched {ops.launch_counts()}, "
                     f"expected {want}")
        out["losses"].append(losses)
        out["param_err"].append(worst(state["cuda"][0], state["cpu"][0]))
    loss_err = max(abs(a - b) / (1 + abs(b)) for a, b in out["losses"])
    if max([out["grad_err"], loss_err] + out["param_err"]) > 1e-4:
        fail(f"16b: card != CPU beyond 1e-4: {out}")
    del state
    empty_card(torch)
    return out


def train_restart(torch) -> dict:
    """Phase 16c: ``launch.train``'s crash/resume contract on the card."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=SRC)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "llama3.2-1b", "--smoke", "--steps", "60", "--ckpt-dir", d,
                "--ckpt-every", "20", "--log-every", "20"]
        runs = []
        for extra in (["--fail-at-step", "45"], []):
            t0 = time.perf_counter()
            r = subprocess.run(args + extra, capture_output=True, text=True,
                               env=env, timeout=300)
            runs.append((r, time.perf_counter() - t0))
    (r1, t1), (r2, t2) = runs
    if r1.returncode != 17 or "INJECTED FAILURE at step 45" not in r1.stdout:
        fail(f"16c: the injected failure gave rc {r1.returncode}: "
             f"{r1.stdout[-1500:]} {r1.stderr[-1500:]}")
    if r2.returncode != 0 or "resumed from step 40" not in r2.stdout \
            or "done:" not in r2.stdout:
        fail(f"16c: the rerun gave rc {r2.returncode}: {r2.stdout[-1500:]} "
             f"{r2.stderr[-1500:]}")
    return dict(phase="16c restart", crash_s=t1, resume_s=t2,
                tail=r2.stdout.strip().splitlines()[-2:])


def train_phases(torch, checks=None) -> dict:
    """Phases 16, 16b and 16c, each timed."""
    out = {}
    for key, fn in (("16", train_phase), ("16b", train_parity),
                    ("16c", train_restart)):
        t0 = time.perf_counter()
        empty_card(torch)
        out[key] = fn(torch)
        log(f"phase {key} took {time.perf_counter() - t0:.1f} s: "
            + json.dumps(out[key]))
    return out


# --------------------------------------------------------------------------- #
# phases 17-20c: training rwkv6-7b, jamba, whisper-medium, pixtral-12b
# and gpt2-2.5b
# --------------------------------------------------------------------------- #
# jamba's two-layer stack at its full widths: ``.reduced()``'s interleave,
# one Mamba + dense layer and one attention + MoE layer (its own period of
# 8 layers holds 11.3 G parameters in experts, which AdamW's 12 bytes a
# parameter cannot hold on 80 GB)
JAMBA_STACK = dict(attn_period=2, attn_offset=1, moe_every=2, moe_offset=1,
                   num_layers=2)


def step_flops(cfg, B: int, S: int) -> float:
    """6 N tokens of one step: N the parameters a token meets (all but the
    experts it is not routed to); whisper's encoder parameters meet the
    frames, the rest the decoder's tokens."""
    from repro_torch.models import transformer as T

    defs = T.param_defs(cfg)

    def count(tree):
        total = experts = 0
        for pd in leaves(tree):
            n = 1
            for x in pd.shape:
                n *= x
            total += n
            experts += n if "experts" in pd.logical_axes else 0
        if experts:
            total -= experts * (1 - cfg.experts_per_token / cfg.num_experts)
        return total
    if cfg.family == "encdec":
        enc = count(defs["encoder"])
        return 6.0 * B * (enc * cfg.encoder_seq
                          + (count(defs) - enc) * S)
    return 6.0 * B * S * count(defs)


def to_card(torch, batch: dict) -> dict:
    return {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}


def family_train(torch, phase: str, cfg, B: int, S: int, steps: int,
                 batch_of) -> dict:
    """``cfg`` at full width in bf16, weights from a seed, ``remat="full"``,
    AdamW under a 2-step warmup to 1e-3 and cosine decay, ``steps`` steps
    on one batch ``batch_of(0)`` (B x S). Every loss is finite and the
    last 3 average below the first 3; the gradient at the trained weights
    (on ``batch_of(1)``) has
    every leaf finite and nonzero (a leaf without one is a dead autograd
    path); each step
    launches exactly ``train_launches(cfg)`` (the recurrences' backward
    kernels once a layer). Logged: ms a step (mean of steps 2 on), tokens
    a second, the share of 989 TFLOP/s that ``step_flops`` reaches, peak
    memory, and a profiled step (busy share, device ms by kernel)."""
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count
    from repro_torch.optim import adamw_init, linear_warmup_cosine
    from repro_torch.train import (TrainStepConfig, loss_and_grads,
                                   make_train_step)

    if cfg.remat != "full" or cfg.dtype != "bfloat16":
        fail(f"{phase}: {cfg.name} has remat {cfg.remat}, dtype {cfg.dtype}")
    t0 = time.perf_counter()
    params = init_params(T.param_defs(cfg), device="cuda", seed=0)
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainStepConfig(
        learning_rate=linear_warmup_cosine(1e-3, 2, steps)))
    # one batch, fitted: a step that learns makes its loss fall however
    # the stream's rules change from batch to batch
    batches = [batch_of(0)] * steps + [batch_of(1)]
    want = train_launches(cfg)
    losses, ms, total = [], [], dict.fromkeys(want, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ops.reset_launch_counts()
        ev[0].record()
        params, opt, m = step(params, opt, batches[i])
        ev[1].record()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts != want:
            fail(f"{phase}: step {i} launched {counts}, expected {want}")
        total = {k: total[k] + counts[k] for k in total}
        losses.append(float(m["loss"]))
        ms.append(ev[0].elapsed_time(ev[1]))
    peak = torch.cuda.max_memory_allocated()
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"{phase}: losses {losses}")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        fail(f"{phase}: the last 3 losses average {last}, the first 3 "
             f"{first}")
    # the gradient at the trained weights (at the initial ones rwkv's
    # decay LoRA, whose second factor starts at 0, passes none to its
    # first factor and mu_w)
    _, _, grads = loss_and_grads(cfg, params, to_card(torch, batches[-1]))
    named = flatten_tree(grads)
    for name, g in named.items():
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            fail(f"{phase}: gradient of {name} not finite and nonzero")
    n_leaves = len(named)
    del grads, named
    empty_card(torch)
    mean = sum(ms[1:]) / (steps - 1)
    flops = step_flops(cfg, B, S)
    out = dict(phase=phase, arch=cfg.name, layers=cfg.num_layers, B=B, S=S,
               steps=steps, params=param_count(T.param_defs(cfg)),
               step_flops=flops, grad_leaves=n_leaves, losses=losses,
               first3=first, last3=last, ms_per_step=mean, ms_runs=ms,
               tokens_per_s=B * S / (mean / 1e3),
               flops_share=flops / (mean / 1e3) / PEAK_FLOPS["bfloat16"],
               max_memory_allocated=peak, launches_per_step=want,
               launches=total)
    # the emptied allocator refills on an unmeasured step first
    params, opt, _ = step(params, opt, batches[steps])
    out["profile"] = device_profile(
        torch, lambda: step(params, opt, batches[steps]), top=12)
    del params, opt
    empty_card(torch)
    out["wall_s"] = time.perf_counter() - t0
    return out


def family_parity(torch, phase: str, cfg, batch_of,
                  adafactor: bool = False) -> dict:
    """``cfg`` (full width, depth 2) in float32, ``remat="full"``: step 1's
    gradient and 3 steps through the kernels and through the plain
    versions (``plain_path``), both on the card, from the same weights
    (from a seed, cast to float32) and batches: AdamW at a constant 1e-4
    (``make_train_step``) or, with ``adafactor``, the launcher's
    ``"train"`` step (Adafactor at 1e-4). The two paths run one after the
    other, the kernel path's gradient and parameters kept on the host (a
    float32 copy of jamba's stack with its optimizer state for each path
    would not fit the card). Every gradient leaf, each step's loss and
    every parameter after step 3 within 1e-4 of the plain path's,
    relative to 1 + |plain| (16b's bound); the kernel path's launches
    exact."""
    import contextlib as cl

    from repro_torch.checkpoint import flatten_tree
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import step_fn_for
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.optim import adafactor_init, adamw_init
    from repro_torch.train import (TrainStepConfig, loss_and_grads,
                                   make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def tree(fn, t):
        return {k: tree(fn, v) for k, v in t.items()} \
            if isinstance(t, dict) else fn(t)
    params = init_params(T.param_defs(cfg), device="cuda", seed=4)
    init = tree(lambda a: a.float().cpu(), params)
    del params
    batches = [batch_of(i) for i in range(3)]
    want = train_launches(cfg)

    def run(plain: bool):
        p = tree(lambda a: a.to("cuda"), init)
        with plain_path(ops) if plain else cl.nullcontext():
            ops.reset_launch_counts()
            grads = loss_and_grads(cfg, p, to_card(torch, batches[0]))[2]
            if not plain and ops.launch_counts() != want:
                fail(f"{phase}: the gradient launched {ops.launch_counts()}"
                     f", expected {want}")
            yield grads
            del grads
            if adafactor:
                opt, step = adafactor_init(p), step_fn_for(cfg, "train")
            else:
                opt = adamw_init(p)
                step = make_train_step(cfg, TrainStepConfig(
                    learning_rate=lambda s: 1e-4))
            losses = []
            for i in range(3):
                ops.reset_launch_counts()
                p, opt, m = step(p, opt, batches[i])
                losses.append(float(m["loss"]))
                if not plain and ops.launch_counts() != want:
                    fail(f"{phase}: step {i} launched "
                         f"{ops.launch_counts()}, expected {want}")
            del opt
            yield losses, p

    def worst(a, b):
        """The largest |kernel - plain| / (1 + |plain|) and its leaf."""
        errs = {k: float(((x.to("cuda") - y).abs() / (1 + y.abs())).max())
                for (k, x), y in zip(flatten_tree(a).items(),
                                     flatten_tree(b).values())}
        leaf = max(errs, key=errs.get)
        return errs[leaf], leaf
    kernel = run(plain=False)
    g_k = tree(lambda a: a.cpu(), next(kernel))
    losses_k, p_k = next(kernel)
    p_k = tree(lambda a: a.cpu(), p_k)
    kernel.close()
    empty_card(torch)
    plain = run(plain=True)
    out = dict(phase=phase, arch=cfg.name,
               optimizer="adafactor" if adafactor else "adamw")
    out["grad_err"], out["grad_worst"] = worst(g_k, next(plain))
    del g_k
    losses_p, p_p = next(plain)
    out["param_err"], out["param_worst"] = worst(p_k, p_p)
    plain.close()
    del p_k, p_p
    out["losses"] = list(zip(losses_k, losses_p))
    out["loss_err"] = max(abs(a - b) / (1 + abs(b)) for a, b in out["losses"])
    if max(out["grad_err"], out["loss_err"], out["param_err"]) > 1e-4:
        fail(f"{phase}: kernel path != plain path beyond 1e-4: {out}")
    empty_card(torch)
    out["wall_s"] = time.perf_counter() - t0
    return out


def rwkv_train_phases(torch, checks=None) -> dict:
    """Phase 17: rwkv6-7b at full width cut to 8 of 32 layers, B 2 x S
    2048 of ``SyntheticLM``, 10 steps; 17b: depth 2, float32, S 128 (the
    plain path's wkv and its backward walk the steps one by one)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM

    full = get_arch("rwkv6-7b")
    cfg = dataclasses.replace(full, num_layers=8)
    data = SyntheticLM(cfg.vocab_size, 2048, 2, seed=0)
    out = {"17": family_train(torch, "17 rwkv6-7b train", cfg, 2, 2048, 10,
                              data.batch)}
    log(f"phase 17 took {out['17']['wall_s']:.1f} s: " + json.dumps(out["17"]))
    small = SyntheticLM(cfg.vocab_size, 128, 2, seed=5)
    out["17b"] = family_parity(torch, "17b rwkv6-7b train parity",
                               dataclasses.replace(full, num_layers=2,
                                                   dtype="float32"),
                               small.batch)
    log(f"phase 17b took {out['17b']['wall_s']:.1f} s: "
        + json.dumps(out["17b"]))
    return out


def jamba_train_phases(torch, checks=None) -> dict:
    """Phase 18: jamba-v0.1-52b's ``JAMBA_STACK`` at full widths, B 2 x S
    2048 of ``SyntheticLM``, 10 steps (Mamba, flash at D 128, MoE and
    their backward); 18b: the same stack in float32, B 1 x
    S 128, through the launcher's Adafactor step."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM

    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"), **JAMBA_STACK)
    data = SyntheticLM(cfg.vocab_size, 2048, 2, seed=0)
    out = {"18": family_train(torch, "18 jamba train", cfg, 2, 2048, 10,
                              data.batch)}
    log(f"phase 18 took {out['18']['wall_s']:.1f} s: " + json.dumps(out["18"]))
    # in float32 the stack, a second copy of it and AdamW's moments (4
    # x 14.6 GB) leave no room: the launcher's Adafactor step
    small = SyntheticLM(cfg.vocab_size, 128, 1, seed=5)
    out["18b"] = family_parity(torch, "18b jamba train parity",
                               dataclasses.replace(cfg, dtype="float32"),
                               small.batch, adafactor=True)
    log(f"phase 18b took {out['18b']['wall_s']:.1f} s: "
        + json.dumps(out["18b"]))
    return out


def whisper_train_phase(torch, checks=None) -> dict:
    """Phase 19: whisper-medium at full size, phase 14's step shape (B 2,
    1,500 frames, 448 tokens from ``batch_for``, frames in bf16), 10 steps:
    its encoder under remat, the flash backward non-causal at 1,500 x
    1,500 (24 a step) and 448 x 1,500 (24), causal at 448 (24)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for
    from repro_torch.kernels import ops

    cfg = get_arch("whisper-medium")
    S = 448                         # the decoder's context

    def batch_of(i):
        b = to_card(torch, batch_for(cfg, 2, S, seed=i))
        b["frame_embeds"] = b["frame_embeds"].to(torch.bfloat16)
        return b
    with launch_shapes(ops, True) as tally:
        out = family_train(torch, "19 whisper-medium train", cfg, 2, S, 10,
                           batch_of)
    L, E, F = cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    want = {bwd_key(2, H, KH, F, F, D, False): E,
            bwd_key(2, H, KH, S, S, D): L,
            bwd_key(2, H, KH, S, F, D, False): L}
    # the gradient check, 10 steps, an unmeasured one and the profiled one
    runs = out["steps"] + 3
    out["flash_bwd_by_shape"] = check_shapes(
        "19", tally, {k: n * runs for k, n in want.items()})
    log(f"phase 19 took {out['wall_s']:.1f} s: " + json.dumps(out))
    return {"19": out}


def pixtral_train_phases(torch, checks=None) -> dict:
    """Phase 20: pixtral-12b at full width cut to 4 of 40 layers, B 2 x
    (256 patch embeddings + 768 tokens) from ``batch_for`` (patches in
    bf16), 10 steps: flash and its backward at D 160 (the backward's bf16
    route at the padded width 192, in three column parts), 4 a step;
    20b: depth 2, float32, 256 patches + 32 tokens, the kernel path
    against the plain path on the card (AdamW)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for
    from repro_torch.kernels import ops

    full = get_arch("pixtral-12b")
    cfg = dataclasses.replace(full, num_layers=4)
    S = 1024

    def batch_of(i):
        b = to_card(torch, batch_for(cfg, 2, S, seed=i))
        b["patch_embeds"] = b["patch_embeds"].to(torch.bfloat16)
        return b
    with launch_shapes(ops, True) as tally:
        out = family_train(torch, "20 pixtral-12b train", cfg, 2, S, 10,
                           batch_of)
    # the gradient check, 10 steps, an unmeasured one and the profiled one
    runs = out["steps"] + 3
    check_shapes("20", tally, {bwd_key(
        2, cfg.num_heads, cfg.num_kv_heads, S, S, cfg.head_dim):
        cfg.num_layers * runs})
    log(f"phase 20 took {out['wall_s']:.1f} s: " + json.dumps(out))
    empty_card(torch)
    small = dataclasses.replace(full, num_layers=2, dtype="float32")
    parity = family_parity(
        torch, "20b pixtral-12b train parity", small,
        lambda i: batch_for(small, 2, small.num_patches + 32, seed=5 + i))
    log(f"phase 20b took {parity['wall_s']:.1f} s: " + json.dumps(parity))
    return {"20": out, "20b": parity}


def gpt2_train_phase(torch, checks=None) -> dict:
    """Phase 20c: gpt2-2.5b at full width cut to 2 of 54 layers, B 4 x S
    1024 of ``SyntheticLM``, 10 steps: the flash backward at D 96 (the
    bf16 route at the padded width 128, in two column parts), 2 a
    step."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_arch("gpt2-2.5b"), num_layers=2)
    data = SyntheticLM(cfg.vocab_size, 1024, 4, seed=0)
    with launch_shapes(ops, True) as tally:
        out = family_train(torch, "20c gpt2-2.5b train", cfg, 4, 1024, 10,
                           data.batch)
    check_shapes("20c", tally, {bwd_key(
        4, cfg.num_heads, cfg.num_kv_heads, 1024, 1024, cfg.head_dim):
        cfg.num_layers * (out["steps"] + 3)})
    log(f"phase 20c took {out['wall_s']:.1f} s: " + json.dumps(out))
    return {"20c": out}


def family_train_phases(torch, checks=None) -> dict:
    """Phases 17-20c, each on a card emptied first."""
    out = {}
    for fn in (rwkv_train_phases, jamba_train_phases, whisper_train_phase,
               pixtral_train_phases, gpt2_train_phase):
        empty_card(torch)
        out.update(fn(torch))
    return out


# --------------------------------------------------------------------------- #
# phase 21: two ranks on the one card -- layout B, expert parallelism and
# data-parallel training over gloo
# --------------------------------------------------------------------------- #
MULTIRANK_JOIN_S = 300        # a rank's limit; the gloo group's is 150 s


def multirank_cfgs(small: bool):
    """21a's granite-20b cut to 4 of 52 layers, 21b's qwen3-moe-30b-a3b
    cut to 4 of 48 (``moe_impl="ep"``), 21c's llama3.2-1b cut to 4 of 16;
    ``small``: their ``.reduced()`` widths (a run on the CPU)."""
    from repro_torch.configs import get_arch
    out = []
    for name, impl in (("granite-20b", None), ("qwen3-moe-30b-a3b", "ep"),
                       ("llama3.2-1b", None)):
        cfg = get_arch(name)
        cfg = cfg.reduced() if small else cfg
        cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, 4))
        if impl:
            cfg = dataclasses.replace(cfg, moe_impl=impl)
        out.append(cfg)
    return out


class HostClock:
    """Recorder hooks that keep the host's clock at each prefill and
    decode dispatch (each decode ends in the engine's one host sync), and
    count the packed prefill dispatches that read a cached prefix
    (``prefix_span`` > 0: on a layout-B cache, one gather a layer)."""

    def __init__(self):
        self.marks = []
        self.prefix_dispatches = 0

    def bind(self, engine) -> None:
        pass

    def on_prefill(self, *a, kv=0, chunk=0, packed=False, **k) -> None:
        self.marks.append(("prefill", time.perf_counter()))
        self.prefix_dispatches += int(packed and kv > chunk)

    def on_decode(self, *a, **k) -> None:
        self.marks.append(("decode", time.perf_counter()))

    def __getattr__(self, hook):
        return lambda *a, **k: None

    def ms_per_decode(self) -> float:
        kinds = [k for k, _ in self.marks]
        last = max(i for i, k in enumerate(kinds) if k == "prefill")
        dec = [t for k, t in self.marks[last + 1:] if k == "decode"]
        return 1e3 * (dec[-1] - dec[0]) / max(1, len(dec) - 1)

    def prefill_s(self, t0: float) -> float:
        """Seconds from ``t0`` to the last prefill dispatch's mark."""
        return max(t for k, t in self.marks if k == "prefill") - t0


def mesh_serve(torch, cfg, params, mesh, dev: str, prompts, max_new: int,
               profile: bool = False, **scfg_kw) -> dict:
    """One serve of ``prompts`` (8 slots, max_len 1024, chunks of 128;
    ``scfg_kw``: further ``ServeConfig`` fields, ``pack``) under ``mesh``
    (None: one rank, no collectives), its launches (on the card also by
    shape: ``launch_shapes``), collectives, dispatches, packed dispatches
    with a prefix and host syncs counted from 0."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh

    clock = HostClock()
    scope = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with scope:
        eng = ServeEngine(cfg, params, ServeConfig(
            max_slots=8, max_len=1024, prefill_chunk=128, **scfg_kw),
            recorder=clock, device=dev)
        for p in prompts:
            eng.add_request(p, max_new_tokens=max_new)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        comm.reset_stats()
        t0 = time.perf_counter()
        if profile:
            prof = device_profile(torch, eng.run_until_done)
            return dict(profile=prof)
        with launch_shapes(ops, dev == "cuda") as tally:
            results = eng.run_until_done()
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(
        tokens={str(k): [int(t) for t in v] for k, v in results.items()},
        dispatches=dict(eng.dispatch_counts), host_syncs=eng.host_syncs,
        prefix_dispatches=clock.prefix_dispatches,
        launches=ops.launch_counts(), by_shape=tally, comm=comm.stats(),
        wall_s=wall,
        prefill_s=clock.prefill_s(t0),
        ms_per_decode_step=clock.ms_per_decode(),
        peak_bytes=(torch.cuda.max_memory_allocated() if dev == "cuda"
                    else 0))


def _serve_checks(tag: str, run: dict, per_prefill: int, per_decode: int,
                  dev: str, kernels, per_prefix: int = 0) -> None:
    """A mesh serve's collectives: ``per_prefill`` a prefill chunk and
    ``per_decode`` a decode step (both in a fused step), and
    ``per_prefix`` more a packed chunk with a prefix (layout B's gathers),
    no other; on the card each kernel of ``kernels`` ran."""
    dc = run["dispatches"]
    want = per_prefill * dc["prefill"] + per_decode * dc["decode"] \
        + (per_prefill + per_decode) * dc.get("fused", 0) \
        + per_prefix * run.get("prefix_dispatches", 0)
    if run["comm"]["collectives"] != want:
        raise RuntimeError(f"{tag}: {run['comm']['collectives']} "
                           f"collectives, the plan gives {want} "
                           f"({per_prefill} a chunk, {per_decode} a step, "
                           f"{per_prefix} more a chunk with a prefix: {dc}, "
                           f"{run.get('prefix_dispatches', 0)} with one)")
    if dev == "cuda":
        for k in kernels:
            if not run["launches"].get(k):
                raise RuntimeError(f"{tag}: {k} never launched")


def depth2_weights(torch, cfg, dev: str, **depth2):
    """The float32 weights of ``cfg`` at depth 2 (``depth2``: further
    config changes), drawn from seed 1."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg2 = dataclasses.replace(cfg, **{"num_layers": 2, **depth2},
                               dtype="float32")
    full2 = init_params(T.param_defs(cfg2), device=dev, seed=1)
    leaves_to_f32(torch, full2)
    return full2


def depth2_mesh_parity(torch, tag: str, cfg, mesh, dev: str,
                       prompts, scfg_kw=None, prompt_len=96, weights=None,
                       **depth2) -> dict:
    """``cfg`` at depth 2 in float32 (``depth2``: further config changes,
    jamba's ``JAMBA_STACK``; ``scfg_kw``: the serve's ``ServeConfig``
    fields, ``pack``; ``weights``: ``depth2_weights``'s tree, drawn here
    if None): the mesh serve of the prompts' first ``prompt_len`` tokens
    (None: whole) against the one-rank serve (tokens, dispatches, host
    syncs)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import resident_axes, shard_tree

    cfg2 = dataclasses.replace(cfg, **{"num_layers": 2, **depth2},
                               dtype="float32")
    defs2 = T.param_defs(cfg2)
    full2 = depth2_weights(torch, cfg, dev, **depth2) if weights is None \
        else weights
    short_prompts = [p[:prompt_len] for p in prompts]
    scfg_kw = scfg_kw or {}
    one = mesh_serve(torch, cfg2, full2, None, dev, short_prompts, 16,
                     **scfg_kw)
    two = mesh_serve(torch, cfg2, shard_tree(
        full2, defs2, mesh, resident_axes(cfg2)), mesh, dev,
        short_prompts, 16, **scfg_kw)
    for key in ("tokens", "dispatches", "host_syncs"):
        if one[key] != two[key]:
            raise RuntimeError(f"{tag}: depth-2 float32 {key} differ "
                               f"between the mesh serve and one rank: "
                               f"{two[key]} vs {one[key]}")
    del full2
    if dev == "cuda" and weights is None:
        torch.cuda.empty_cache()
    return dict(tokens=sum(map(len, one["tokens"].values())),
                dispatches=one["dispatches"], host_syncs=one["host_syncs"])


# phase 21a's serves beside its batched bf16 one: packed (the flash
# kernel's segmented mode over the prefix gathered from both shards) and
# with the int8 cache (its scales gathered with its codes), as (config
# fields, ServeConfig fields)
LAYOUT_B_SERVES = {"packed": ({}, {"pack": True}),
                   "int8": ({"kv_dtype": "int8"}, {})}


def layout_b_serve(torch, cfg, params, mesh, dev: str, prompts,
                   kind: str) -> dict:
    """21a's serve ``kind`` of ``LAYOUT_B_SERVES`` on this rank: twice,
    8 new tokens, no profile; the second serve must repeat the first's
    tokens, and each makes its collective plan (a chunk psums the
    embedding, ``wo`` and the MLP a layer and gathers the prefix a layer:
    a packed chunk only where it has one, ``prefix_span`` > 0; a decode
    step adds the argmax's gather, the query heads' gather and the
    partials' combine a layer) and, on the card, launches decode
    attention ``n_attn`` times a decode step and flash in its chunk's mode
    (segmented when packed) ``n_attn`` times a chunk, the other mode
    never. Returns the second serve."""
    cfg_kw, scfg_kw = LAYOUT_B_SERVES[kind]
    cfg = dataclasses.replace(cfg, **cfg_kw)
    n_attn = cfg.layer_kinds().count("attn")
    pack = bool(scfg_kw.get("pack"))
    flash, other = (("flash_attention_segmented", "flash_attention") if pack
                    else ("flash_attention", "flash_attention_segmented"))
    tag = f"21a {kind}"
    runs = []
    for _ in range(2):
        run = mesh_serve(torch, cfg, params, mesh, dev, prompts, 8,
                         **scfg_kw)
        _serve_checks(tag, run, 1 + (2 if pack else 3) * n_attn,
                      2 + 4 * n_attn, dev, ("decode_attention", flash,
                                            "pim_matvec", "layernorm"),
                      per_prefix=n_attn if pack else 0)
        dc, got = run["dispatches"], run["launches"]
        if dev == "cuda" and (
                got.get("decode_attention") != n_attn * dc["decode"]
                or got.get(flash) != n_attn * dc["prefill"]
                or got.get(other, 0)):
            raise RuntimeError(f"{tag}: launches {got} in {dc} of "
                               f"{n_attn} layers")
        runs.append(run)
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise RuntimeError(f"{tag}: a second serve gave other tokens")
    run = dict(runs[1], first_serve_s=runs[0]["wall_s"])
    run["collectives_per_prefill_chunk"] = 1 + (2 if pack else 3) * n_attn
    run["collectives_per_decode_step"] = 2 + 4 * n_attn
    log(f"{tag}: {run['ms_per_decode_step']:.2f} ms a decode step, "
        f"prefill {run['prefill_s']:.2f} s in {dc['prefill']} dispatches, "
        f"{run['comm']['collectives']} collectives "
        f"({run['comm']['ms']:.1f} ms), peak {run['peak_bytes']} B")
    return run


def multirank_serves(torch, rank: int, dev: str, small: bool) -> dict:
    """21a (granite-20b: tensor parallelism, its cache in layout B;
    served batched, then packed and with the int8 cache,
    ``layout_b_serve``) and 21b (qwen3-moe: tensor-parallel attention,
    expert-parallel MoE) on this rank."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (init_params, resident_axes,
                                           shard_tree)

    granite, qwen, _ = multirank_cfgs(small)
    mesh = make_host_mesh(model=2)
    out = {}
    for tag, cfg in (("21a", granite), ("21b", qwen)):
        n_attn = cfg.layer_kinds().count("attn")
        # a prefill chunk: the embedding's psum, and a layer's psums of
        # attention's and the FFN's outputs (the MLP's, or the EP MoE's
        # over 'model'), with layout B's gather of the prefix before them;
        # a decode step the same and the sampled argmax's gather, with
        # layout B's gather of the query heads and its combine a layer
        # for the prefix's gather
        layers = cfg.num_layers
        if tag == "21a":
            per_prefill, per_decode = 1 + 3 * n_attn, 2 + 4 * n_attn
        else:
            per_prefill, per_decode = 1 + 2 * layers, 2 + 2 * layers
        defs = T.param_defs(cfg)
        full = init_params(defs, device=dev, seed=0)
        params = shard_tree(full, defs, mesh, resident_axes(cfg))
        del full
        if dev == "cuda":
            torch.cuda.empty_cache()
        prompts = serve_prompts(cfg.vocab_size)
        run = mesh_serve(torch, cfg, params, mesh, dev, prompts, 32)
        _serve_checks(tag, run, per_prefill, per_decode, dev,
                      ("decode_attention", "flash_attention", "pim_matvec",
                       "layernorm"))
        if tag == "21a" and dev == "cuda" and run["launches"][
                "decode_attention"] != n_attn * run["dispatches"]["decode"]:
            raise RuntimeError(f"21a: decode_attention launched "
                               f"{run['launches']['decode_attention']} times "
                               f"in {run['dispatches']['decode']} decode "
                               f"steps of {n_attn} layers")
        run["layers"] = cfg.num_layers
        run["collectives_per_prefill_chunk"] = per_prefill
        run["collectives_per_decode_step"] = per_decode
        # the busy share: a short serve of the same prompts, rank 0's
        # kernels traced
        short = mesh_serve(torch, cfg, params, mesh, dev, prompts, 4,
                           profile=(rank == 0 and dev == "cuda"))
        run["profile"] = short.get("profile")
        if tag == "21a":
            for kind in LAYOUT_B_SERVES:
                out[f"21a {kind}"] = tp_part(
                    f"21a {kind}", rank, "two serves", lambda kind=kind:
                    layout_b_serve(torch, cfg, params, mesh, dev, prompts,
                                   kind))
        del params
        if tag != "21a":
            run["parity_f32"] = depth2_mesh_parity(torch, tag, cfg, mesh,
                                                   dev, prompts)
        else:
            # one depth-2 tree for the three serves; the packed and int8
            # ones on whole prompts: continuation chunks that read a
            # prefix, and positions in both shards
            w2 = depth2_weights(torch, cfg, dev)
            run["parity_f32"] = depth2_mesh_parity(torch, tag, cfg, mesh,
                                                   dev, prompts, weights=w2)
            for kind, (cfg_kw, scfg_kw) in LAYOUT_B_SERVES.items():
                out[f"21a {kind}"]["parity_f32"] = tp_part(
                    f"21a {kind}", rank, "depth-2 parity",
                    lambda cfg_kw=cfg_kw, scfg_kw=scfg_kw, kind=kind:
                    depth2_mesh_parity(
                        torch, f"21a {kind}",
                        dataclasses.replace(cfg, **cfg_kw), mesh, dev,
                        prompts, scfg_kw=scfg_kw, prompt_len=None,
                        weights=w2))
            del w2
            if dev == "cuda":
                torch.cuda.empty_cache()
        out[tag] = run
        log(f"{tag} rank {rank}: {run['ms_per_decode_step']:.2f} ms a decode "
            f"step, {run['comm']['collectives']} collectives, peak "
            f"{run['peak_bytes']} B; depth-2 float32 parity held")
    return out


def leaf_paths(tree, pre: str = "") -> dict:
    """{"a/b": leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {pre: tree}
    out = {}
    for k in sorted(tree):
        out.update(leaf_paths(tree[k], f"{pre}/{k}" if pre else str(k)))
    return out


@contextlib.contextmanager
def f32_embedding_grad():
    """One rank's token lookup through an f32 copy of the table: the
    gradient's scatter-add over the batch's tokens accumulates in f32 and
    rounds to the table's dtype once; every other leaf's gradient as it
    was."""
    from repro_torch.models import layers as L

    lookup = L.embed_tokens
    L.embed_tokens = lambda p, tokens, vocab=None: \
        p["tok"].float()[tokens].to(p["tok"].dtype)
    try:
        yield
    finally:
        L.embed_tokens = lookup


def one_rank_step(torch, cfg, dev: str, batch, by_leaf: bool = False,
                  f32_embed: bool = False) -> dict:
    """The one-rank loss and gradient norm of the whole batch at the
    seed-0 weights (the data-parallel first step's yardstick); with
    ``by_leaf`` each leaf's norm too, with ``f32_embed`` the embedding's
    gradient accumulated in f32 (``f32_embedding_grad``)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import loss_and_grads

    params = init_params(T.param_defs(cfg), device=dev, seed=0)
    if cfg.dtype == "float32":
        leaves_to_f32(torch, params)
    with (f32_embedding_grad() if f32_embed else contextlib.nullcontext()):
        loss, _, grads = loss_and_grads(cfg, params, {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    out = dict(loss=float(loss), grad_norm=float(global_norm(grads)))
    if by_leaf:
        out["leaf_norms"] = {k: float(g.float().norm())
                             for k, g in leaf_paths(grads).items()}
    del grads, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def check_first_step(cfg, got: dict, want: dict, tol: float,
                     tag: str = "21c") -> dict:
    for k in want:
        if not abs(got[k] - want[k]) <= tol * abs(want[k]):
            raise RuntimeError(f"{tag}: the mesh step's first {k} "
                               f"{got[k]} vs one rank's {want[k]} (tol "
                               f"{tol} relative, {cfg.dtype})")
    return dict(mesh=got, one_rank=want)


def dp_first_step(torch, cfg, mesh, dev: str, B: int, S: int, tol: float,
                  tag: str = "21c") -> dict:
    """One AdamW step on ``mesh`` (data-parallel, tensor-parallel or both;
    each rank its resident part of the seed-0 weights): its loss and
    gradient norm against the one-rank loss and gradient of the whole
    batch."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (init_params, resident_axes,
                                           shard_tree)
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainStepConfig, make_train_step

    batch = SyntheticLM(cfg.vocab_size, S, B, seed=0).batch(0)
    want = one_rank_step(torch, cfg, dev, batch)
    defs = T.param_defs(cfg)
    params = init_params(defs, device=dev, seed=0)
    if cfg.dtype == "float32":
        leaves_to_f32(torch, params)
    params = shard_tree(params, defs, mesh, resident_axes(cfg))
    step = make_train_step(cfg, TrainStepConfig(
        learning_rate=lambda s: 1e-3), mesh, device=dev)
    _, _, m = step(params, adamw_init(params), batch)
    return check_first_step(cfg, dict(loss=float(m["loss"]),
                                      grad_norm=float(m["grad_norm"])),
                            want, tol, tag)


def dp_train(torch, rank: int, dev: str, small: bool) -> dict:
    """21c: data-parallel training, plain and compressed all-reduce."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import comm
    from repro_torch.train import TrainStepConfig, compression, make_train_step

    _, _, cfg = multirank_cfgs(small)
    mesh = make_host_mesh(data=2, model=1)
    B, S, steps = 4, (64 if small else 1024), 5     # B 2 x S a rank
    out = dict(layers=cfg.num_layers, B_per_rank=B // 2, S=S, steps=steps,
               params=param_count(T.param_defs(cfg)))
    batch = SyntheticLM(cfg.vocab_size, S, B, seed=0).batch(0)
    want = one_rank_step(torch, cfg, dev, batch)
    for mode, compress in (("plain", False), ("compressed", True)):
        params = init_params(T.param_defs(cfg), device=dev, seed=0)
        opt = adamw_init(params)
        err = compression.init_error_state(params) if compress else None
        step = make_train_step(cfg, TrainStepConfig(
            learning_rate=lambda s: 1e-3, compress_grads=compress), mesh,
            device=dev)
        losses, ms, per_step = [], [], []
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        traced = None
        for i in range(steps):
            comm.reset_stats()
            t0 = time.perf_counter()
            args = (params, opt, batch, err) if compress else \
                (params, opt, batch)
            if not compress and i == steps - 1:
                # rank 0 traces the last plain step's kernels (its time is
                # left out of the means); rank 1 runs it beside
                res = []
                if rank == 0 and dev == "cuda":
                    traced = device_profile(
                        torch, lambda: res.append(step(*args)))
                else:
                    res.append(step(*args))
                out_step = res[0]
            else:
                out_step = step(*args)
            if compress:
                params, opt, err, m = out_step
            else:
                params, opt, m = out_step
            losses.append(float(m["loss"]))      # waits for the step
            ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append(comm.stats())
            if not compress and len(losses) == 1:
                # the plain run's first step against one rank's whole batch
                out["first_step_bf16"] = check_first_step(cfg, dict(
                    loss=losses[0], grad_norm=float(m["grad_norm"])), want,
                    1e-2)
        plan = 3 if compress else 2
        for s in per_step:
            if s["collectives"] != plan:
                raise RuntimeError(f"21c {mode}: {s['collectives']} "
                                   f"collectives a step, the plan gives "
                                   f"{plan}: {s['by_kind']}")
        if not all(x == x for x in losses) or not losses[-1] < losses[0]:
            raise RuntimeError(f"21c {mode}: losses {losses} do not fall")
        # the means leave out the first step (it builds Triton's kernels)
        # and a traced one
        timed = slice(1, steps - 1 if not compress else steps)
        n_timed = len(ms[timed])
        run = dict(losses=losses, ms_per_step=sum(ms[timed]) / n_timed,
                   ms_runs=ms, collectives_per_step=plan,
                   collective_ms_per_step=sum(s["ms"] for s in
                                              per_step[timed]) / n_timed,
                   by_kind=per_step[-1]["by_kind"],
                   peak_bytes=(torch.cuda.max_memory_allocated()
                               if dev == "cuda" else 0))
        if traced is not None:
            run["profile"] = traced
        if compress:
            n = out["params"]
            payload = per_step[-1]["by_kind"]["psum"]["bytes"]
            if payload != n:
                raise RuntimeError(f"21c: the int8 payload is {payload} "
                                   f"bytes for {n} parameters")
            run.update(payload_bytes=payload, f32_payload_bytes=4 * n)
        out[mode] = run
        log(f"21c rank {rank} {mode}: {run['ms_per_step']:.1f} ms a step, "
            f"losses {losses}")
        del params, opt, err
        if dev == "cuda":
            torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    out["first_step_f32"] = dp_first_step(torch, cfg2, mesh, dev, 4,
                                          min(S, 64), 1e-4)
    return out


# --------------------------------------------------------------------------- #
# phase 22: tensor parallelism of llama3.2-1b on two ranks
# --------------------------------------------------------------------------- #
def first_decode_logits(torch, cfg, params, mesh, dev: str, prompts,
                        plain: bool = False):
    """The float32 logits (B, V) of the first decode step after the
    prompts' prefill (the engine's own flash chunks), under ``mesh``
    (None: one rank) and, with ``plain``, through the plain versions; a
    tensor-parallel rank's vocabulary columns gathered where the
    vocabulary is split (whisper-medium's stays whole)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh

    with (use_mesh(mesh) if mesh is not None else contextlib.nullcontext()), \
            (plain_path(ops) if plain else contextlib.nullcontext()):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_slots=8, max_len=1024, prefill_chunk=128), device=dev)
        for p in prompts:
            eng.add_request(p, max_new_tokens=1)
        eng.prefill_wave(eng.admit_wave())
        logits, _ = T.decode_step(cfg, params, eng.last_tok[:, None],
                                  eng.cache, eng.lens)
        split, _ = L.vocab_shard(params["embed"], cfg.vocab_size)
        logits = torch.cat(comm.gather_parts(logits.float(), split,
                                             "model"), -1)
    if dev == "cuda":
        torch.cuda.synchronize()
    return logits


def tp_bf16_step(torch, cfg, mesh, dev: str, prompts,
                 tag: str = "22a") -> dict:
    """22a's bf16 bound: the first decode step's logits on the two ranks
    and on one rank through the kernels, each against the one-rank plain
    path in float32 (the seed-0 weights cast in place); the mesh's max
    |error| at most twice the one rank's (phase 3d's form)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (init_params, resident_axes,
                                           shard_tree)

    torch.backends.cuda.matmul.allow_tf32 = False
    defs = T.param_defs(cfg)
    full = init_params(defs, device=dev, seed=0)
    runs = {"one rank": first_decode_logits(torch, cfg, full, None, dev,
                                            prompts),
            "two ranks": first_decode_logits(
                torch, cfg, shard_tree(full, defs, mesh, resident_axes(cfg)),
                mesh, dev, prompts)}
    leaves_to_f32(torch, full)
    f32 = first_decode_logits(torch, dataclasses.replace(
        cfg, dtype="float32"), full, None, dev, prompts, plain=True)
    del full
    if dev == "cuda":
        torch.cuda.empty_cache()
    err = {k: float((v - f32).abs().max()) for k, v in runs.items()}
    if not all(bool(torch.isfinite(v).all()) for v in runs.values()):
        raise RuntimeError(f"{tag}: non-finite bf16 logits")
    if err["two ranks"] > 2 * err["one rank"]:
        raise RuntimeError(f"{tag}: the two ranks' bf16 max |err| "
                           f"{err['two ranks']:.4g} against float32 exceeds "
                           f"twice one rank's {err['one rank']:.4g}")
    return dict(max_abs_err=err, bound=2 * err["one rank"],
                max_abs_f32=float(f32.abs().max()), shape=list(f32.shape))


def tp_serve(torch, rank: int, dev: str, small: bool) -> dict:
    """22a: llama3.2-1b at full size (``small``: ``.reduced()``) on (1, 2),
    every dense leaf but the norms halved over 'model'."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (init_params, local_defs,
                                           param_bytes, resident_axes,
                                           shard_tree)

    cfg = get_arch("llama3.2-1b")
    cfg = cfg.reduced() if small else cfg
    mesh = make_host_mesh(model=2)
    L = cfg.num_layers
    defs = T.param_defs(cfg)
    params = shard_tree(init_params(defs, device=dev, seed=0), defs, mesh,
                        resident_axes(cfg))
    if dev == "cuda":
        torch.cuda.empty_cache()
    held = sum(t.numel() * t.element_size() for t in leaves(params))
    want = param_bytes(local_defs(defs, mesh, resident_axes(cfg)))
    if held != want or held > 0.51 * param_bytes(defs):
        raise RuntimeError(f"22a: rank {rank} holds {held} parameter bytes, "
                           f"local_defs gives {want} of the tree's "
                           f"{param_bytes(defs)}")
    prompts = serve_prompts(cfg.vocab_size)
    run = mesh_serve(torch, cfg, params, mesh, dev, prompts, 32)
    # a prefill chunk: the embedding's psum and two a layer (attention's
    # and the MLP's wo); a decode step the same and the sampled argmax's
    # gather
    per_prefill, per_decode = 1 + 2 * L, 2 + 2 * L
    _serve_checks("22a", run, per_prefill, per_decode, dev,
                  ("decode_attention", "flash_attention", "pim_matvec",
                   "layernorm"))
    # one rank's GEMVs a decode step (q, k, v, o, wg, wi and wo a layer),
    # decode attention and the prefill chunks' flash, by shape
    run["by_shape"] = check_shapes("22a serve", run["by_shape"],
                                   tp_serve_shapes(cfg, run["dispatches"]))
    run.update(layers=L, param_bytes=held, tree_param_bytes=param_bytes(defs),
               collectives_per_prefill_chunk=per_prefill,
               collectives_per_decode_step=per_decode)
    short = mesh_serve(torch, cfg, params, mesh, dev, prompts, 4,
                       profile=(rank == 0 and dev == "cuda"))
    run["profile"] = short.get("profile")
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    run["parity_f32"] = depth2_mesh_parity(torch, "22a", cfg, mesh, dev,
                                           prompts)
    run["bf16_step"] = tp_bf16_step(torch, cfg, mesh, dev, prompts)
    log(f"22a rank {rank}: {run['ms_per_decode_step']:.2f} ms a decode "
        f"step, {run['comm']['collectives']} collectives "
        f"({run['comm']['ms']:.1f} ms), peak {run['peak_bytes']} B, "
        f"{held} parameter bytes; depth-2 float32 parity held; bf16 "
        + json.dumps(run["bf16_step"]["max_abs_err"]))
    return run


def tp_train(torch, rank: int, dev: str, small: bool) -> dict:
    """22b: llama3.2-1b at full width cut to 4 of 16 layers, remat full,
    AdamW, B 4 x S 1024 on both ranks of (1, 2), 5 steps."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (init_params, resident_axes,
                                           shard_tree)
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import comm
    from repro_torch.train import TrainStepConfig, make_train_step

    cfg = get_arch("llama3.2-1b")
    cfg = dataclasses.replace(cfg.reduced() if small else cfg, num_layers=4,
                              remat="full")
    mesh = make_host_mesh(model=2)
    L, (B, S, steps) = cfg.num_layers, (4, 64 if small else 1024, 5)
    batch = SyntheticLM(cfg.vocab_size, S, B, seed=0).batch(0)
    want = one_rank_step(torch, cfg, dev, batch)
    defs = T.param_defs(cfg)
    params = shard_tree(init_params(defs, device=dev, seed=0), defs, mesh,
                        resident_axes(cfg))
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainStepConfig(
        learning_rate=lambda s: 1e-3), mesh, device=dev)
    # a step: the forward's embedding psum, two psums a layer and the
    # loss's gather; in the backward, a layer's forward recomputed (remat
    # full) up to its last saved activation, attention's psum (the
    # checkpoint stops there, before the MLP's), two means a layer
    # (attention's and the MLP's inputs), the LM head's and the loss
    # gather's transpose; the replicated leaves' sum and the clip norm's
    # psum
    plan = 6 + 5 * L
    out = dict(layers=L, B=B, S=S, steps=steps, collectives_per_step=plan)
    losses, ms, per_step, traced = [], [], [], None
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for i in range(steps):
        comm.reset_stats()
        t0 = time.perf_counter()
        res = []
        if i == steps - 1 and rank == 0 and dev == "cuda":
            # rank 0 traces the last step's kernels (left out of the
            # means); rank 1 runs it beside
            traced = device_profile(
                torch, lambda: res.append(step(params, opt, batch)))
        else:
            res.append(step(params, opt, batch))
        params, opt, m = res[0]
        losses.append(float(m["loss"]))          # waits for the step
        ms.append(1e3 * (time.perf_counter() - t0))
        per_step.append(comm.stats())
        if i == 0:
            out["first_step_bf16"] = check_first_step(cfg, dict(
                loss=losses[0], grad_norm=float(m["grad_norm"])), want,
                1e-2, "22b")
    launches = ops.launch_counts()
    for s_ in per_step:
        if s_["collectives"] != plan:
            raise RuntimeError(f"22b: {s_['collectives']} collectives a "
                               f"step, the plan gives {plan}: "
                               f"{s_['by_kind']}")
    if not all(x == x for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"22b: losses {losses} do not fall")
    if dev == "cuda":
        for k in ("flash_attention_bwd", "layernorm_bwd", "flash_attention",
                  "layernorm"):
            if not launches.get(k):
                raise RuntimeError(f"22b: {k} never launched")
    timed = slice(1, steps - 1)
    out.update(losses=losses, ms_runs=ms,
               ms_per_step=sum(ms[timed]) / len(ms[timed]),
               collective_ms_per_step=sum(x["ms"] for x in per_step[timed])
               / len(ms[timed]), by_kind=per_step[-1]["by_kind"],
               launches=launches,
               peak_bytes=(torch.cuda.max_memory_allocated()
                           if dev == "cuda" else 0))
    if traced is not None:
        out["profile"] = traced
    del params, opt
    if dev == "cuda":
        torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    out["first_step_f32"] = dp_first_step(torch, cfg2, mesh, dev, 4,
                                          min(S, 64), 1e-4, "22b")
    log(f"22b rank {rank}: {out['ms_per_step']:.1f} ms a step, "
        f"{out['collective_ms_per_step']:.1f} ms of collectives, losses "
        f"{losses}, peak {out['peak_bytes']} B")
    return out


# --------------------------------------------------------------------------- #
# phase 23: tensor parallelism of the recurrent, hybrid, encoder-decoder and
# VLM families on two ranks
# --------------------------------------------------------------------------- #
def tp_heads(cfg, m: int = 2) -> tuple:
    """A rank's attention heads and KV heads, and the head dim."""
    return cfg.num_heads // m, cfg.num_kv_heads // m, cfg.head_dim


def tp_serve_shapes(cfg, dc: dict, slots: int = 8, max_len: int = 1024,
                    chunk: int = 128, m: int = 2) -> dict:
    """A ``mesh_serve``'s launches by shape on a rank: the GEMVs of
    ``tp_gemv_plan`` and decode attention against the rank's cache heads
    once an attention layer, each decode step and (a sequential prefill)
    each prompt-token dispatch; a chunked prefill's c-th chunk flash once
    an attention layer at offset c x chunk over the cache's first (c + 1)
    x chunk positions."""
    from repro_torch.models import transformer as T

    steps = dc["decode"]
    n_attn = cfg.layer_kinds().count("attn")
    H, KH, D = tp_heads(cfg, m)
    plan = {}
    if T.supports_batched_prefill(cfg):
        for c in range(dc["prefill"]):
            key = flash_key(slots, H, KH, chunk, (c + 1) * chunk, D, True,
                            c * chunk)
            plan[key] = n_attn
    else:
        steps += dc["prefill"]
    for label, n in tp_gemv_plan(cfg, m, slots).items():
        plan[gemv_key(label)] = n * steps
    if n_attn:
        plan[decode_key(slots, H, KH, max_len, D)] = n_attn * steps
    return plan


def tp_layer_collectives(cfg) -> int:
    """The psums one token's pass through the stack makes on a
    tensor-parallel rank: an RWKV layer's time mix (``wo``) and channel
    mix (``wcv``); a Mamba layer's dt, B and C partials (one merged psum)
    and ``out_proj``; an attention layer's ``wo`` and whisper's cross
    ``wo``; each FFN's (the MLP's ``wo``, the MoE's combine)."""
    n = 0
    for mixer, _ in zip(cfg.layer_kinds(), cfg.ffn_kinds()):
        if mixer == "rwkv":
            n += 2
            continue
        n += (2 if mixer == "mamba" else 1) + 1
        if mixer == "attn" and cfg.family == "encdec":
            n += 1
    return n


def tp_gemv_plan(cfg, m: int = 2, n: int = 8) -> dict:
    """A decode step's GEMV launches on a rank of (1, m), by phase 2's
    label (n rows, d_in -> d_out, activation): a rank launches one rank's
    count, each product at its share of the widths. RWKV: r, k, v, g
    (d -> the rank's heads), ``wo``, the channel mix's ``wck``, ``wcv``
    and the whole ``wcr``; Mamba: ``in_proj_x``, ``in_proj_z`` and
    ``out_proj``; attention: q, k, v and o (whisper's cross q and o too);
    the dense MLP's gated three or two (a MoE FFN's experts are batched
    matmuls)."""
    from collections import Counter
    d, f = cfg.d_model, cfg.d_ff // m

    def lab(a, b, act="none"):
        return f"n{n} {a}->{b} {act}"
    calls = []
    for mixer, ffn in zip(cfg.layer_kinds(), cfg.ffn_kinds()):
        if mixer == "rwkv":
            h = cfg.num_heads * cfg.rwkv_head_dim // m
            calls += [lab(d, h)] * 4 + [lab(h, d), lab(d, f), lab(f, d),
                                        lab(d, d)]
            continue
        if mixer == "mamba":
            di = cfg.d_inner // m
            calls += [lab(d, di)] * 2 + [lab(di, d)]
        else:
            q = cfg.num_heads * cfg.head_dim // m
            kv = cfg.num_kv_heads * cfg.head_dim // m
            calls += [lab(d, q)] + [lab(d, kv)] * 2 + [lab(q, d)]
            if cfg.family == "encdec":
                calls += [lab(d, q), lab(q, d)]
        if ffn != "moe":
            calls += ([lab(d, f, "silu"), lab(d, f)] if cfg.act == "silu"
                      else [lab(d, f, cfg.act)]) + [lab(f, d)]
    return dict(Counter(calls))


def family_tp2_gemv() -> list:
    """The labels of ``tp_gemv_plan`` for phase 23's four configs at full
    width (phase 2 holds the GEMV at each)."""
    out = []
    for tag in ("23a", "23b", "23c", "23d"):
        out += [k for k in tp_gemv_plan(tp_family_cfg(tag, False))
                if k not in out]
    return out


def tp_step_launches(cfg) -> dict:
    """A decode step's launches on a rank (one rank's): the GEMVs of
    ``tp_gemv_plan``, decode attention once an attention layer (twice in
    whisper's: its cross cache), the norm twice a layer (three times in
    whisper's) and once at the end."""
    L = cfg.num_layers
    n_attn = cfg.layer_kinds().count("attn")
    cross = cfg.family == "encdec"
    return dict(NO_LAUNCH, pim_matvec=sum(tp_gemv_plan(cfg).values()),
                decode_attention=n_attn * (2 if cross else 1),
                layernorm=(3 if cross else 2) * L + 1)


def tp_vocab_split(cfg, m: int = 2) -> int:
    """1 when the rule table splits the vocabulary over 'model' (the
    embedding's psum and the argmax's gather), else 0."""
    return int(cfg.vocab_size % m == 0)


def tp_family_cfg(tag: str, small: bool):
    """23a's rwkv6-7b cut to 4 of 32 layers, 23b's jamba-v0.1-52b to one
    whole period (8 of 32), 23c's whisper-medium whole, 23d's pixtral-12b
    cut to 4 of 40; ``small``: their ``.reduced()`` widths."""
    from repro_torch.configs import get_arch
    name, depth = {"23a": ("rwkv6-7b", 4), "23b": ("jamba-v0.1-52b", 8),
                   "23c": ("whisper-medium", None),
                   "23d": ("pixtral-12b", 4)}[tag]
    cfg = get_arch(name)
    if small:
        return cfg.reduced()
    return cfg if depth is None else dataclasses.replace(cfg,
                                                         num_layers=depth)


def tp_rank_params(torch, cfg, mesh, dev: str, tag: str, rank: int):
    """The rank's parts of the seed-0 weights (drawn a leaf at a time),
    checked to be ``local_defs``'s bytes; with their share of the tree."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (init_shard, local_defs,
                                           param_bytes, resident_axes)

    defs = T.param_defs(cfg)
    params = init_shard(defs, mesh, resident_axes(cfg), device=dev, seed=0)
    if dev == "cuda":
        torch.cuda.empty_cache()
    held = sum(t.numel() * t.element_size() for t in leaves(params))
    want = param_bytes(local_defs(defs, mesh, resident_axes(cfg)))
    if held != want:
        raise RuntimeError(f"{tag}: rank {rank} holds {held} parameter "
                           f"bytes, local_defs gives {want}")
    return params, dict(param_bytes=held, tree_param_bytes=param_bytes(defs),
                        share=held / param_bytes(defs))


def tp_prefill_step(torch, cfg, params, dev: str, tag: str, shapes: dict,
                    batch) -> dict:
    """The full-sequence prefill step (``step_fn_for(cfg, "prefill")``) on
    a rank under the current mesh: one call after the serve (which built
    and warmed the kernels), its wall time, launches and collectives
    counted from 0;
    the launches by shape must be ``shapes``'s, the collectives the
    embedding's psum where the vocabulary is split and
    ``tp_layer_collectives``, the logits finite, the rank's vocabulary
    columns."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import step_fn_for
    from repro_torch.sharding import comm

    step = step_fn_for(cfg, "prefill", device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    comm.reset_stats()
    t0 = time.perf_counter()
    with launch_shapes(ops, dev == "cuda") as tally:
        logits = step(params, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    made = comm.stats()
    launches = ops.launch_counts()
    plan = tp_vocab_split(cfg) + tp_layer_collectives(cfg)
    if cfg.family == "encdec":
        plan += 2 * cfg.encoder_layers        # the encoder's blocks
    if made["collectives"] != plan:
        raise RuntimeError(f"{tag} prefill step: {made['collectives']} "
                           f"collectives, the plan gives {plan}: "
                           f"{made['by_kind']}")
    by_shape = check_shapes(f"{tag} prefill step", tally, shapes)
    B = batch["tokens"].shape[0]
    V = params["embed"]["tok"].shape[0]
    if tuple(logits.shape) != (B, V) or not bool(torch.isfinite(logits)
                                                 .all()):
        raise RuntimeError(f"{tag} prefill step: logits "
                           f"{tuple(logits.shape)}, a rank's (B, V) is "
                           f"{(B, V)}")
    return dict(ms=ms, launches=launches, by_shape=by_shape,
                collectives=plan, collective_ms=made["ms"], B=B, tokens=int(
                    batch["tokens"].shape[1]),
                peak_bytes=(torch.cuda.max_memory_allocated()
                            if dev == "cuda" else 0))


def tp_serve_checks(torch, tag: str, cfg, run: dict, dev: str) -> None:
    """A mesh serve's collectives and launches. A sequential prefill
    dispatch (the recurrent and encoder-decoder stacks) is a decode step
    of one slot's token: the embedding's psum where the vocabulary is
    split, and ``tp_layer_collectives``; a chunked one (pixtral) the same
    over the chunk; a decode step adds the argmax's gather. Launches: a
    decode step and a sequential dispatch ``tp_step_launches``, a chunk
    flash once a layer and the norm twice (``path_launches``); and by
    shape, ``tp_serve_shapes``."""
    from repro_torch.models import transformer as T

    v = tp_vocab_split(cfg)
    per_layer = tp_layer_collectives(cfg)
    _serve_checks(tag, run, v + per_layer, 2 * v + per_layer, dev, ())
    dc = run["dispatches"]
    run["by_shape"] = check_shapes(f"{tag} serve", run["by_shape"],
                                   tp_serve_shapes(cfg, dc))
    if dev != "cuda":
        return
    step = tp_step_launches(cfg)
    if T.supports_batched_prefill(cfg):
        chunk = path_launches(cfg, False)[1]
        want = {k: step.get(k, 0) * dc["decode"]
                + chunk.get(k, 0) * dc["prefill"] for k in step}
    else:
        want = {k: n * (dc["decode"] + dc["prefill"])
                for k, n in step.items()}
    got = {k: run["launches"].get(k, 0) for k in want}
    if got != want:
        raise RuntimeError(f"{tag} serve: launches {got}, one rank's plan "
                           f"gives {want} ({dc})")


def tp_family_serve(torch, tag: str, cfg, params, mesh, dev: str, rank: int,
                    prompts, max_new: int) -> dict:
    """A serve of ``prompts`` on the rank (``mesh_serve``), its checks, and
    a short profiled serve (rank 0 traces the card)."""
    run = mesh_serve(torch, cfg, params, mesh, dev, prompts, max_new)
    tp_serve_checks(torch, tag, cfg, run, dev)
    short = mesh_serve(torch, cfg, params, mesh, dev,
                       [p[:2] for p in prompts], 2,
                       profile=(rank == 0 and dev == "cuda"))
    run["profile"] = short.get("profile")
    run["collectives_per_decode_step"] = 2 * tp_vocab_split(cfg) \
        + tp_layer_collectives(cfg)
    return run


def tp_family_checks(torch, tag: str, cfg, mesh, dev: str, rank: int,
                     prompts, depth2=(), bf16=()) -> dict:
    """The depth-2 float32 parity of the mesh serve with one rank's, and
    the bf16 bound of the first decode step at depth 2 (full widths), on
    ``prompts`` (the recurrent stacks' and whisper's cut to 12 tokens:
    each token is a dispatch of their sequential prefill); ``depth2`` and
    ``bf16`` change the depth-2 configs (jamba's: ``JAMBA_STACK``, and
    for the bf16 bound its FFNs dense: a MoE router's top-2 pick flips
    under a bf16 rounding, the two ranks' psum or another order of sums,
    and then a row's logits part by far more than either path's rounding,
    as the CPU's `.reduced()` run shows on two of 8 rows; the float32
    parity holds the MoE layer exactly)."""
    depth2, bf16 = dict(depth2), dict(bf16 or depth2)
    out = dict(parity_f32=tp_part(tag, rank, "depth-2 parity", lambda:
                                  depth2_mesh_parity(torch, tag, cfg, mesh,
                                                     dev, prompts, **depth2)))
    cfg2 = dataclasses.replace(cfg, **{"num_layers": 2, **bf16})
    out["bf16_step"] = tp_part(tag, rank, "bf16 bound", lambda: tp_bf16_step(
        torch, cfg2, mesh, dev, prompts, tag))
    return out



def tp_part(tag: str, rank: int, what: str, fn):
    """``fn()``, its seconds logged (a rank's parts of phase 23)."""
    t0 = time.perf_counter()
    res = fn()
    log(f"{tag} rank {rank}: {what} took {time.perf_counter() - t0:.1f} s")
    return res


def tp_recurrent_prompts(vocab: int):
    """23a's and 23b's serve: 4 prompts of at most 12 tokens, 8 new
    tokens each (the recurrent stacks prefill one dispatch a token, and
    on two ranks each dispatch pays 9 or 24 collectives)."""
    return [p[:12] for p in recurrent_prompts(vocab)[:4]]


def tp_rwkv(torch, rank: int, dev: str, small: bool) -> dict:
    """23a: rwkv6-7b at full width cut to 4 of 32 layers on (1, 2), each
    rank 32 of the 64 heads and 7,168 of the 14,336 d_ff (``wcr`` and
    ``w_lora_a`` whole): a serve, ``tp_family_train`` (2 layers of its
    own beside the 8), then the prefill step at B 1 x S 2048
    (``rwkv_chunk`` at BH 32 a rank)."""
    import numpy as np
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.axes import use_mesh

    tag, cfg = "23a", tp_family_cfg("23a", small)
    mesh = make_host_mesh(model=2)
    params, out = tp_part(tag, rank, "weights", lambda: tp_rank_params(
        torch, cfg, mesh, dev, tag, rank))
    prompts = tp_recurrent_prompts(cfg.vocab_size)
    S = 64 if small else 2048
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, S))).to(dev)
    with use_mesh(mesh):
        out["serve"] = tp_part(tag, rank, "serve", lambda: tp_family_serve(
            torch, tag, cfg, params, mesh, dev, rank, prompts, 8))
    out["train"] = tp_part(tag, rank, "train", lambda: tp_family_train(
        torch, rank, dev, small))
    with use_mesh(mesh):
        out["step"] = tp_part(tag, rank, "prefill step", lambda:
                              tp_prefill_step(
                                  torch, cfg, params, dev, tag,
                                  {rwkv_key(cfg.num_heads // 2, S,
                                            cfg.rwkv_head_dim):
                                   cfg.num_layers}, {"tokens": tokens}))
    del params
    if dev == "cuda":
        empty_card(torch)
    out.update(tp_family_checks(torch, tag, cfg, mesh, dev, rank, prompts))
    tp_log(tag, rank, out)
    return out


def mesh_leaf_norms(torch, cfg, params, mesh, batch) -> dict:
    """Each leaf's norm of the train step's gradient on ``mesh`` (one data
    shard) at ``params``, the rank's parts: ``loss_and_grads`` and
    ``_reduce_grads`` as the step runs them, the squares of the leaves
    sharded over 'model' summed over its ranks in one psum."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import resident_axes, resident_specs
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh
    from repro_torch.train import loss_and_grads
    from repro_torch.train.step import _reduce_grads, _sharded

    specs = resident_specs(T.param_defs(cfg), mesh, resident_axes(cfg))
    with use_mesh(mesh):
        _, _, grads = loss_and_grads(cfg, params, batch)
    grads = leaf_paths(_reduce_grads(grads, specs, mesh, mesh.axis_names,
                                     mesh.size))
    split = torch.tensor([float("model" in _sharded(sp)) for sp in
                          leaf_paths(specs).values()], device=batch[
                              "tokens"].device)
    sq = torch.stack([g.float().square().sum() for g in grads.values()])
    sq = comm.psum_raw(sq * split, mesh, "model") + sq * (1 - split)
    return dict(zip(grads, sq.sqrt().tolist()))


EMBED_LEAF = "embed/tok"


def first_step_norms(torch, cfg, params, mesh, dev: str, batches) -> dict:
    """23a's first-step gradient against one rank's, leaf by leaf, at the
    seed-0 weights (``params`` the rank's parts; the two ranks' is the
    step's own gradient, ``mesh_leaf_norms``) on two batches: the train
    batch, whose SyntheticLM stream falls onto a fixed point (one token
    fills 2,040 of its 2,048 positions), and ``batch_for``'s uniform
    tokens. Readings on each: one rank in bf16 and in float32, the two
    ranks in bf16; on the train batch also one rank in bf16 with the
    table's gradient scatter-added in f32 (``f32_embedding_grad``: it
    must move no other leaf). Checks: on the uniform tokens the two
    ranks' norm within 1e-2 of one rank's; on the train batch, where one
    rank's own bf16 norm stands far from float32's, the two ranks' error
    against float32 at most twice one rank's (3d's form)."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    out = {}
    for name, b in batches.items():
        one = {"bf16": one_rank_step(torch, cfg, dev, b, by_leaf=True),
               "float32": one_rank_step(torch, f32, dev, b, by_leaf=True)}
        if name == "train":
            one["bf16 f32-scatter"] = one_rank_step(
                torch, cfg, dev, b, by_leaf=True, f32_embed=True)
            moved = [k for k, v in one["bf16 f32-scatter"][
                "leaf_norms"].items() if k != EMBED_LEAF
                and v != one["bf16"]["leaf_norms"][k]]
            if moved:
                raise RuntimeError(f"23a train: the f32 scatter-add moved "
                                   f"{moved}")
        norms = {k: v["leaf_norms"] for k, v in one.items()}
        norms["two ranks bf16"] = mesh_leaf_norms(torch, cfg, params, mesh, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        total = {k: sum(x * x for x in v.values()) ** 0.5
                 for k, v in norms.items()}
        two = norms["two ranks bf16"]
        worst = sorted(two, key=lambda k: -abs(two[k] - norms["bf16"][k])
                       / max(norms["bf16"][k], 1e-30))[:4]
        out[name] = dict(
            loss=one["bf16"]["loss"], norm=total, table={
                k: v[EMBED_LEAF] for k, v in norms.items()},
            most_apart={k: {r: norms[r][k] for r in norms} for k in worst})
        log(f"23a first-step gradient norms, {name} batch: "
            + json.dumps(out[name]))
    err = {k: abs(out["train"]["norm"][k] - out["train"]["norm"]["float32"])
           for k in ("bf16", "two ranks bf16")}
    out["train"]["abs_err"] = err
    rand = out["uniform"]["norm"]
    if abs(rand["two ranks bf16"] - rand["bf16"]) > 1e-2 * rand["bf16"]:
        raise RuntimeError(
            f"23a train: on uniform tokens the first step's bf16 gradient "
            f"norm {rand['two ranks bf16']} vs one rank's {rand['bf16']} "
            f"(tol 1e-2 relative)")
    if err["two ranks bf16"] > 2 * err["bf16"]:
        raise RuntimeError(
            f"23a train: the first step's bf16 gradient norm on two ranks "
            f"is {err['two ranks bf16']:.4g} from float32's, more than "
            f"twice one rank's {err['bf16']:.4g}")
    return out


def tp_family_train(torch, rank: int, dev: str, small: bool) -> dict:
    """23a's training: rwkv6-7b at full width cut to 2 of 32 layers, remat
    full, AdamW, B 1 x S 2048 on both ranks of (1, 2), 3 steps: the wkv's
    backward kernel at a rank's 32 heads (BH 32, counted by shape), the
    losses falling. The first step's loss within 1e-2 of one rank's, its
    gradient held to one rank's (``first_step_norms``); then the float32
    first step at depth 2 within 1e-4 of one rank's."""
    from repro_torch.data import SyntheticLM, batch_for
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_shard, resident_axes
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import comm
    from repro_torch.train import TrainStepConfig, make_train_step

    cfg = dataclasses.replace(tp_family_cfg("23a", small), num_layers=2,
                              remat="full")
    mesh = make_host_mesh(model=2)
    L, (B, S, steps) = cfg.num_layers, (1, 64 if small else 2048, 3)
    batch = SyntheticLM(cfg.vocab_size, S, B, seed=0).batch(0)
    params = init_shard(T.param_defs(cfg), mesh, resident_axes(cfg),
                        device=dev, seed=0)
    out = dict(layers=L, B=B, S=S, steps=steps)
    out["first_step_norms"] = first_step_norms(
        torch, cfg, params, mesh, dev, {"train": batch,
                                        "uniform": batch_for(cfg, B, S, 5)})
    want = out["first_step_norms"]["train"]
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainStepConfig(
        learning_rate=lambda s: 1e-3), mesh, device=dev)
    # a step: the forward's embedding psum, two psums a layer (the time
    # mix's wo, the channel mix's wcv) and the loss's gather; in the
    # backward, each layer's forward recomputed (remat full) through the
    # channel mix's psum (r * v saves v), two means a layer (the time
    # and channel mixes' inputs), the LM head's and the loss gather's
    # transpose; the replicated leaves' sum and the clip norm's psum
    plan = 6 + 6 * L
    out["collectives_per_step"] = plan
    losses, ms, per_step = [], [], []
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with launch_shapes(ops, dev == "cuda") as tally:
        for i in range(steps):
            comm.reset_stats()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))          # waits for the step
            ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append(comm.stats())
            if i == 0:
                out["first_step_bf16"] = check_first_step(
                    cfg, dict(loss=losses[0]), dict(loss=want["loss"]),
                    1e-2, "23a train")
                out["first_step_bf16"]["grad_norm"] = dict(
                    mesh=float(m["grad_norm"]),
                    one_rank=want["norm"]["bf16"])
    out["by_shape"] = check_shapes(
        "23a train", tally, {rwkv_key(B * cfg.num_heads // 2, S,
                                      cfg.rwkv_head_dim, bwd=True):
                             L * steps})
    launches = ops.launch_counts()
    for s_ in per_step:
        if s_["collectives"] != plan:
            raise RuntimeError(f"23a train: {s_['collectives']} collectives "
                               f"a step, the plan gives {plan}: "
                               f"{s_['by_kind']}")
    if not all(x == x for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"23a train: losses {losses} do not fall")
    timed = slice(1, steps)
    out.update(losses=losses, ms_runs=ms,
               ms_per_step=sum(ms[timed]) / len(ms[timed]),
               collective_ms_per_step=sum(x["ms"] for x in per_step[timed])
               / len(ms[timed]), by_kind=per_step[-1]["by_kind"],
               launches=launches,
               peak_bytes=(torch.cuda.max_memory_allocated()
                           if dev == "cuda" else 0))
    del params, opt
    if dev == "cuda":
        torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, dtype="float32")
    out["first_step_f32"] = dp_first_step(torch, cfg2, mesh, dev, B, 64,
                                          1e-4, "23a train")
    return out


def tp_jamba(torch, rank: int, dev: str, small: bool) -> dict:
    """23b: jamba-v0.1-52b at full width, one whole period (8 of 32
    layers: 7 Mamba, 1 attention; 4 MoE FFNs) on (1, 2), each rank 4,096
    of the 8,192 d_inner channels, 16 / 4 of the 32 / 8 heads, half of
    d_ff and 8 of the 16 experts: a serve and the prefill step at B 2 x
    S 2048 (``mamba_chunk`` at d 4,096 a rank). Its training on two ranks
    of one card does not fit (a rank's depth-2 step takes most of the
    card, phase 18); ``mamba_chunk_bwd`` at the rank's shape is phase
    2's."""
    import numpy as np
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.axes import use_mesh

    tag, cfg = "23b", tp_family_cfg("23b", small)
    mesh = make_host_mesh(model=2)
    params, out = tp_part(tag, rank, "weights", lambda: tp_rank_params(
        torch, cfg, mesh, dev, tag, rank))
    prompts = tp_recurrent_prompts(cfg.vocab_size)
    kinds = cfg.layer_kinds()
    H, KH, D = tp_heads(cfg)
    S = 64 if small else 2048
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, S))).to(dev)
    with use_mesh(mesh):
        out["serve"] = tp_part(tag, rank, "serve", lambda: tp_family_serve(
            torch, tag, cfg, params, mesh, dev, rank, prompts, 8))
        out["step"] = tp_part(tag, rank, "prefill step", lambda:
                              tp_prefill_step(
                                  torch, cfg, params, dev, tag,
                                  {mamba_key(2, S, cfg.d_inner // 2,
                                             cfg.ssm_d_state):
                                   kinds.count("mamba"),
                                   flash_key(2, H, KH, S, S, D):
                                   kinds.count("attn")},
                                  {"tokens": tokens}))
    del params
    if dev == "cuda":
        empty_card(torch)
    out.update(tp_family_checks(torch, tag, cfg, mesh, dev, rank,
                                prompts, JAMBA_STACK,
                                dict(JAMBA_STACK, num_experts=0)))
    tp_log(tag, rank, out)
    return out


def tp_whisper(torch, rank: int, dev: str, small: bool) -> dict:
    """23c: whisper-medium whole on (1, 2), each rank 8 of the 16 heads of
    the encoder, the self and the cross attention and half of d_ff (its
    vocabulary of 51,865 whole, as the rule table leaves it): a generate
    of 8 rows over 1,500 frames (the encoder, each layer's cross cache
    filled at the rank's heads, 2 teacher-forced and 6 greedy decode
    steps: 72 collectives each), then the prefill step at B 2 x 448
    tokens over 1,500 frames."""
    import collections

    from repro_torch.data import batch_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh

    tag, cfg = "23c", tp_family_cfg("23c", small)
    mesh = make_host_mesh(model=2)
    params, out = tp_part(tag, rank, "weights", lambda: tp_rank_params(
        torch, cfg, mesh, dev, tag, rank))
    L, E = cfg.num_layers, cfg.encoder_layers
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def batch(B, S, seed):
        b = batch_for(cfg, B, S, seed=seed)
        return {"tokens": torch.from_numpy(b["tokens"]).to(dev),
                "frame_embeds": torch.from_numpy(b["frame_embeds"]).to(
                    dev, dt)}
    step_batch = batch(2, 32 if small else 448, 3)
    gen = batch(8, 2, 4)
    n_steps = 6
    H, KH, D = tp_heads(cfg)
    F, S, S2 = cfg.encoder_seq, gen["tokens"].shape[1], \
        step_batch["tokens"].shape[1]
    # by shape: the generate's encoder flash once an encoder layer, then
    # each of its S teacher-forced and n_steps greedy decode steps decode
    # attention twice a layer (the self cache of 448, the cross cache of
    # the frames) and the GEMVs of ``tp_gemv_plan``; the prefill step's
    # flash once an encoder layer and twice a decoder layer (self, cross)
    steps = S + n_steps
    gen_shapes = collections.Counter({flash_key(8, H, KH, F, F, D, False): E})
    gen_shapes[decode_key(8, H, KH, 448, D)] += L * steps
    gen_shapes[decode_key(8, H, KH, F, D)] += L * steps
    for label, n in tp_gemv_plan(cfg).items():
        gen_shapes[gemv_key(label)] += n * steps
    step_shapes = collections.Counter({flash_key(2, H, KH, F, F, D, False): E})
    step_shapes[flash_key(2, H, KH, S2, S2, D)] += L
    step_shapes[flash_key(2, H, KH, S2, F, D, False)] += L
    with use_mesh(mesh):
        comm.reset_stats()
        run = tp_part(tag, rank, "generate", lambda: whisper_generate(
            torch, cfg, params, dev, gen["frame_embeds"], gen["tokens"],
            n_steps))
        made = comm.stats()
        out["step"] = tp_part(tag, rank, "prefill step", lambda:
                              tp_prefill_step(torch, cfg, params, dev, tag,
                                              step_shapes, step_batch))
    # the encoder's blocks once, then every decode step's layers, and
    # where the vocabulary is split (not whisper-medium's 51,865) each
    # step's embedding psum and each pick's argmax gather
    v = tp_vocab_split(cfg)
    plan = 2 * E + steps * (v + tp_layer_collectives(cfg)) \
        + (1 + n_steps) * v
    if made["collectives"] != plan:
        raise RuntimeError(f"23c generate: {made['collectives']} "
                           f"collectives, the plan gives {plan}")
    if dev == "cuda":
        step = tp_step_launches(cfg)
        want_dec = {k: n * n_steps for k, n in step.items()}
        got_dec = {k: run["decode_launches"].get(k, 0) for k in want_dec}
        want_pre = {k: n * S for k, n in step.items()}
        want_pre["flash_attention"] = E
        want_pre["layernorm"] += 2 * E + 1
        got_pre = {k: run["prefill_launches"].get(k, 0) for k in want_pre}
        if got_dec != want_dec or got_pre != want_pre:
            raise RuntimeError(f"23c generate: launches {got_pre} / "
                               f"{got_dec}, one rank's plan {want_pre} / "
                               f"{want_dec}")
    run["by_shape"] = check_shapes("23c generate", run["by_shape"],
                                   gen_shapes)
    run.update(collectives=plan, collective_ms=made["ms"], rows=8,
               prompt=S, steps=n_steps)
    out["generate"] = run
    del params
    if dev == "cuda":
        empty_card(torch)
    out.update(tp_family_checks(torch, tag, cfg, mesh, dev, rank, [
        p[:12] for p in whisper_prompts(cfg.vocab_size)]))
    tp_log(tag, rank, out)
    return out


def tp_pixtral(torch, rank: int, dev: str, small: bool) -> dict:
    """23d: pixtral-12b at full width cut to 4 of 40 layers on (1, 2),
    each rank 16 / 4 of the 32 / 8 heads of 160, half of d_ff and of the
    vocabulary: a short serve of phase 3's prompts, then the prefill step
    with 256 patches and 768 tokens a row (B 2)."""
    from repro_torch.data import batch_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.axes import use_mesh

    tag, cfg = "23d", tp_family_cfg("23d", small)
    mesh = make_host_mesh(model=2)
    params, out = tp_part(tag, rank, "weights", lambda: tp_rank_params(
        torch, cfg, mesh, dev, tag, rank))
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    H, KH, D = tp_heads(cfg)
    S = 64 if small else 1024        # the patches and the text
    b = batch_for(cfg, 2, S, seed=3)
    step_batch = {"tokens": torch.from_numpy(b["tokens"]).to(dev),
                  "patch_embeds": torch.from_numpy(b["patch_embeds"]).to(
                      dev, dt)}
    prompts = serve_prompts(cfg.vocab_size)
    with use_mesh(mesh):
        out["serve"] = tp_part(tag, rank, "serve", lambda: tp_family_serve(
            torch, tag, cfg, params, mesh, dev, rank, prompts, 8))
        out["step"] = tp_part(tag, rank, "prefill step", lambda:
                              tp_prefill_step(
                                  torch, cfg, params, dev, tag,
                                  {flash_key(2, H, KH, S, S, D):
                                   cfg.num_layers}, step_batch))
    del params
    if dev == "cuda":
        empty_card(torch)
    out.update(tp_family_checks(torch, tag, cfg, mesh, dev, rank, prompts))
    tp_log(tag, rank, out)
    return out


def tp_log(tag: str, rank: int, out: dict) -> None:
    serve = out.get("serve") or out.get("generate")
    # (whisper's generate times its decode steps on the card alone)
    ms = serve.get("ms_per_decode_step", float("nan"))
    log(f"{tag} rank {rank}: {ms:.2f} ms a decode "
        f"step, prefill step {out['step']['ms']:.1f} ms, "
        f"{out['param_bytes']} parameter bytes ({out['share']:.4f} of the "
        f"tree); depth-2 float32 parity held; bf16 "
        + json.dumps(out["bf16_step"]["max_abs_err"]))


def tp_families(torch, rank: int, dev: str, small: bool) -> dict:
    """Phase 23 on this rank: 23a-23d one after another, the card emptied
    between them."""
    out = {}
    for tag, fn in (("23a", tp_rwkv), ("23b", tp_jamba),
                    ("23c", tp_whisper), ("23d", tp_pixtral)):
        t0 = time.perf_counter()
        out[tag] = fn(torch, rank, dev, small)
        out[tag]["took_s"] = time.perf_counter() - t0
        if dev == "cuda":
            empty_card(torch)
    return out


# each multi-rank phase: what a rank runs, a rank's limit for it, and the
# keys whose tokens or losses both ranks must agree on
MULTIRANK = {
    "21": (lambda torch, rank, dev, small: dict(
        multirank_serves(torch, rank, dev, small),
        **{"21c": dp_train(torch, rank, dev, small)}), MULTIRANK_JOIN_S,
        (("21a", "tokens"), ("21a packed", "tokens"), ("21a int8", "tokens"),
         ("21b", "tokens"), ("21c", "plain", "losses"),
         ("21c", "compressed", "losses"))),
    "22": (lambda torch, rank, dev, small: {
        "22a": tp_serve(torch, rank, dev, small),
        "22b": tp_train(torch, rank, dev, small)}, 120,
        (("22a", "tokens"), ("22b", "losses"))),
    "23": (tp_families, 150,
           (("23a", "serve", "tokens"), ("23a", "train", "losses"),
            ("23b", "serve", "tokens"), ("23c", "generate", "tokens"),
            ("23d", "serve", "tokens")))}


def multirank_rank(rank: int, world: int, store: str, outdir: str,
                   dev: str = "cuda", small: bool = False,
                   phases: str = "21") -> None:
    """One rank of the multi-rank phases (a spawned process): joins the
    gloo group, runs each phase's part (``MULTIRANK``) in turn, the card
    emptied between them, and writes its results and each phase's seconds
    to ``outdir/rank<r>.json``; any failure exits non-zero."""
    import datetime
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    try:
        if dev == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=150))
        res = dict(transport=gloo_cuda_probe(torch, dist, dev))
        for phase in phases.split(","):
            t0 = time.perf_counter()
            res[phase] = MULTIRANK[phase][0](torch, rank, dev, small)
            res[phase]["ranks_s"] = time.perf_counter() - t0
            if dev == "cuda":
                empty_card(torch)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def gloo_cuda_probe(torch, dist, dev: str) -> str:
    """Whether gloo takes an all-gather of CUDA tensors itself (the port
    stages every collective through pinned host buffers either way)."""
    if dev != "cuda":
        return "cpu tensors"
    x = torch.full((4,), float(dist.get_rank()), device="cuda")
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    try:
        dist.all_gather(parts, x)
        return "gloo took CUDA tensors in all_gather"
    except RuntimeError as e:
        return f"gloo refused CUDA tensors in all_gather: {str(e)[:120]}"


def multirank_phase(torch, dev: str = "cuda", small: bool = False,
                    phase: str = "21") -> dict:
    """Phases 21, 22 and 23 (``phase``: one or several, comma-separated):
    two ranks on ``cuda:0`` over gloo, spawned once for all of them. Fails
    if a rank fails, if the spawn outlives the phases' limits together or
    a phase its own on a rank, if the ranks' tokens or losses differ, or
    if any rank's check failed; returns {phase: its ranks' results}."""
    import multiprocessing as mp
    import shutil
    import tempfile

    phases = phase.split(",")
    limit = sum(MULTIRANK[p][1] for p in phases)
    t0 = time.perf_counter()
    if dev == "cuda":
        empty_card(torch)      # the ranks share the card with this process
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=multirank_rank, args=(
            r, 2, os.path.join(tmp, "store"), tmp, dev, small, phase))
            for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + limit
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) \
                    or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            fail(f"{phase}: the ranks exited {codes} (limit {limit} s)")
        res = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    took = time.perf_counter() - t0
    log(f"phases {phase} took {took:.1f} s in one spawn; "
        f"transport: {res[0]['transport']}; every collective an all-gather "
        f"over gloo, CUDA payloads staged through pinned host buffers")
    out = {}
    for p in phases:
        _, lim, agree = MULTIRANK[p]
        for path in agree:
            a, b = res[0][p], res[1][p]
            for key in path:
                a, b = a[key], b[key]
            if a != b:
                fail(f"{' '.join(path)}: the two ranks differ")
        secs = [r[p]["ranks_s"] for r in res]
        if max(secs) > lim:
            fail(f"{p}: a rank took {max(secs):.1f} s, over its {lim} s")
        log(f"phase {p} took {secs[0]:.1f} s on rank 0 (limit {lim} s)")
        for r, ranks in enumerate(res):
            for tag in sorted({q[0] for q in agree}):
                run = {k: {a: b for a, b in v.items() if a != "tokens"}
                       if isinstance(v, dict) else v
                       for k, v in ranks[p][tag].items() if k != "tokens"}
                log(f"{tag} rank {r} " + json.dumps(run))
        out[p] = dict(took_s=secs[0], ranks=[r[p] for r in res])
    return out


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases (2, 12, 12b, 12c, 14, 15, "
                         "16, 17, 18, 19, 20, 20c, 21, 22, 23, 21-23; 16 "
                         "runs 16b and 16c, 17 17b, 18 18b, 20 20b, 21-23 "
                         "the three in one spawn as the whole run does) to "
                         "run alone after the build, printing no result "
                         "lines")
    only = ap.parse_args().phases
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port's sources are not beside this script ({SRC})")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card, flush=True)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
            f"{torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        built = _build.build_all()
        checks = TraceChecks()
        log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
        for name, info in built.items():
            for entry in ptxas_entries(info["ptxas"]):
                log(f"ptxas {name}: " + json.dumps(entry))
                if name in SPILL_GATED and entry["spill_stores"]:
                    fail(f"ptxas spills in {entry['kernel']}")
                if trades_registers(entry["kernel"]) and \
                        entry["registers"] != DKDV_ENTRY_REGS:
                    fail(f"{entry['kernel']} enters with "
                         f"{entry['registers']} registers, not "
                         f"{DKDV_ENTRY_REGS}")
        if only is not None:
            alone = dict(FLEET_PHASES, **{
                "2": lambda torch, checks: check_kernels(torch),
                "14": whisper_phases, "15": pixtral_phases,
                "16": train_phases, "17": rwkv_train_phases,
                "18": jamba_train_phases, "19": whisper_train_phase,
                "20": pixtral_train_phases, "20c": gpt2_train_phase,
                **{p: lambda torch, checks, p=p: multirank_phase(
                    torch, phase=p) for p in MULTIRANK},
                "21-23": lambda torch, checks: multirank_phase(
                    torch, phase="21,22,23")})
            for phase in only.split(","):
                t0 = time.perf_counter()
                alone[phase](torch, checks)
                log(f"phase {phase} took {time.perf_counter() - t0:.1f} s")
            checks.run(card)
            log(f"partial run of phases {only}: no result lines")
            return

        t0 = time.perf_counter()
        report = check_kernels(torch)
        log("timing floor " + json.dumps(timing_floor(torch)))
        path = softmax_path(torch)
        log(f"phase 2 took {time.perf_counter() - t0:.1f} s")
        serves = full_width_serves(torch, checks)
        t0 = time.perf_counter()
        parity_serve(torch)
        log(f"phase 4 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        policy_parity(torch, checks)
        log(f"phase 9b took {time.perf_counter() - t0:.1f} s")
        rwkv_cfg = get_arch("rwkv6-7b")
        rwkv = recurrent_full_width(
            torch, rwkv_cfg, "rwkv", ("5", "5b"), ["pim_matvec", "layernorm"],
            {"rwkv_chunk": rwkv_cfg.num_layers})
        t0 = time.perf_counter()
        depth2_parity(torch, dataclasses.replace(
            rwkv_cfg, num_layers=2, dtype="float32"), "rwkv")
        log(f"phase 6 took {time.perf_counter() - t0:.1f} s")
        # jamba's 32 layers are 103 GB in bf16: one whole period of 8 fits
        jamba_cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"),
                                        num_layers=8)
        kinds = jamba_cfg.layer_kinds()
        jamba = recurrent_full_width(
            torch, jamba_cfg, "jamba", ("7", "7b", "7c"),
            ["pim_matvec", "layernorm", "decode_attention"],
            {"mamba_chunk": kinds.count("mamba"),
             "flash_attention": kinds.count("attn")})
        t0 = time.perf_counter()
        depth2_parity(torch, dataclasses.replace(
            jamba_cfg, num_layers=2, attn_period=2, attn_offset=1,
            dtype="float32"), "jamba")
        log(f"phase 8 took {time.perf_counter() - t0:.1f} s")
        gpt2 = gpt2_serves(torch, checks)
        qwen = moe_serves(torch)
        kimi = kimi_step(torch)
        for phase, fn in FLEET_PHASES.items():
            t0 = time.perf_counter()
            fn(torch, checks)
            log(f"phase {phase} took {time.perf_counter() - t0:.1f} s")
        whisper = whisper_phases(torch, checks)
        pixtral = pixtral_phases(torch, checks)
        train = train_phases(torch)
        train.update(family_train_phases(torch))
        empty_card(torch)
        ranks = multirank_phase(torch, phase="21,22,23")
        multi, tp, fam = ranks["21"], ranks["22"], ranks["23"]
        checks.run(card)
    except SystemExit:
        raise
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        fail("a phase raised")

    # each kernel's row at its main-path shape, its launches from the run
    # of its own path; then flash at the head dims of gpt2-2.5b (its
    # serves), kimi-k2 (its prefill step) and pixtral-12b (its prefill step
    # and packed serve; decode attention from its unpacked serve), and
    # whisper-medium's non-causal flash (one prefill step's launches at
    # each shape) and cross decode attention (a run of phase 14b:
    # prefill_with_cache's 16 steps and 32 decode steps); the training
    # kernels by phase 16 (llama), 17 (the wkv's backward), 18 (the Mamba
    # scan's; the flash backward at D 128), 19 (the flash backward at
    # whisper's two non-causal shapes, its runs' launches at each), 20c
    # (the backward at D 96) and 20 (D 160); at D 112 no path (kimi-k2
    # trains on no card yet): 0 launches, and phase 2's calls apart; and
    # flash, decode attention and the GEMV at llama's shapes on one of two
    # tensor-parallel ranks, and each kernel at phase 23's shapes on one of
    # two tensor-parallel ranks: the launches at the row's shape that rank
    # 0 counted (``launch_shapes``) in its run of the row's path, each run
    # held to its plan by shape in the rank: 22a's serve (its decode steps'
    # GEMVs and decode attention, the last prefill chunk's flash), 23's
    # prefill steps (the wkv, the Mamba scan, flash at jamba's, whisper's
    # and pixtral's heads), 23a's training (the wkv's backward), whisper's
    # generate (its encoder at 8 rows, the self and cross caches' decode
    # attention), the serves (decode attention, pixtral's last prefill
    # chunk) and the GEMV at each family's labels; the Mamba scan's
    # backward at the rank's shape has no path (jamba's training on two
    # ranks of one card does not fit): phase 2's calls alone
    per_step = whisper["14a"]["flash_by_shape_per_step"]
    tp22a = tp["ranks"][0]["22a"]
    bwd_shapes = train["19"]["flash_bwd_by_shape"]
    f23 = fam["ranks"][0]
    tp_runs = {"22a": tp22a, "23a": f23["23a"]["serve"],
               "23a step": f23["23a"]["step"],
               "23a train": f23["23a"]["train"],
               "23b": f23["23b"]["serve"], "23b step": f23["23b"]["step"],
               "23c": f23["23c"]["generate"], "23c step": f23["23c"]["step"],
               "23d": f23["23d"]["serve"], "23d step": f23["23d"]["step"]}

    def counted(kernel, run, key):
        return {"launches": {kernel: tp_runs[run]["by_shape"].get(key, 0)},
                "tp_key": key}

    def launched(kernel, n):
        return {"launches": {kernel: n}}
    rows = [(name, name, REPORTED[name],
             {"flash_attention_segmented": serves["3b packed"],
              "rwkv_chunk": rwkv["step"], "mamba_chunk": jamba["step"],
              "masked_softmax": path, "flash_attention_bwd": train["16"],
              "layernorm_bwd": train["16"], "rwkv_chunk_bwd": train["17"],
              "mamba_chunk_bwd": train["18"]}.get(name,
                                                  serves["3 unpacked"]))
            for name in SOURCES] + [
        ("flash_attention D96", "flash_attention",
         "B8 S128 span640 off512 D96 H20/20", gpt2["10b"]["unpacked"]),
        ("flash_attention_segmented D96", "flash_attention_segmented",
         REPORTED["flash_attention_segmented"] + " D96 H20/20",
         gpt2["10b"]["packed"]),
        ("flash_attention D112", "flash_attention",
         "B2 S1024 span1024 off0 D112 H64/8", kimi),
        ("flash_attention D160", "flash_attention",
         "B2 S1024 span1024 off0 D160", pixtral["15a"]),
        ("flash_attention_segmented D160", "flash_attention_segmented",
         REPORTED["flash_attention_segmented"] + " D160",
         pixtral["packed"]),
        ("decode_attention D160", "decode_attention", "B8 L1024 D160",
         pixtral["unpacked"]),
        ("flash_attention non-causal encoder", "flash_attention",
         "B2 Sq1500 Skv1500 non-causal H16/16",
         launched("flash_attention", per_step[
             flash_key(2, 16, 16, 1500, 1500, 64, False)])),
        ("flash_attention non-causal cross", "flash_attention",
         "B2 Sq448 Skv1500 non-causal H16/16",
         launched("flash_attention", per_step[
             flash_key(2, 16, 16, 448, 1500, 64, False)])),
        ("decode_attention cross", "decode_attention", "B8 L1500 H16/16",
         launched("decode_attention",
                  whisper["14b generate"]["cross_launches"])),
        ("flash_attention lse", "flash_attention", "B4 S1024 span1024 off0 "
         "lse", train["16"]),
        ("flash_attention_bwd D128", "flash_attention_bwd", "B2 S2048 D128",
         train["18"]),
        ("flash_attention_bwd D96", "flash_attention_bwd",
         "B4 S1024 D96 H20/20", train["20c"]),
        ("flash_attention_bwd D112", "flash_attention_bwd",
         "B2 S1024 D112 H64/8", None),
        ("flash_attention_bwd D160", "flash_attention_bwd", "B2 S1024 D160",
         train["20"]),
        ("flash_attention_bwd non-causal encoder", "flash_attention_bwd",
         "B2 S1500 non-causal H16/16",
         launched("flash_attention_bwd",
                  bwd_shapes[bwd_key(2, 16, 16, 1500, 1500, 64, False)])),
        ("flash_attention_bwd non-causal cross", "flash_attention_bwd",
         "B2 Sq448 Skv1500 non-causal H16/16",
         launched("flash_attention_bwd",
                  bwd_shapes[bwd_key(2, 16, 16, 448, 1500, 64, False)])),
        ("decode_attention partial", "decode_attention",
         "B8 L512 D128 H48/1 partial",
         launched("decode_attention",
                  multi["ranks"][0]["21a"]["launches"]["decode_attention"])),
        ("flash_attention_segmented layout B", "flash_attention_segmented",
         REPORTED["flash_attention_segmented"]
         + heads_label(*LAYOUT_B_HEADS),
         launched("flash_attention_segmented", multi["ranks"][0][
             "21a packed"]["launches"]["flash_attention_segmented"])),
        ("flash_attention TP2", "flash_attention",
         "B8 S128 span640 off512 H16/4",
         counted("flash_attention", "22a",
                 flash_key(8, 16, 4, 128, 640, 64, True, 512))),
        ("decode_attention TP2", "decode_attention", "B8 L1024 H16/4",
         counted("decode_attention", "22a", decode_key(8, 16, 4, 1024, 64)))
    ] + [
        (f"pim_matvec TP2 {label}", "pim_matvec", label,
         counted("pim_matvec", "22a", gemv_key(label)))
        for label in ("n8 2048->1024 none", "n8 2048->256 none",
                      "n8 1024->2048 none", "n8 2048->4096 silu",
                      "n8 2048->4096 none", "n8 4096->2048 none")] + [
        ("rwkv_chunk TP2", "rwkv_chunk", "BH32 T2048 K64",
         counted("rwkv_chunk", "23a step", rwkv_key(32, 2048, 64))),
        ("rwkv_chunk_bwd TP2", "rwkv_chunk_bwd", "BH32 T2048 K64 U32",
         counted("rwkv_chunk_bwd", "23a train",
                 rwkv_key(32, 2048, 64, bwd=True))),
        ("mamba_chunk TP2", "mamba_chunk", "B2 T2048 d4096 n16",
         counted("mamba_chunk", "23b step", mamba_key(2, 2048, 4096, 16))),
        ("mamba_chunk_bwd TP2", "mamba_chunk_bwd", "B2 T2048 d4096 n16",
         None),
        ("flash_attention D128 TP2", "flash_attention",
         "B2 S2048 span2048 off0 D128 H16/4",
         counted("flash_attention", "23b step",
                 flash_key(2, 16, 4, 2048, 2048, 128))),
        ("decode_attention D128 TP2", "decode_attention",
         "B8 L1024 D128 H16/4",
         counted("decode_attention", "23b", decode_key(8, 16, 4, 1024, 128))),
        ("flash_attention non-causal encoder TP2", "flash_attention",
         "B2 Sq1500 Skv1500 non-causal H8/8",
         counted("flash_attention", "23c step",
                 flash_key(2, 8, 8, 1500, 1500, 64, False))),
        ("flash_attention non-causal cross TP2", "flash_attention",
         "B2 Sq448 Skv1500 non-causal H8/8",
         counted("flash_attention", "23c step",
                 flash_key(2, 8, 8, 448, 1500, 64, False))),
        ("flash_attention whisper decoder TP2", "flash_attention",
         "B2 S448 span448 off0 H8/8",
         counted("flash_attention", "23c step",
                 flash_key(2, 8, 8, 448, 448, 64))),
        ("flash_attention non-causal encoder B8 TP2", "flash_attention",
         "B8 Sq1500 Skv1500 non-causal H8/8",
         counted("flash_attention", "23c",
                 flash_key(8, 8, 8, 1500, 1500, 64, False))),
        ("decode_attention cross TP2", "decode_attention", "B8 L1500 H8/8",
         counted("decode_attention", "23c", decode_key(8, 8, 8, 1500, 64))),
        ("decode_attention whisper self TP2", "decode_attention",
         "B8 L448 H8/8",
         counted("decode_attention", "23c", decode_key(8, 8, 8, 448, 64))),
        ("flash_attention D160 TP2", "flash_attention",
         "B2 S1024 span1024 off0 D160 H16/4",
         counted("flash_attention", "23d step",
                 flash_key(2, 16, 4, 1024, 1024, 160))),
        ("flash_attention D160 chunk TP2", "flash_attention",
         "B8 S128 span640 off512 D160 H16/4",
         counted("flash_attention", "23d",
                 flash_key(8, 16, 4, 128, 640, 160, True, 512))),
        ("decode_attention D160 TP2", "decode_attention",
         "B8 L1024 D160 H16/4",
         counted("decode_attention", "23d",
                 decode_key(8, 16, 4, 1024, 160)))] + [
        (f"pim_matvec TP2 {tag} {label}", "pim_matvec", label,
         counted("pim_matvec", tag, gemv_key(label)))
        for tag in ("23a", "23b", "23c", "23d")
        for label in tp_gemv_plan(tp_family_cfg(tag, False))]
    kernels = []
    for name, kernel, label, run in rows:
        route, source, replaces = SOURCES[kernel]
        r = report[kernel, label]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=0 if run is None else run["launches"][kernel],
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["label"], dtype=r["dtype"]))
        if run is None:       # a shape no path runs: phase 2's calls alone
            kernels[-1]["checked_calls"] = r["checked_launches"]
        elif "tp_key" in run and not kernels[-1]["launches"]:
            fail(f"{name}: rank 0 counted no launch at {run['tp_key']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
