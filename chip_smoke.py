#!/usr/bin/env python3
"""chip_smoke — the quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository's ``src/repro_torch``. Phases, each of which must pass:

  1. print the card (``nvidia-smi``: name, power limit) and build every
     CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each,
     in parallel), logging what ``ptxas`` gave each kernel (registers,
     shared memory, spills; a spill in the flash, decode, GEMV or wkv
     source fails the run);
  2. hold each kernel against its plain PyTorch version on the card, at
     the full-width shapes of the serving paths (llama3.2-1b's; rwkv6-7b's
     and jamba-v0.1-52b's decode FCs, norms and jamba's decode attention;
     rwkv6-7b's full-sequence prefill for ``rwkv_chunk``, also at the
     model's strong decays, and jamba-v0.1-52b's for ``mamba_chunk`` and
     for flash: S 2048, head dim 128, causal, beside SDPA with
     ``is_causal``; both prefill steps' norms; flash in both modes at the
     head dims that are no multiple of 64: gpt2-2.5b's prefill chunk (D
     96), kimi-k2's and pixtral-12b's prefill steps (D 112 and 160, S
     1024 causal); gpt2-xl's and gpt2-2.5b's decode FCs and norms,
     qwen3-moe's k/v FC and kimi-k2's prefill norm) plus ragged cases, in
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
  5. serve 8 requests (prompts of 8-64 tokens, 16 new tokens each)
     through rwkv6-7b at full width (bf16, random weights from a seed):
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
  7. serve 8 requests (prompts of 8-64 tokens, 16 new tokens each)
     through jamba-v0.1-52b at full width cut to depth 8 (one whole Jamba
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
  13. the port's own ``verify`` over every trace phases 9, 9b, 10, 12,
     12b and 12c recorded, in worker processes after the measured phases: the
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
     ms per decode round of the same serve.

``--phases 12,12b,12c`` builds the kernels and runs only the named fleet
phases and phase 13's checks of their traces, printing no result lines
(a development run).

The last two lines of standard output are the kernel table as one JSON
object (a row a kernel at its main-path shape, then flash at D 96 in both
modes, launched by phase 10b, and at D 112, by phase 11c), then
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
def time_ms(torch, fn, iters: int = 21, warmup: int = 3) -> float:
    """Median device time of one call, each call after an L2 flush (the
    serving path finds its weights and cache cold), by CUDA events. The
    flush also keeps the card busy while the host enqueues the call, and
    the median drops the odd call that the shared host held back."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
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
# rows (B 2 x S 1024, d 7168)
NORM_SHAPES = (("rmsnorm", 1024, 2048), ("rmsnorm", 8, 2048),
               ("layernorm", 8, 4096), ("rmsnorm", 8, 4096),
               ("layernorm", 4096, 4096), ("rmsnorm", 4096, 4096),
               ("layernorm", 1024, 1536), ("layernorm", 8, 1536),
               ("layernorm", 1024, 1920), ("layernorm", 8, 1920),
               ("rmsnorm", 2048, 7168))
# the flash shapes at the reference's head dims that are no multiple of 64,
# as (B, S, cache L, offset, H, KH, D): gpt2-2.5b's prefill chunk (MHA, 20
# heads of 96), kimi-k2's prefill step (S 1024 causal, 64 / 8 heads of
# 112) and pixtral-12b's (32 / 8 heads of 160), each with a ragged chunk
WIDE_FLASH = ((8, 128, 1024, 512, 20, 20, 96), (2, 37, 300, 128, 20, 20, 96),
              (2, 1024, 1024, 0, 64, 8, 112), (2, 37, 300, 128, 64, 8, 112),
              (2, 1024, 1024, 0, 32, 8, 160), (2, 37, 300, 128, 32, 8, 160))


def kernel_cases(torch, dtype):
    """(kernel, label, kernel call, plain call, library call, bytes, flops)
    at the serving path's full-width shapes and ragged ones."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_segmented)
    from repro_torch.kernels.layernorm import layernorm
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
    # mask), and WIDE_FLASH
    for B, S, L, off, h, kh, hd in ((8, 128, 1024, 512, H, KH, D),
                                    (4, 128, 300, 256, H, KH, D),
                                    (2, 37, 300, 128, H, KH, D),
                                    (2, 2048, 2048, 0, H, KH, 128)) \
            + WIDE_FLASH:
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
    # segmented flash: the packed layouts the planner gives -- the packed
    # serve's widest dispatch (phase 3b's prompts), and a ragged one with
    # padding columns, lanes without a prefix and Skv off the 32-key tile;
    # both at llama's heads and at WIDE_FLASH's
    layouts = (([len(p) for p in serve_prompts(2)], 128),
               ((80, 30, 12, 9, 3), 37))
    heads = ((H, KH, D), (20, 20, 96), (64, 8, 112), (32, 8, 160))
    for (h, kh, hd), (plens, C) in itertools.product(heads, layouts):
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
            rows=rows,
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
    # one; jamba's (head dim 128, max_len 256, lengths off every tile)
    for B, L, lens, hd in ((8, 1024, (1, 77, 700, 1023, 1024, 5, 333, 512), D),
                           (3, 300, (1, 299, 130), D),
                           (8, 256, (3, 67, 130, 200, 255, 19, 101, 250), 128)):
        q, k, v = rn(B, H, hd), rn(B, KH, L, hd), rn(B, KH, L, hd)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        mask = (torch.arange(L, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        cases.append(dict(
            kernel="decode_attention", tol=TIGHT_TOL, deterministic=True,
            label=f"B{B} L{L}" + ("" if hd == D else f" D{hd}"),
            run=lambda q=q, k=k, v=v, n=lengths: decode_attention(q, k, v, n),
            plain=lambda q=q, k=k, v=v, n=lengths:
                ref.decode_attention_ref(q, k, v, n),
            library=lambda q=q, k=k, v=v, m=mask:
                F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=m, enable_gqa=True),
            bytes=(2 * q.numel() + 2 * KH * hd * sum(lens)) * es + 4 * B,
            flops=4.0 * H * hd * sum(lens)))
    # matvec: llama's decode FCs -- wg/wi (d -> f), wo of the MLP (f -> d),
    # wq/wo of attention (d -> d), wk/wv (d -> KH*D) -- at n in {1, 3, 8}
    # slot rows; then rwkv6-7b's (4096 -> 4096, 4096 -> 14336, 14336 ->
    # 4096) and jamba-v0.1-52b's (4096 -> 8192, 8192 -> 4096, 4096 -> 1024);
    # gpt2-xl's and gpt2-2.5b's (d -> d for q, k, v and o; d -> 4d gelu and
    # 4d -> d, the non-gated MLP) and qwen3-moe-30b-a3b's k and v (2048 ->
    # 256), at the 8 rows the engine decodes
    shapes = [(n, d, f, "silu") for n in (1, 3, 8)] \
        + [(n, f, d, "none") for n in (1, 3, 8)] \
        + [(8, d, d, "none"), (8, d, KH * D, "none")] \
        + [(8, 4096, 4096, "none"), (8, 4096, 14336, "silu"),
           (8, 14336, 4096, "none"), (8, 4096, 8192, "none"),
           (8, 8192, 4096, "none"), (8, 4096, 1024, "none")] \
        + [s for dm in (1536, 1920) for s in (
            (8, dm, dm, "none"), (8, dm, 4 * dm, "gelu"),
            (8, 4 * dm, dm, "none"))] + [(8, d, 256, "none")]
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
    # batch; y in f32), a ragged T with u per row and y in r's dtype, a
    # narrow head, and the model's strong decays; r, k, v in the case's
    # dtype, decays in f32: exp(-exp(w0)) with w0 = log U(1e-3, 1) (many
    # near 1), or ("strong") w0 over ssm.py's clamp [-10, 4], down to about
    # 2e-24 a step. f32 takes the CUDA cores, bf16 the tensor-core route:
    # both held to the reference's 2e-3 for the chunked form where y is in
    # f32 (the model's call), bf16 y to the bound of the other tensor-core
    # kernels
    for BH, T_, K, U, y_dtype, strong in (
            (128, 2048, 64, 64, torch.float32, False),
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
    # the model's dtype), a ragged T, and the reduced config's widths; the
    # model's discretization (a = exp(dt A), u = dt x B). Timed in f32.
    for B, T_, di, n in ((2, 2048, 8192, 16), (1, 200, 8192, 16),
                         (2, 37, 128, 4)):
        if dtype == torch.bfloat16 and T_ == 2048:
            continue              # the bf16 instantiation: the small cases
        a, u, C = mamba_inputs(torch, g, B, T_, di, n, dtype)
        cases.append(dict(
            kernel="mamba_chunk", label=f"B{B} T{T_} d{di} n{n}",
            run=lambda a=a, u=u, C=C: ops.mamba_chunk(a, u, C),
            plain=lambda a=a, u=u, C=C: ref.mamba_chunk_ref(a, u, C),
            library=None, math="float32", timed="float32",
            bytes=es * (2 * B * T_ * di * n + B * T_ * n + B * T_ * di)
            + 4 * B * di * n,
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
}
# the sources whose kernels may not spill (the tensor-core routes and the
# redesigned decode kernels)
SPILL_GATED = ("flash_attention", "decode_attention", "pim_matvec",
               "rwkv_chunk")
# the case of each kernel that the JSON line reports (a main-path shape)
REPORTED = {"flash_attention": "B8 S128 span640 off512",
            "flash_attention_segmented": "R8 C128 span512",
            "decode_attention": "B8 L1024",
            "pim_matvec": "n8 2048->8192 silu",
            "layernorm": "rmsnorm rows1024 d2048",
            "rwkv_chunk": "BH128 T2048 K64",
            "masked_softmax": "rows32768 n640",
            "mamba_chunk": "B2 T2048 d8192 n16"}


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
    """A kernel's output as one tensor (rwkv_chunk returns y and S_T)."""
    if isinstance(out, tuple):
        return torch.cat([t.float().flatten() for t in out])
    return out


def check_kernels(torch) -> dict:
    """Every case of ``kernel_cases`` in both dtypes: fails on a kernel
    that disagrees with its plain version; returns the timed rows by
    (kernel, label)."""
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for c in kernel_cases(torch, dtype):
            tol = c.get("tol", TOL)[dname]
            atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
            got = flat(torch, c["run"]())
            want = flat(torch, c["plain"]())
            # a kernel that merges splits in a fixed order: a second call
            # gives the same bits
            again = flat(torch, c["run"]()) if c.get("deterministic") \
                else got
            torch.cuda.synchronize()
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
            limit = atol + rtol * want.float().abs()
            bad = err > limit
            max_err = float(err.max())
            if not finite or bool(bad.any()):
                fail(f"{c['kernel']} [{dname} {c['label']}] disagrees with "
                     f"its plain version: max |err| {max_err:.3g}, tol "
                     f"{atol} + {rtol} |want|")
            # the largest share of its bound that an element's error takes
            row = dict(kernel=c["kernel"], dtype=dname, label=c["label"],
                       max_abs_err=max_err,
                       tol_share=float((err / limit).max()),
                       deterministic=bool(c.get("deterministic")))
            if dname == c.get("timed", "bfloat16"):
                row["ms"] = time_ms(torch, c["run"])
                row["plain_ms"] = time_ms(torch, c["plain"])
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


def full_width_serve(torch, cfg, params, name: str, required, **engine_kw
                     ) -> dict:
    """One measured serve of ``serve_engine``'s requests. The kernels in
    ``required`` must launch. Launch counts are set to 0 just before the
    run and read just after; CUDA's sync debug mode counts every
    synchronizing call the run makes besides the engine's own fetch, and
    there must be none."""
    import warnings

    from repro_torch.kernels import ops

    clock = PhaseClock(torch, ops)
    eng = serve_engine(cfg, params, recorder=clock, **engine_kw)
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
    del eng
    torch.cuda.empty_cache()
    return out


TIMED = ("wall_s", "prefill_s", "prefill_tok_s", "decode_s", "decode_tok_s",
         "ms_per_decode_step")


def two_serves(a: dict, b: dict) -> dict:
    """Two measured serves of one kind as one record: the first's counts,
    the means and both runs of the times, whether the tokens repeated."""
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
                                      serve_prompts(cfg.vocab_size), tokens,
                                      pack=True)
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


def bf16_steps(torch, cfg, params, name: str, prompts, step_tokens,
               pack: bool, **engine_kw) -> dict:
    """A decode step and a prefill step of ``cfg`` in bf16, through the
    kernels and through the plain versions, both on the card, each against
    the same step's plain path in float32. The decode step is the first
    one after a wave's prefill (``prompts``, through the engine's own
    prefill: flash chunks, or sequential decode steps for the recurrent
    stacks); the prefill step is ``step_fn_for(cfg, "prefill")`` on
    ``step_tokens``. The kernel path's max |error| may be at most twice
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
    batch = {"tokens": step_tokens}

    def first_step(c, p, **kw):
        eng = serve_engine(c, p, prompts=prompts, max_new=1,
                           **{**engine_kw, **kw})
        eng.prefill_wave(eng.admit_wave())
        logits, _ = T.decode_step(c, p, eng.last_tok[:, None], eng.cache,
                                  eng.lens)
        return logits.float()

    def both(c, p, plain: bool, **kw):
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
                     S: int, runs: int = 2) -> dict:
    """The full-sequence prefill step (``step_fn_for(cfg, "prefill")``,
    ``forward_full(last_only=True)``) on (B, S) tokens: one unmeasured
    call, then ``runs`` measured ones by CUDA events. Each kernel of
    ``expect`` must launch exactly that many times in each."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import step_fn_for

    step = step_fn_for(cfg, "prefill")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S))).to("cuda")}
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
                "mamba_chunk_kernel", "norm_kernel", "softmax_kernel")


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
    """A serve (phase ``phases[0]``: 8 requests, 16 new tokens each,
    ``ServeConfig(max_slots=8, max_len=256)``; the kernels in ``required``
    must launch) and the prefill step at B 2 x S 2048 (``phases[1]``;
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
    t0 = time.perf_counter()
    serve = full_width_serve(torch, cfg, params, f"{phases[0]} {name} serve",
                             required, prompts=prompts, max_new=16, **kw)
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
                           [p[:16] for p in prompts], tokens[:, :1024],
                           pack=False, **kw)
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
def depth2_parity(torch, cfg, name: str, variants=({},)) -> None:
    """``cfg`` (full width, depth 2) in float32, through the kernels on the
    card and the plain versions on the CPU: the serve with 4 slots and
    short prompts gives identical greedy tokens, dispatch counts and host
    syncs under each of ``variants`` (``ServeConfig`` changes: packed
    prefill for the attention stacks); the prefill step at S 256 gives
    logits within 1e-4 (the plain scans are the sequential oracles), and,
    with MoE, the full-sequence forward's aux loss within 1e-4."""
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
    tokens = rng.integers(0, cfg.vocab_size, (2, 256))
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
            params[dev], {"tokens": tokens}).cpu()
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
        f"step S 256 logits max |err| "
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


def attention_serves(torch, cfg, params, phase: str, name: str) -> dict:
    """Phase 3's serve and 3b's packed one on ``cfg``: one unmeasured serve
    of each, then two measured ones in turns (unpacked, packed, packed,
    unpacked), each with exactly ``path_launches``'s kernels; the two
    serves of a kind must give the same tokens."""
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
                             required, **kw)
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


def kimi_step(torch) -> dict:
    """Phase 11c: kimi-k2-1t-a32b's prefill step at its published widths
    (d 7168, 64 / 8 heads of 112, 384 experts), cut to 1 of 61 layers, on
    B 2 x S 1024: flash at D 112 once, logits finite. It runs on an empty
    card: every earlier phase's tensors must be gone first."""
    import gc

    from repro_torch.configs import get_arch

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
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


def verify_traces(label: str, traces, fleet: bool) -> dict:
    """The port's verify passes over one serve's trace or one fleet's node
    traces: the protocol lint, the span hazards of the lowered steps, each
    step against its reference DAG, and (a fleet) the exactly-once and
    snapshot-provenance audits. Runs in a worker process."""
    from repro_torch.trace.lower import trace_to_commands
    from repro_torch.trace.schema import model_config_from_header
    from repro_torch.verify import (analyze_lowered, check_exactly_once,
                                    check_snapshot_provenance, lint_trace,
                                    verify_lowered_step)

    t0 = time.perf_counter()
    findings, steps = [], 0
    for tr in traces:
        findings += lint_trace(tr)
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
                f"{len(c['findings'])} finding(s), {c['seconds']:.2f} s")
        if bad:
            fail("13: the port's verify found "
                 + json.dumps([(c["label"], c["findings"][:3])
                               for c in bad]))
        out = dict(verify={c["label"]: {k: v for k, v in c.items()
                                        if k != "findings"}
                           for c in checked},
                   verify_cpu_s=sum(c["seconds"] for c in checked))
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


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=None,
                    help="comma-separated fleet phases (12, 12b, 12c) to run "
                         "alone after the build, printing no result lines")
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
        if only is not None:
            for phase in only.split(","):
                t0 = time.perf_counter()
                FLEET_PHASES[phase](torch, checks)
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
        checks.run(card)
    except SystemExit:
        raise
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        fail("a phase raised")

    # each kernel's row at its main-path shape, its launches from the run
    # of its own path; then flash at the head dims of gpt2-2.5b (its serves)
    # and kimi-k2 (its prefill step)
    rows = [(name, name, REPORTED[name],
             {"flash_attention_segmented": serves["3b packed"],
              "rwkv_chunk": rwkv["step"], "mamba_chunk": jamba["step"],
              "masked_softmax": path}.get(name, serves["3 unpacked"]))
            for name in SOURCES] + [
        ("flash_attention D96", "flash_attention",
         "B8 S128 span640 off512 D96 H20/20", gpt2["10b"]["unpacked"]),
        ("flash_attention_segmented D96", "flash_attention_segmented",
         REPORTED["flash_attention_segmented"] + " D96 H20/20",
         gpt2["10b"]["packed"]),
        ("flash_attention D112", "flash_attention",
         "B2 S1024 span1024 off0 D112 H64/8", kimi)]
    kernels = []
    for name, kernel, label, run in rows:
        route, source, replaces = SOURCES[kernel]
        r = report[kernel, label]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=run["launches"][kernel], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["label"], dtype=r["dtype"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
