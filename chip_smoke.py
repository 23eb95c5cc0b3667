#!/usr/bin/env python3
"""chip_smoke — the quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository's ``src/repro_torch``. Phases, each of which must pass:

  1. print the card (``nvidia-smi``: name, power limit) and build every
     CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each,
     in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at
     the full-width llama3.2-1b shapes of the serving path plus ragged
     cases, in float32 and bfloat16 (tolerances of the reference's kernel
     tests: 1e-4 and 5e-2), and time the kernel, the plain version and one
     PyTorch library call computing the same function;
  3. serve 8 requests through ``ServeEngine`` at full llama3.2-1b width
     (bf16, random weights from a seed) with the launch counts set to 0
     just before and read just after; every kernel of the unpacked path
     must have launched;
  3b. serve the same prompts with packed prefill (``pack=True``): the
     segmented flash kernel must have launched, and the run must make
     exactly one host sync per decode step and no hidden one;
  3c. serve them again with the int8 KV cache (``kv_dtype="int8"``);
  4. serve prompts through llama3.2-1b at full width and depth 2 in
     float32 on the card and, through the plain versions, on the CPU,
     unpacked, packed and with the int8 cache: greedy tokens, dispatch
     counts and host syncs must be identical, and on the card the packed
     serve must give the unpacked one's tokens, decode dispatches and
     host syncs.

The last two lines of standard output are the kernel table as one JSON
object, then ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when there is no CUDA device, when the port's sources are missing,
or when any phase fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 tensor / f32 CUDA cores
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


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
def kernel_cases(torch, dtype):
    """(kernel, label, kernel call, plain call, library call, bytes, flops)
    at the serving path's full-width shapes and ragged ones."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_segmented)
    from repro_torch.kernels.layernorm import layernorm
    from repro_torch.kernels.pim_matvec import pim_matvec

    g = torch.Generator(device="cuda").manual_seed(1)
    es = torch.finfo(dtype).bits // 8

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    H, KH, D, d, f = 32, 8, 64, 2048, 8192
    cases = []
    # flash: (B, chunk S, cache L, offset) -- the last case overhangs L
    for B, S, L, off in ((8, 128, 1024, 512), (4, 128, 300, 256),
                         (2, 37, 300, 128)):
        q = rn(B, H, S, D)
        kc, vc = rn(B, KH, L, D), rn(B, KH, L, D)
        span = min(off + S, L)
        k, v = kc[:, :, :span], vc[:, :, :span]
        pos_q = off + torch.arange(S, device="cuda")
        mask = pos_q[:, None] >= torch.arange(span, device="cuda")[None, :]
        pairs = sum(min(span, off + r + 1) for r in range(S))
        cases.append(dict(
            kernel="flash_attention",
            label=f"B{B} S{S} span{span} off{off}",
            run=lambda q=q, k=k, v=v, off=off: flash_attention(
                q, k, v, causal=True, q_offset=off),
            plain=lambda q=q, k=k, v=v, off=off: ref.flash_attention_ref(
                q, k, v, causal=True, q_offset=off),
            library=lambda q=q, k=k, v=v, m=mask:
                F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                               enable_gqa=True),
            bytes=(2 * q.numel() + 2 * B * KH * span * D) * es,
            flops=4.0 * B * H * pairs * D))
    # segmented flash: the packed layouts the planner gives -- the packed
    # serve's widest dispatch (phase 3b's prompts), and a ragged one with
    # padding columns, lanes without a prefix and Skv off the 32-key tile
    for plens, C in (([len(p) for p in serve_prompts(2)], 128),
                     ((80, 30, 12, 9, 3), 37)):
        info, R, span = packed_layout(torch, plens, C)
        Skv = span + C
        q = rn(R, H, C, D)
        k, v = rn(R, KH, Skv, D), rn(R, KH, Skv, D)
        mask = ((info[1][:, :, None] == info[3][:, None, :])
                & (info[0][:, :, None] >= info[2][:, None, :]))
        rows = (info[1] >= 0)[:, None, :, None].expand(R, H, C, D)
        cases.append(dict(
            kernel="flash_attention_segmented",
            label=f"R{R} C{C} span{span}", rows=rows,
            run=lambda q=q, k=k, v=v, i=info: flash_attention_segmented(
                q, k, v, i),
            plain=lambda q=q, k=k, v=v, i=info: ref.segment_attention_ref(
                q, k, v, *i),
            library=lambda q=q, k=k, v=v, m=mask[:, None]:
                F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                               enable_gqa=True),
            bytes=(2 * q.numel() + 2 * R * KH * Skv * D) * es
            + 4 * 2 * R * (C + Skv),
            flops=4.0 * H * D * float(mask.sum())))
    # decode: lengths of 1 and off every tile
    for B, L, lens in ((8, 1024, (1, 77, 700, 1023, 1024, 5, 333, 512)),
                       (3, 300, (1, 299, 130))):
        q, k, v = rn(B, H, D), rn(B, KH, L, D), rn(B, KH, L, D)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        mask = (torch.arange(L, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        cases.append(dict(
            kernel="decode_attention", label=f"B{B} L{L}",
            run=lambda q=q, k=k, v=v, n=lengths: decode_attention(q, k, v, n),
            plain=lambda q=q, k=k, v=v, n=lengths:
                ref.decode_attention_ref(q, k, v, n),
            library=lambda q=q, k=k, v=v, m=mask:
                F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=m, enable_gqa=True),
            bytes=(2 * q.numel() + 2 * KH * D * sum(lens)) * es + 4 * B,
            flops=4.0 * H * D * sum(lens)))
    # matvec: the decode step's FCs -- wg/wi (d -> f), wo of the MLP
    # (f -> d), wq/wo of attention (d -> d), wk/wv (d -> KH*D) -- at
    # n in {1, 3, 8} slot rows
    shapes = [(n, d, f, "silu") for n in (1, 3, 8)] \
        + [(n, f, d, "none") for n in (1, 3, 8)] \
        + [(8, d, d, "none"), (8, d, KH * D, "none")]
    for n, din, dout, act in shapes:
        x, w = rn(n, din), rn(din, dout, scale=din ** -0.5)
        lib_act = F.silu if act == "silu" else (lambda t: t)
        cases.append(dict(
            kernel="pim_matvec", label=f"n{n} {din}->{dout} {act}",
            run=lambda x=x, w=w, a=act: pim_matvec(x, w, None, a),
            plain=lambda x=x, w=w, a=act: ref.matvec_ref(x, w, None, a),
            library=lambda x=x, w=w, a=lib_act: a(torch.matmul(x, w)),
            bytes=(x.numel() + w.numel() + n * dout) * es,
            flops=2.0 * n * din * dout))
    # norm: prefill rows (8 slots x 128-token chunk) and decode rows
    for rows in (1024, 8):
        x, s = rn(rows, d, scale=3.0), rn(d)
        cases.append(dict(
            kernel="layernorm", label=f"rmsnorm rows{rows} d{d}",
            run=lambda x=x, s=s: layernorm(x, s, mode="rmsnorm"),
            plain=lambda x=x, s=s: ref.norm_ref(x, s, mode="rmsnorm"),
            library=lambda x=x, s=s: F.rms_norm(x, (d,), s, 1e-6),
            bytes=(2 * x.numel() + d) * es, flops=4.0 * rows * d))
    return cases


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
}
# the case of each kernel that the JSON line reports (a main-path shape)
REPORTED = {"flash_attention": "B8 S128 span640 off512",
            "flash_attention_segmented": "R8 C128 span512",
            "decode_attention": "B8 L1024",
            "pim_matvec": "n8 2048->8192 silu",
            "layernorm": "rmsnorm rows1024 d2048"}


def check_kernels(torch) -> dict:
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        tol = TOL[dname]
        for c in kernel_cases(torch, dtype):
            got = c["run"]()
            want = c["plain"]()
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all())
            if "rows" in c:       # padded query rows: finite garbage
                got, want = got[c["rows"]], want[c["rows"]]
            err = (got.float() - want.float()).abs()
            bad = err > tol + tol * want.float().abs()
            max_err = float(err.max())
            if not finite or bool(bad.any()):
                fail(f"{c['kernel']} [{dname} {c['label']}] disagrees with "
                     f"its plain version: max |err| {max_err:.3g}, tol {tol}")
            row = dict(kernel=c["kernel"], dtype=dname, label=c["label"],
                       max_abs_err=max_err)
            if dtype == torch.bfloat16:
                row["ms"] = time_ms(torch, c["run"])
                row["plain_ms"] = time_ms(torch, c["plain"])
                row["library_ms"] = time_ms(torch, c["library"])
                row["bound_ms"] = 1e3 * max(c["bytes"] / HBM_BYTES_PER_S,
                                            c["flops"] / PEAK_FLOPS[dname])
                row["bound_by"] = ("bytes" if c["bytes"] / HBM_BYTES_PER_S
                                   >= c["flops"] / PEAK_FLOPS[dname]
                                   else "operations")
                if c["label"] == REPORTED[c["kernel"]]:
                    report[c["kernel"]] = row
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


def serve_engine(cfg, params, recorder=None, **scfg_kw):
    """An engine at the full-width serves' settings (``ServeConfig(
    max_slots=8, max_len=1024, prefill_chunk=128, **scfg_kw)``) holding
    their 8 prompts, 32 new tokens each."""
    from repro_torch.serve import ServeConfig, ServeEngine

    scfg = ServeConfig(max_slots=8, max_len=1024, prefill_chunk=128,
                       **scfg_kw)
    eng = ServeEngine(cfg, params, scfg, recorder=recorder, device="cuda")
    for p in serve_prompts(cfg.vocab_size):
        eng.add_request(p, max_new_tokens=32)
    return eng


def full_width_serve(torch, cfg, params, name: str, required, **scfg_kw
                     ) -> dict:
    """One measured serve of ``serve_engine``'s requests. The kernels in
    ``required`` must launch. Launch counts are set to 0 just before the
    run and read just after; CUDA's sync debug mode counts every
    synchronizing call the run makes besides the engine's own fetch, and
    there must be none."""
    import warnings

    from repro_torch.kernels import ops

    clock = PhaseClock(torch, ops)
    eng = serve_engine(cfg, params, recorder=clock, **scfg_kw)
    plens = [len(r.prompt) for r in eng.queue]
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

    if sorted(results) != list(range(8)) or any(
            len(v) != 32 or not all(0 <= t < cfg.vocab_size for t in v)
            for v in results.values()):
        fail(f"{name}: serve returned "
             f"{({k: len(v) for k, v in results.items()})}")
    for leaf in eng.cache["pos0"].values():
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            fail(f"{name}: non-finite values in the KV cache")
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
               decode_s=decode_s, decode_tok_s=8 * 32 / decode_s,
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


def full_width_serves(torch) -> dict:
    """Phases 3, 3b and 3c on one set of full-width bf16 weights."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_arch("llama3.2-1b")
    params = init_params(T.param_defs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    unpacked = [k for k in ops.KERNELS if k != "flash_attention_segmented"]
    packed = [k for k in ops.KERNELS if k != "flash_attention"]
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
        out[name] = dict(a, **{k: (a[k] + b[k]) / 2 for k in TIMED},
                         **{f"{k}_runs": [a[k], b[k]] for k in TIMED},
                         same_tokens_both_runs=a["tokens"] == b["tokens"])
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
    del params
    torch.cuda.empty_cache()
    return out


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


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port's sources are not beside this script ({SRC})")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, SRC)
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
        log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
        for name, info in built.items():
            for line in info["ptxas"].splitlines():
                if "registers" in line or "spill stores" in line:
                    log(f"ptxas {name}: {line.strip()}")

        t0 = time.perf_counter()
        report = check_kernels(torch)
        log(f"phase 2 took {time.perf_counter() - t0:.1f} s")
        serves = full_width_serves(torch)
        t0 = time.perf_counter()
        parity_serve(torch)
        log(f"phase 4 took {time.perf_counter() - t0:.1f} s")
    except SystemExit:
        raise
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        fail("a phase raised")

    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        r = report[name]
        # each kernel's launches come from the serve of its own path
        serve = serves["3b packed" if name == "flash_attention_segmented"
                       else "3 unpacked"]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=serve["launches"][name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["label"], dtype=r["dtype"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
