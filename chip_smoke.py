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
     just before and read just after; every kernel must have launched;
  4. serve the same prompts through llama3.2-1b at full width and depth 2
     in float32 on the card and, through the plain versions, on the CPU:
     greedy tokens, dispatch counts and host syncs must be identical.

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
    from repro_torch.kernels.flash_attention import flash_attention
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


SOURCES = {
    "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:127"),
    "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:64"),
    "pim_matvec": ("cuda", "src/repro_torch/kernels/csrc/pim_matvec.cu",
                   "src/repro/kernels/pim_matvec.py:52"),
    "layernorm": ("triton", "src/repro_torch/kernels/layernorm.py",
                  "src/repro/kernels/layernorm.py:29"),
}
# the case of each kernel that the JSON line reports (a main-path shape)
REPORTED = {"flash_attention": "B8 S128 span640 off512",
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
            err = (got.float() - want.float()).abs()
            bad = err > tol + tol * want.float().abs()
            max_err = float(err.max())
            if not bool(torch.isfinite(got).all()) or bool(bad.any()):
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
        self.marks = []               # (kind, event, launch counts)

    def _mark(self, kind: str) -> None:
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((kind, ev, self.ops.launch_counts()))

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


def full_width_serve(torch) -> dict:
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_arch("llama3.2-1b")
    params = init_params(T.param_defs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    scfg = ServeConfig(max_slots=8, max_len=1024, prefill_chunk=128)
    clock = PhaseClock(torch, ops)
    eng = ServeEngine(cfg, params, scfg, recorder=clock, device="cuda")
    rng = np.random.default_rng(0)
    plens = [int(p) for p in rng.integers(64, 701, 8)]
    for p in plens:
        eng.add_request(rng.integers(0, cfg.vocab_size, p), max_new_tokens=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    if sorted(results) != list(range(8)) or any(
            len(v) != 32 or not all(0 <= t < cfg.vocab_size for t in v)
            for v in results.values()):
        fail(f"serve returned {({k: len(v) for k, v in results.items()})}")
    for leaf in eng.cache["pos0"].values():
        if not bool(torch.isfinite(leaf).all()):
            fail("non-finite values in the KV cache")
    if any(n == 0 for n in counts.values()):
        fail(f"a kernel of the main path never launched: {counts}")

    kinds = [m[0] for m in clock.marks]
    admit = kinds.index("admit")
    last_prefill = max(i for i, k in enumerate(kinds) if k == "prefill")
    decodes = [i for i, k in enumerate(kinds) if k == "decode"]
    ev = [m[1] for m in clock.marks]
    prefill_s = ev[admit].elapsed_time(ev[last_prefill]) / 1e3
    decode_s = ev[last_prefill].elapsed_time(ev[decodes[-1]]) / 1e3
    n_chunks = eng.dispatch_counts["prefill"]
    n_steps = eng.dispatch_counts["decode"]

    def delta(a, b):
        return {k: clock.marks[b][2][k] - clock.marks[a][2][k] for k in counts}
    per_chunk = {k: v / n_chunks for k, v in delta(admit, last_prefill).items()}
    per_step = {k: v / (len(decodes) - 1)
                for k, v in delta(decodes[0], decodes[-1]).items()}
    prefill_tokens = sum(p - 1 for p in plens)
    out = dict(prompt_lens=plens, wall_s=wall, prefill_s=prefill_s,
               prefill_tok_s=prefill_tokens / prefill_s,
               decode_s=decode_s, decode_tok_s=8 * 32 / decode_s,
               ms_per_decode_step=1e3 * decode_s / n_steps,
               dispatch_counts=eng.dispatch_counts, host_syncs=eng.host_syncs,
               async_fetches=eng.async_fetches,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=counts, launches_per_prefill_chunk=per_chunk,
               launches_per_decode_step=per_step)
    log("serve " + json.dumps(out))
    del eng, params
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
    params = tree(lambda a: a.float(), params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (5, 37, 130, 280)]
    runs = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else tree(lambda a: a.cpu(), params)
        eng = ServeEngine(cfg, p, ServeConfig(max_slots=4, max_len=300,
                                              prefill_chunk=128), device=dev)
        for pr in prompts:
            eng.add_request(pr, max_new_tokens=8)
        runs[dev] = (eng.run_until_done(), dict(eng.dispatch_counts),
                     eng.host_syncs)
    if runs["cuda"] != runs["cpu"]:
        fail(f"kernel path != plain path: {runs}")
    log(f"parity float32 depth 2: tokens, dispatches {runs['cuda'][1]} and "
        f"{runs['cuda'][2]} host syncs identical on cuda and cpu")


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

        report = check_kernels(torch)
        serve = full_width_serve(torch)
        parity_serve(torch)
    except SystemExit:
        raise
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        fail("a phase raised")

    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        r = report[name]
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
