#!/usr/bin/env python3
"""Time this tree's backward kernels against another checkout's, in one
process.

    python3 tools/bwd_ab.py OTHER_CHECKOUT [--plans] [--flash-only]
        [--recurrent-only] [--train]

Needs a CUDA card, nvcc and triton. The other checkout's
``csrc/flash_attention_bwd.cu``, ``csrc/rwkv_chunk_bwd.cu`` and
``csrc/mamba_chunk_bwd.cu`` (with its ``csrc/mamba_chunk.cu``) are built by
``nvcc`` with this tree's flags into ``build/ab/`` and called through
their C interfaces; its ``kernels/layernorm.py`` is loaded by its path and
shares this tree's helpers (``_checks``, ``ref``). At every shape of
``chip_smoke.FLASH_BWD`` and ``chip_smoke.NORM_BWD_SHAPES``, in bf16, both
kernels are held against the plain version (``chip_smoke``'s bounds:
``TIGHT_TOL`` for flash, ``TOL`` for the norm) and timed by
``chip_smoke.time_ms`` in the order this, other, other, this, beside the
library call (the autograd backward of SDPA, ``F.rms_norm`` or
``F.layer_norm``); a flash shape whose head dim is not in the other
checkout's ``BWD_HEAD_DIMS`` is timed in this tree alone. The
recurrences' backward kernels run the same way at ``chip_smoke.RWKV_BWD``
and ``chip_smoke.MAMBA_BWD`` (the wkv's inputs in bf16 with dy in f32,
the Mamba scan's in f32, the model's calls; no library call computes
either), the Mamba scan's from the checkpoints that each checkout's
forward writes where its interface takes them (a checkout whose backward
walks twice writes its own). ``--plans`` also times this tree's norm
backward under the other plans of ``PLANS`` at rows 4096 x d 2048 in
each mode; ``--flash-only`` times the flash backward alone,
``--recurrent-only`` the recurrences' alone. ``--train`` then runs
``chip_smoke.py --phases 17,18`` (rwkv6-7b's and jamba's training steps
and their parity phases) in this tree and in the other checkout, in the
order this, other, other, this, one process each, and prints each run's
ms a step, tokens a second and peak memory. Prints what ptxas gave the
other build's tensor-core kernels, one JSON line a shape (and one with
each kernel's device time a call, by ``torch.profiler``), then the card's
name and power limit.
"""
import ast
import ctypes
import functools
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import layernorm as LN  # noqa: E402
from repro_torch.kernels._checks import stream_of  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import \
    flash_attention_bwd  # noqa: E402
from repro_torch.kernels import mamba_chunk as MC  # noqa: E402
from repro_torch.kernels import mamba_chunk_bwd as MB  # noqa: E402
from repro_torch.kernels import rwkv_chunk_bwd as RB  # noqa: E402

# the norm backward's plans timed beside the chosen one (the first):
# half and twice the programs (``bwd_plan`` given half or twice the SMs),
# a tile of 2,048 or 8,192 elements, 8 or 32 elements a thread (its
# module constants replaced)
PLANS = ({}, {"sms": 0.5}, {"sms": 2}, {"BWD_TILE": 2048},
         {"BWD_TILE": 8192}, {"BWD_PER_THREAD": 8}, {"BWD_PER_THREAD": 32})


def head_dims(root: str) -> tuple:
    """The ``BWD_HEAD_DIMS`` of a checkout's flash backward wrapper."""
    path = os.path.join(root, "src", "repro_torch", "kernels",
                        "flash_attention_bwd.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "BWD_HEAD_DIMS"
                for t in node.targets):
            return tuple(ast.literal_eval(node.value))
    raise SystemExit(f"{path} has no BWD_HEAD_DIMS")


def _nvcc(src: str, name: str, keep=()):
    """Build a checkout's source into build/ab/lib<name>.so with this
    tree's flags; print the ptxas lines of its kernels whose names
    contain any of ``keep``. Returns the library and the build's log."""
    out = os.path.join(ROOT, "build", "ab", f"lib{name}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    built = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
                            src], check=True, capture_output=True, text=True)
    log = built.stdout + built.stderr
    for e in chip_smoke.ptxas_entries(log):
        if any(k in e["kernel"] for k in keep):
            print(json.dumps({"other_ptxas": e}), flush=True)
    return ctypes.CDLL(out), log


def other_flash_bwd(root: str):
    """The other checkout's flash backward, built from its source, and the
    head dims it takes."""
    csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
    lib, log = _nvcc(os.path.join(csrc, "flash_attention_bwd.cu"),
                     "other_flash_bwd", ("tc_kernel",))
    print(json.dumps({"other_wgmma_serialized": log.count("serialized")}),
          flush=True)
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = _build.ARGTYPES["flash_attention_bwd_launch"]
    fn.restype = ctypes.c_int

    def run(q, k, v, o, lse, do, causal):
        B, H, S, D = q.shape
        KH, Skv = k.shape[1], k.shape[2]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(), B, H, KH, S, Skv, D,
                 int(causal), 1.0 / math.sqrt(D), 1, stream_of(q))
        if err:
            raise RuntimeError(f"other flash backward: CUDA error {err}")
        return dq, dk, dv
    return run, head_dims(root)


def other_recurrent_bwd(root: str):
    """The other checkout's wkv and Mamba scan backward kernels, built from
    its sources, each as a call like this tree's wrapper's. A checkout
    whose mamba_chunk_launch takes no checkpoints has the first version's
    backward, which writes its own (scratch in its argument list)."""
    csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
    rl, _ = _nvcc(os.path.join(csrc, "rwkv_chunk_bwd.cu"), "other_rwkv_bwd",
                  ("rwkv_chunk_bwd_kernel",))
    rfn = rl.rwkv_chunk_bwd_launch
    rfn.argtypes = _build.ARGTYPES["rwkv_chunk_bwd_launch"]
    rfn.restype = ctypes.c_int
    ml, _ = _nvcc(os.path.join(csrc, "mamba_chunk_bwd.cu"),
                  "other_mamba_bwd", ("mamba_chunk_bwd_kernel",))
    mfn = ml.mamba_chunk_bwd_launch
    mfn.argtypes = _build.ARGTYPES["mamba_chunk_bwd_launch"]
    mfn.restype = ctypes.c_int
    with open(os.path.join(csrc, "mamba_chunk.cu")) as f:
        takes_ck = "void* ck" in f.read()
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def rwkv(r, k, v, w, u, dy, ds=None):
        BH, T, K = r.shape
        dr, dk, dv = (torch.empty_like(r) for _ in range(3))
        dw = torch.empty(r.shape, dtype=torch.float32, device="cuda")
        du = torch.empty(u.shape, dtype=torch.float32, device="cuda")
        rows = torch.empty((BH, K), dtype=torch.float32, device="cuda")
        # room for either version's checkpoints (every 8 or 32 steps)
        ck = torch.empty((BH, -(-T // 8), 4096), dtype=torch.float32,
                         device="cuda")
        err = rfn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), dy.data_ptr(),
                  None if ds is None else ds.data_ptr(), dr.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                  rows.data_ptr(), ck.data_ptr(), BH, T, K, u.shape[0],
                  codes[r.dtype], codes[dy.dtype], stream_of(r))
        if err:
            raise RuntimeError(f"other rwkv_chunk_bwd: CUDA error {err}")
        return dr, dk, dv, dw, du

    def mamba(a, u, C, dy, dh, ck):
        B, T, d, n = a.shape
        da, du, dC = (torch.empty_like(t) for t in (a, u, C))
        part = torch.empty((B, MB.blocks(d, n), T, n), dtype=torch.float32,
                           device="cuda")
        p = [x.data_ptr() for x in (a, u, C, dy)] \
            + [None if dh is None else dh.data_ptr()]
        if takes_ck:
            args = p + [ck.data_ptr(), da.data_ptr(), du.data_ptr(),
                        dC.data_ptr(), part.data_ptr()]
        else:
            scratch = torch.empty((B, -(-T // 16), d, n),
                                  dtype=torch.float32, device="cuda")
            args = p + [da.data_ptr(), du.data_ptr(), dC.data_ptr(),
                        part.data_ptr(), scratch.data_ptr()]
        err = mfn(*args, B, T, d, n, codes[a.dtype], stream_of(a))
        if err:
            raise RuntimeError(f"other mamba_chunk_bwd: CUDA error {err}")
        return da, du, dC
    return rwkv, mamba


def recurrent_rows(g, other_rwkv, other_mamba):
    tol = {"float32": 2e-3, "bfloat16": chip_smoke.TIGHT_TOL["bfloat16"]}
    for BH, T, K, U, strong, final in chip_smoke.RWKV_BWD:
        r, k, v = (rn(g, BH, T, K, scale=0.5) for _ in range(3))
        w0 = (torch.rand((BH, T, K), generator=g, device="cuda") * 14 - 10
              if strong else
              torch.log(torch.rand((BH, T, K), generator=g, device="cuda")
                        * (1 - 1e-3) + 1e-3))
        w = torch.exp(-torch.exp(w0))
        u = torch.randn((U, K), generator=g, device="cuda") * 0.1
        dy = torch.randn((BH, T, K), generator=g, device="cuda")
        ds = torch.randn((BH, K, K), generator=g, device="cuda") \
            if final else None
        a = (r, k, v, w, u, dy, ds)
        kernels = {"this": lambda: RB.rwkv_chunk_bwd(*a),
                   "other": lambda: other_rwkv(*a)}
        ab(f"rwkv_chunk_bwd BH{BH} T{T} K{K} U{U}"
           + (" strong" if strong else "") + (" dS" if final else ""),
           kernels, None, ref.rwkv_chunk_bwd_ref(*a), tol["bfloat16"])
        print(json.dumps({"split": {
            name: kernel_split(fn) for name, fn in kernels.items()}}),
            flush=True)
    for B, T, d, n, final in chip_smoke.MAMBA_BWD:
        a, u, C = chip_smoke.mamba_inputs(torch, g, B, T, d, n,
                                          torch.float32)
        dy = torch.randn((B, T, d), generator=g, device="cuda")
        dh = torch.randn((B, d, n), generator=g, device="cuda") \
            if final else None
        ck = MC.mamba_chunk(a, u, C, checkpoints=True)[2]
        kernels = {"this": lambda: MB.mamba_chunk_bwd(a, u, C, dy, dh,
                                                      ck=ck),
                   "other": lambda: other_mamba(a, u, C, dy, dh, ck)}
        ab(f"mamba_chunk_bwd B{B} T{T} d{d} n{n}" + (" dh" if final else ""),
           kernels, None, ref.mamba_chunk_bwd_ref(a, u, C, dy, dh),
           tol["float32"])
        if T == 2048:                # the forward with and without them
            times = [chip_smoke.time_ms(torch, lambda c=c: MC.mamba_chunk(
                a, u, C, checkpoints=c)) for c in (False, True, True, False)]
            print(json.dumps({"mamba_chunk fwd, without / with ck": times}),
                  flush=True)
        print(json.dumps({"split": {
            name: kernel_split(fn) for name, fn in kernels.items()}}),
            flush=True)


def train_rows(other: str):
    """Phases 17 and 18 of chip_smoke.py in this tree and the other
    checkout, alternating, one process each, on a card this process has
    emptied (jamba's stack peaks near 60 GB)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name in ("this", "other", "other", "this"):
        root = ROOT if name == "this" else os.path.abspath(other)
        run = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                              "17,18"], cwd=root, capture_output=True,
                             text=True)
        if run.returncode:
            raise SystemExit(f"{name}'s phases 17, 18 failed:\n"
                             + run.stdout[-3000:] + run.stderr[-3000:])
        for line in run.stdout.splitlines():
            for phase in ("17", "18"):
                head = f"[chip_smoke] phase {phase} took "
                if line.startswith(head) and ": {" in line:
                    row = json.loads(line.split(": ", 1)[1])
                    print(json.dumps({"train": name, "phase": phase, **{
                        k: row[k] for k in ("ms_per_step", "ms_runs",
                                            "tokens_per_s", "flops_share",
                                            "max_memory_allocated")}}),
                          flush=True)


def other_norm_bwd(root: str):
    path = os.path.join(root, "src", "repro_torch", "kernels",
                        "layernorm.py")
    spec = importlib.util.spec_from_file_location("other_layernorm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.layernorm_bwd


def check(name, got, want, tol):
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    got, want = chip_smoke.flat(torch, got), chip_smoke.flat(torch, want)
    bad = (got.float() - want.float()).abs() > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"{name} disagrees with the plain version")


def ab(label, kernels, library, want, tol):
    times = {}
    for name in ("this", "other", "other", "this"):
        if name not in kernels:
            continue
        check(f"{name} {label}", kernels[name](), want, tol)
        times.setdefault(name, []).append(
            chip_smoke.time_ms(torch, kernels[name]))
    if library is not None:
        times["library"] = chip_smoke.time_ms(torch, library)
    print(json.dumps({"shape": label, "ms": times}), flush=True)


def rn(g, *shape, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale
            ).to(torch.bfloat16)


def kernel_split(fn, calls: int = 10) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, by
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def flash_rows(g, other, other_dims):
    for B, S, Skv, H, KH, D, causal in chip_smoke.FLASH_BWD:
        q, k, v = rn(g, B, H, S, D), rn(g, B, KH, Skv, D), rn(g, B, KH, Skv, D)
        do = rn(g, B, H, S, D)
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        a = (q, k, v, o, lse, do)
        lib_in = [t.detach().clone().requires_grad_() for t in (
            q, k.repeat_interleave(H // KH, 1),
            v.repeat_interleave(H // KH, 1))]
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=causal)
        kernels = {"this": lambda: flash_attention_bwd(*a, causal=causal)}
        if D in other_dims:
            kernels["other"] = lambda: other(*a, causal)
        ab(f"flash_bwd B{B} Sq{S} Skv{Skv} H{H}/{KH} D{D} causal{causal}",
           kernels,
           lambda: torch.autograd.grad(lib_out, lib_in, do,
                                       retain_graph=True),
           ref.flash_attention_bwd_ref(*a, causal=causal),
           chip_smoke.TIGHT_TOL["bfloat16"])
        print(json.dumps({"split": {
            name: kernel_split(fn) for name, fn in kernels.items()}}),
            flush=True)


def norm_inputs(g, mode, rows, d):
    x, dy = rn(g, rows, d, scale=3.0), rn(g, rows, d)
    s = rn(g, d) if mode != "np_layernorm" else None
    b = rn(g, d) if mode == "layernorm" else None
    return x, s, b, dy


def norm_library(mode, x, s, b, dy):
    d = x.shape[1]
    lib_in = [t.detach().clone().requires_grad_() for t in (x, s, b)
              if t is not None]
    out = (F.rms_norm(lib_in[0], (d,), lib_in[1], 1e-6)
           if mode == "rmsnorm" else
           F.layer_norm(lib_in[0], (d,), None if s is None else lib_in[1],
                        None if b is None else lib_in[2], 1e-5))
    return lambda: torch.autograd.grad(out, lib_in, dy, retain_graph=True)


def strip(t):
    return tuple(x for x in t if x is not None)


def norm_rows(g, other):
    for mode, rows, d in chip_smoke.NORM_BWD_SHAPES:
        x, s, b, dy = norm_inputs(g, mode, rows, d)
        ab(f"norm_bwd {mode} rows{rows} d{d}",
           {"this": lambda: strip(LN.layernorm_bwd(x, s, b, dy, mode=mode)),
            "other": lambda: strip(other(x, s, b, dy, mode=mode))},
           norm_library(mode, x, s, b, dy),
           strip(ref.norm_bwd_ref(x, s, b, dy, mode=mode)),
           chip_smoke.TOL["bfloat16"])
        print(json.dumps({"split": {
            "this": kernel_split(lambda: LN.layernorm_bwd(x, s, b, dy,
                                                          mode=mode)),
            "other": kernel_split(lambda: other(x, s, b, dy, mode=mode)),
            "library": kernel_split(norm_library(mode, x, s, b, dy))}}),
            flush=True)


def plan_rows(g):
    chosen = LN.bwd_plan
    consts = {n: getattr(LN, n) for n in ("BWD_TILE", "BWD_PER_THREAD")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def scaled(rows, d, n_sms, partials=True, times=1.0):
        return chosen(rows, d, max(1, int(n_sms * times)), partials)
    try:
        for mode in ("rmsnorm", "layernorm", "np_layernorm"):
            x, s, b, dy = norm_inputs(g, mode, 4096, 2048)
            want = strip(ref.norm_bwd_ref(x, s, b, dy, mode=mode))
            for kw in PLANS:
                LN.bwd_plan = functools.partial(scaled,
                                                times=kw.get("sms", 1.0))
                for n, v in consts.items():
                    setattr(LN, n, kw.get(n, v))

                def run():
                    return strip(LN.layernorm_bwd(x, s, b, dy, mode=mode))
                check(f"plan {kw} {mode}", run(), want,
                      chip_smoke.TOL["bfloat16"])
                print(json.dumps({
                    "plan": kw, "mode": mode,
                    "programs_per_rows_warps": LN.bwd_plan(
                        4096, 2048, sms, mode != "np_layernorm"),
                    "ms": [chip_smoke.time_ms(torch, run) for _ in range(2)]
                }), flush=True)
    finally:
        LN.bwd_plan = chosen
        for n, v in consts.items():
            setattr(LN, n, v)


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(args) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    flags = set(sys.argv[1:])
    if "--recurrent-only" not in flags:
        flash_rows(g, *other_flash_bwd(args[0]))
    if not flags & {"--flash-only", "--recurrent-only"}:
        norm_rows(g, other_norm_bwd(args[0]))
    if "--flash-only" not in flags:
        recurrent_rows(g, *other_recurrent_bwd(args[0]))
    if "--plans" in flags:
        plan_rows(g)
    if "--train" in flags:
        train_rows(args[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
