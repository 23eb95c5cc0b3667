#!/usr/bin/env python3
"""Time this tree's backward kernels against another checkout's, in one
process.

    python3 tools/bwd_ab.py OTHER_CHECKOUT [--plans] [--flash-only]

Needs a CUDA card, nvcc and triton. The other checkout's
``csrc/flash_attention_bwd.cu`` is built by ``nvcc`` with this tree's
flags into ``build/ab/`` and called through the same C interface; its
``kernels/layernorm.py`` is loaded by its path and shares this tree's
helpers (``_checks``, ``ref``). At every shape of ``chip_smoke.FLASH_BWD``
and ``chip_smoke.NORM_BWD_SHAPES``, in bf16, both kernels are held
against the plain version (``chip_smoke``'s bounds: ``TIGHT_TOL`` for
flash, ``TOL`` for the norm) and timed by ``chip_smoke.time_ms`` in the
order this, other, other, this, beside the library call (the autograd
backward of SDPA, ``F.rms_norm`` or ``F.layer_norm``); a flash shape
whose head dim is not in the other checkout's ``BWD_HEAD_DIMS`` is timed
in this tree alone. ``--plans`` also times this tree's norm backward
under the other plans of ``PLANS`` at rows 4096 x d 2048 in each mode;
``--flash-only`` times the flash backward alone. Prints what ptxas gave
the other build's tensor-core kernels, one JSON line a shape (and one
with each kernel's device time a call, by ``torch.profiler``), then the
card's name and power limit.
"""
import ast
import ctypes
import functools
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


def other_flash_bwd(root: str):
    """The other checkout's flash backward, built from its source, and the
    head dims it takes."""
    csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
    out = os.path.join(ROOT, "build", "ab", "libother_flash_bwd.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    built = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
                            os.path.join(csrc, "flash_attention_bwd.cu")],
                           check=True, capture_output=True, text=True)
    for e in chip_smoke.ptxas_entries(built.stdout + built.stderr):
        if "tc_kernel" in e["kernel"]:
            print(json.dumps({"other_ptxas": e}), flush=True)
    serialized = (built.stdout + built.stderr).count("serialized")
    print(json.dumps({"other_wgmma_serialized": serialized}), flush=True)
    lib = ctypes.CDLL(out)
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
    flash_rows(g, *other_flash_bwd(args[0]))
    if "--flash-only" not in sys.argv:
        norm_rows(g, other_norm_bwd(args[0]))
    if "--plans" in sys.argv:
        plan_rows(g)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
