#!/usr/bin/env python3
"""Where the recurrences' backward kernels spend their time, on the card.

    python3 tools/recurrent_bwd_breakdown.py

Needs a CUDA card and nvcc. Builds ``csrc/rwkv_chunk_bwd.cu`` and
``csrc/mamba_chunk_bwd.cu`` as they are and in variants made by editing
their text into ``build/breakdown/`` (this tree's flags), and times each
at ``chip_smoke``'s main shapes (the wkv's BH 128, T 2048, K 64 with r,
k, v in bf16 and dy in f32; the Mamba scan's B 2, T 2048, d 8192, n 16
in f32) by ``chip_smoke.time_ms``, three rounds:

* the wkv's ``forward``: the forward walk alone (no reverse task runs);
  ``forward+level2``: the reverse's sub-chunk tasks skipped, so the
  forward and level-2 walks run with their staging and barriers;
  ``no_sums``: every task, without the per-sub-chunk sums of the
  partials (and without writing dr, dk, dv, dw);
* the scan's ``3_blocks``: its kernel bounded to 3 blocks an SM (85
  registers; ptxas's spills printed); ``128_threads``: blocks of 128
  threads, 4 an SM;
* a device copy of a (2.15 GB read and written), the rate a streaming
  kernel can reach.

A variant's outputs are not checked (most write less than the kernel);
the unchanged kernels are held against their plain versions by
``chip_smoke.py``. Prints one JSON line a round, then the card's name and
power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._checks import stream_of  # noqa: E402
from repro_torch.kernels.mamba_chunk import mamba_chunk  # noqa: E402
from repro_torch.kernels.mamba_chunk_bwd import blocks  # noqa: E402

OUT = os.path.join(ROOT, "build", "breakdown")
RWKV_SKIP_REVERSE = ("    // R: S before the sub-chunk\n",
                     "    // R: S before the sub-chunk\n"
                     "    if (T > 0) { __syncthreads(); continue; }\n")
RWKV = {
    "as_is": [],
    "forward": [("const int ntask = 2 * nsub - nck;",
                 "const int ntask = 0;")],
    "forward+level2": [RWKV_SKIP_REVERSE],
    "no_sums": [("      if (t0 + s >= T || ec >= K) continue;",
                 "      if (T > 0) continue;")],
}
MAMBA_BOUNDS = "__launch_bounds__(kThreads, G < 32 ? 2 : 1)"
MAMBA = {
    "as_is": [],
    "3_blocks": [(MAMBA_BOUNDS, "__launch_bounds__(kThreads, 3)")],
    "128_threads": [("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 128;"),
                    (MAMBA_BOUNDS, "__launch_bounds__(kThreads, 4)")],
}


def build(source: str, name: str, edits) -> ctypes.CDLL:
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    with open(os.path.join(csrc, f"{source}.cu")) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{source}.cu no longer holds {old!r}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{source}_{name}.cu")
    with open(path, "w") as f:
        f.write(text.replace('#include "common.cuh"',
                             f'#include "{csrc}/common.cuh"'))
    lib = os.path.join(OUT, f"lib{source}_{name}.so")
    built = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                            path], check=True, capture_output=True, text=True)
    for e in chip_smoke.ptxas_entries(built.stdout + built.stderr):
        if e["kernel"] in ("rwkv_chunk_bwd_kernel[]",
                           "mamba_chunk_bwd_kernel[16]"):
            print(json.dumps({"variant": f"{source} {name}", "ptxas": e}),
                  flush=True)
    fn = getattr(ctypes.CDLL(lib), f"{source}_launch")
    fn.argtypes = _build.ARGTYPES[f"{source}_launch"]
    fn.restype = ctypes.c_int
    return fn


def rwkv_call(fn, g):
    BH, T, K, U = 128, 2048, 64, 64
    r, k, v = ((torch.randn((BH, T, K), generator=g, device="cuda") * 0.5)
               .to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(torch.log(
        torch.rand((BH, T, K), generator=g, device="cuda") * (1 - 1e-3)
        + 1e-3)))
    u = torch.randn((U, K), generator=g, device="cuda") * 0.1
    dy = torch.randn((BH, T, K), generator=g, device="cuda")
    outs = [torch.empty_like(r) for _ in range(3)] + [
        torch.empty(r.shape, dtype=torch.float32, device="cuda"),
        torch.empty(u.shape, dtype=torch.float32, device="cuda"),
        torch.empty((BH, K), dtype=torch.float32, device="cuda"),
        torch.empty((BH, -(-T // 32), 4096), dtype=torch.float32,
                    device="cuda")]

    def run():
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), dy.data_ptr(), None,
                 *(o.data_ptr() for o in outs), BH, T, K, U, 1, 0,
                 stream_of(r))
        if err:
            raise RuntimeError(f"rwkv_chunk_bwd variant: CUDA error {err}")
    return run


def mamba_call(fn, g, threads: int):
    B, T, d, n = 2, 2048, 8192, 16
    a, u, C = chip_smoke.mamba_inputs(torch, g, B, T, d, n, torch.float32)
    dy = torch.randn((B, T, d), generator=g, device="cuda")
    ck = mamba_chunk(a, u, C, checkpoints=True)[2]
    da, du, dC = torch.empty_like(a), torch.empty_like(u), torch.empty_like(C)
    part = torch.empty((B, blocks(d, n) * 256 // threads, T, n),
                       dtype=torch.float32, device="cuda")

    def run():
        err = fn(a.data_ptr(), u.data_ptr(), C.data_ptr(), dy.data_ptr(),
                 None, ck.data_ptr(), da.data_ptr(), du.data_ptr(),
                 dC.data_ptr(), part.data_ptr(), B, T, d, n, 0, stream_of(a))
        if err:
            raise RuntimeError(f"mamba_chunk_bwd variant: CUDA error {err}")
    copy_dst = torch.empty_like(a)
    return run, lambda: copy_dst.copy_(a)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    rwkv = {name: rwkv_call(build("rwkv_chunk_bwd", name, edits), g)
            for name, edits in RWKV.items()}
    mamba, copy = {}, None
    for name, edits in MAMBA.items():
        mamba[name], copy = mamba_call(
            build("mamba_chunk_bwd", name, edits), g,
            128 if name == "128_threads" else 256)
    for _ in range(3):
        row = {f"rwkv_chunk_bwd {k}": chip_smoke.time_ms(torch, f)
               for k, f in rwkv.items()}
        row.update({f"mamba_chunk_bwd {k}": chip_smoke.time_ms(torch, f)
                    for k, f in mamba.items()})
        row["copy 2.15 GB"] = chip_smoke.time_ms(torch, copy)
        print(json.dumps({"ms": row}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
