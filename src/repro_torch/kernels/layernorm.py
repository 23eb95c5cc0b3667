"""layernorm — the paper's two-phase vector-unit norm, in Triton.

Replaces the TPU kernel ``repro/kernels/layernorm.py::layernorm`` and
extends it to the norms the model uses: ``rmsnorm`` (eps 1e-6, scale; the
llama and jamba norm), ``layernorm`` (eps 1e-5, scale and bias; the TPU
kernel and rwkv6-7b's) and ``np_layernorm`` (eps 1e-5, no affine).
``ref.norm_ref`` is the plain PyTorch version.

Why Triton and not CUDA C++: the kernel is one reduction over a row plus an
elementwise pass, with no tensor-core work and nothing staged beyond the
row in registers -- the case where Triton's generated code does as well as
a hand-written CUDA kernel.

Bound on an H100: bytes, each row read once and written once (8 MB at
llama's prefill chunk, rows 1024 x d 2048 in bf16: 2.5 us at 3.35 TB/s;
64 MB at the 7B prefill steps' rows 4096 x d 4096: 20 us). Design: one
program per row; the whole row (d padded to a power of two) is loaded
once, phase 1 reduces its statistics in f32, phase 2 normalizes and
applies the affine from the same registers, so each element is read and
written once. The warp count follows d (``warps``: 16 elements a thread,
two 16-byte vectors of bf16): at d 2048 that is the 4 warps Triton gives
by default, at d 4096 8, where 4 warps left a decode row's 4096 elements
on too few threads. At the prefill shapes the kernel moves its rows at
about the speed of a device copy of the same bytes; at decode (8 rows)
launch and DRAM latency bound it (``PERF.md``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels._checks import contiguous, on_cuda
from repro_torch.kernels.ref import NORM_EPS, norm_ref  # noqa: F401  (plain version)

MODES = {"rmsnorm": 0, "layernorm": 1, "np_layernorm": 2}
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def warps(d: int) -> int:
    """Warps for a row of d elements padded to a power of two: 16
    elements a thread, from 1 to 16 warps."""
    block = 1 << max(0, (d - 1).bit_length())
    return max(1, min(16, block // 512))


@functools.lru_cache(maxsize=None)
def _kernel():
    # triton is imported here, at the first launch: modules of the port
    # must import on machines without it
    import triton
    import triton.language as tl

    @triton.jit
    def norm_kernel(x_ptr, s_ptr, b_ptr, o_ptr, d, eps,
                    MODE: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0
                    ).to(tl.float32)
        if MODE == 0:
            y = x * tl.rsqrt(tl.sum(x * x, axis=0) / d + eps)
            y = y * tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        else:
            mean = tl.sum(x, axis=0) / d
            xc = tl.where(mask, x - mean, 0.0)
            y = xc * tl.rsqrt(tl.sum(xc * xc, axis=0) / d + eps)
            if MODE == 1:
                y = (y * tl.load(s_ptr + cols, mask=mask, other=0.0
                                 ).to(tl.float32)
                     + tl.load(b_ptr + cols, mask=mask, other=0.0
                               ).to(tl.float32))
        tl.store(o_ptr + row * d + cols, y.to(o_ptr.dtype.element_ty),
                 mask=mask)

    return triton, norm_kernel


def layernorm(x: torch.Tensor, scale=None, bias=None, *,
              mode: str = "layernorm", eps=None) -> torch.Tensor:
    """x: (rows, d); scale/bias: (d,) as the mode needs -> (rows, d) in
    x.dtype, f32 math. Launches the Triton kernel."""
    if mode not in MODES:
        raise ValueError(f"unknown norm mode {mode!r}")
    need = {"rmsnorm": ("scale",), "layernorm": ("scale", "bias"),
            "np_layernorm": ()}[mode]
    named = {"x": x, "scale": scale, "bias": bias}
    if any(named[n] is None for n in need):
        raise ValueError(f"{mode} needs {need}")
    ts = [x] + [named[n] for n in need]
    on_cuda(*ts)
    contiguous(**{n: named[n] for n in ("x",) + need})
    rows, d = x.shape
    for t in ts:
        if t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"norm takes floating tensors, got {t.dtype}")
    for n in need:
        if named[n].shape != (d,):
            raise ValueError(f"{n} shape {tuple(named[n].shape)} != ({d},)")
    triton, kern = _kernel()
    out = torch.empty_like(x)
    eps = NORM_EPS[mode] if eps is None else eps
    s = scale if scale is not None else x
    b = bias if bias is not None else x
    kern[(rows,)](x, s, b, out, d, eps, MODE=MODES[mode],
                  BLOCK=triton.next_power_of_2(d), num_warps=warps(d))
    layernorm.launches += 1
    return out


layernorm.launches = 0
