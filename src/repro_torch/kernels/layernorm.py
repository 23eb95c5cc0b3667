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

``layernorm_bwd`` is the gradient on the training path, in all three
modes (``ref.norm_bwd_ref`` is its plain version). It replaces no TPU
kernel: the reference differentiates its norm through XLA. Triton again,
for the same reason: a row reduction and an elementwise pass. Bound:
bytes, x and dy read once and dx written once (50 MB at llama's training
rows, 4096 x d 2048 in bf16: 15 us). Design: a fixed grid of programs (4
an SM), each taking a contiguous run of rows one at a time; the row's
statistics are recomputed from x (the forward saves none: recomputing
them costs one more reduction over a row already in registers, saving
them a tensor per norm and launch), dx is written from the same
registers, and the program's column sums of dy * xhat (dscale) and dy
(dbias) stay in f32 registers across its rows and are written once as a
(programs, d) partial; ``torch.sum`` over the programs finishes the
column sums, in f32, before the cast to the parameter's dtype.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels._checks import contiguous, on_cuda
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    NORM_EPS, norm_bwd_ref, norm_ref)

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


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def norm_bwd_kernel(x_ptr, s_ptr, dy_ptr, dx_ptr, ds_ptr, db_ptr, rows,
                        d, rows_per, eps, MODE: tl.constexpr,
                        BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        if MODE == 2:
            w = tl.full([BLOCK], 1.0, tl.float32)
        else:
            w = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        acc_s = tl.zeros([BLOCK], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK], dtype=tl.float32)
        for i in range(0, rows_per):
            row = pid * rows_per + i
            live = mask & (row < rows)
            off = row.to(tl.int64) * d + cols
            x = tl.load(x_ptr + off, mask=live, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=live, other=0.0).to(tl.float32)
            if MODE == 0:
                r = tl.rsqrt(tl.sum(x * x, axis=0) / d + eps)
                xhat = x * r
                g = dy * w
                dx = r * (g - xhat * (tl.sum(g * xhat, axis=0) / d))
            else:
                mean = tl.sum(x, axis=0) / d
                xc = tl.where(live, x - mean, 0.0)
                r = tl.rsqrt(tl.sum(xc * xc, axis=0) / d + eps)
                xhat = xc * r
                g = dy * w
                dx = r * (g - tl.sum(g, axis=0) / d
                          - xhat * (tl.sum(g * xhat, axis=0) / d))
            acc_s += dy * xhat
            acc_b += dy
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=live)
        if MODE != 2:
            tl.store(ds_ptr + pid * d + cols, acc_s, mask=mask)
        if MODE == 1:
            tl.store(db_ptr + pid * d + cols, acc_b, mask=mask)

    return triton, norm_bwd_kernel


def _check(x, scale, bias, mode: str):
    """The operands the mode needs, on the card, contiguous and floating;
    returns their names."""
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
    d = x.shape[1]
    for t in ts:
        if t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"norm takes floating tensors, got {t.dtype}")
    for n in need:
        if named[n].shape != (d,):
            raise ValueError(f"{n} shape {tuple(named[n].shape)} != ({d},)")
    return need


def layernorm_bwd(x: torch.Tensor, scale, bias, dy: torch.Tensor, *,
                  mode: str = "layernorm", eps=None):
    """The gradient of ``layernorm``: x, dy (rows, d) -> (dx in x.dtype,
    dscale and dbias in the dtypes of scale and bias, None where the mode
    has none). Launches the Triton kernel (one launch in
    ``layernorm_bwd.launches``; the column sums over its programs finish
    in ``torch.sum``)."""
    need = _check(x, scale, bias, mode)
    on_cuda(dy)
    contiguous(dy=dy)
    rows, d = x.shape
    if dy.shape != x.shape or dy.dtype not in FLOAT_DTYPES:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} for x "
                         f"{tuple(x.shape)}")
    triton, kern = _bwd_kernel()
    # at most 4 programs an SM, each a contiguous run of rows
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per = -(-rows // min(rows, 4 * sms))
    programs = -(-rows // per)
    dx = torch.empty_like(x)
    part = {n: torch.empty((programs, d), dtype=torch.float32,
                           device=x.device) for n in need}
    eps = NORM_EPS[mode] if eps is None else eps
    kern[(programs,)](x, scale if scale is not None else x, dy, dx,
                      part.get("scale", dx), part.get("bias", dx), rows, d,
                      per, eps, MODE=MODES[mode],
                      BLOCK=triton.next_power_of_2(d), num_warps=warps(d))
    layernorm_bwd.launches += 1
    dscale = part["scale"].sum(0).to(scale.dtype) if "scale" in part \
        else None
    dbias = part["bias"].sum(0).to(bias.dtype) if "bias" in part else None
    return dx, dscale, dbias


def layernorm(x: torch.Tensor, scale=None, bias=None, *,
              mode: str = "layernorm", eps=None) -> torch.Tensor:
    """x: (rows, d); scale/bias: (d,) as the mode needs -> (rows, d) in
    x.dtype, f32 math. Launches the Triton kernel."""
    _check(x, scale, bias, mode)
    rows, d = x.shape
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
layernorm_bwd.launches = 0
