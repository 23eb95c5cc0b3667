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
rows, 4096 x d 2048 in bf16: 15 us). Design (``bwd_plan``): a fixed grid
of programs (2 an SM, 4 in ``np_layernorm`` mode), each taking a contiguous run of rows ROWS at a
time as one [ROWS, d] tile (2 rows of d 2048 on 8 warps: of the plans
timed on the H100, the fastest; ``PERF.md``), so that several rows'
loads are in flight and their reductions run side by side; the rows'
statistics are recomputed from x (the forward saves none: recomputing
them costs one more reduction over rows already in registers, saving
them a tensor per norm and launch), dx is written from the same
registers, and the program's column sums of dy * xhat (dscale) and dy
(dbias) stay in f32 registers as [ROWS, d] across its rows, added over
the ROWS once at its end and written as a (programs, d) partial (2 MB
at llama's rows). A second small kernel sums the partials over the
programs, 256 at a time in a fixed order, and writes dscale and dbias in
the parameters' dtypes: two calls give the same bits.
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


# the finishing kernel's columns a program (32 f32: one 128-byte line of
# each partial row) and partial rows a load
SUM_COLS, SUM_PARTS = 32, 256


# the norm backward's tile: about BWD_TILE elements (rows of d padded to a
# power of two), BWD_PER_THREAD of them a thread
BWD_TILE, BWD_PER_THREAD = 4096, 16


def bwd_plan(rows: int, d: int, sms: int, partials: bool = True):
    """The norm backward's launch plan: (programs, rows a program, ROWS,
    num_warps). At most 2 programs an SM where the mode has column
    partials, whose size grows with the programs, and 4 where it has
    none, each a contiguous run of rows, a multiple of ROWS but for the
    last program's; ROWS, the rows a program loads at once, fills a tile
    of about ``BWD_TILE`` elements, capped by the rows a program has;
    ``BWD_PER_THREAD`` elements of the tile a thread, from 1 to 16
    warps."""
    per_sm = 2 if partials else 4
    block = 1 << max(0, (d - 1).bit_length())
    per = -(-rows // min(rows, per_sm * sms))
    rows_at_once = min(max(1, BWD_TILE // block), 1 << (per - 1).bit_length())
    per = -(-per // rows_at_once) * rows_at_once
    programs = -(-rows // per)
    n_warps = max(1, min(16, rows_at_once * block // (32 * BWD_PER_THREAD)))
    return programs, per, rows_at_once, n_warps


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
                        BLOCK: tl.constexpr, ROWS: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        if MODE == 2:
            w = tl.full([BLOCK], 1.0, tl.float32)
        else:
            w = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        # the column sums stay [ROWS, BLOCK] until the program's end: no
        # reduction across the rows of a tile in the loop
        acc_s = tl.zeros([ROWS, BLOCK], dtype=tl.float32)
        acc_b = tl.zeros([ROWS, BLOCK], dtype=tl.float32)
        first = pid * rows_per
        end = tl.minimum(first + rows_per, rows)
        for i in range(0, rows_per, ROWS):
            row = first + i + tl.arange(0, ROWS)
            live = (row < end)[:, None] & mask[None, :]
            off = row.to(tl.int64)[:, None] * d + cols[None, :]
            x = tl.load(x_ptr + off, mask=live, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=live, other=0.0).to(tl.float32)
            g = dy * w[None, :]
            if MODE == 0:
                r = tl.rsqrt(tl.sum(x * x, axis=1) / d + eps)
                xhat = x * r[:, None]
                dx = r[:, None] * (
                    g - xhat * (tl.sum(g * xhat, axis=1) / d)[:, None])
            else:
                mean = tl.sum(x, axis=1) / d
                xc = tl.where(live, x - mean[:, None], 0.0)
                r = tl.rsqrt(tl.sum(xc * xc, axis=1) / d + eps)
                xhat = xc * r[:, None]
                dx = r[:, None] * (g - (tl.sum(g, axis=1) / d)[:, None]
                                   - xhat * (tl.sum(g * xhat, axis=1)
                                             / d)[:, None])
            if MODE != 2:
                acc_s += dy * xhat
            if MODE == 1:
                acc_b += dy
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=live)
        if MODE != 2:
            tl.store(ds_ptr + pid * d + cols, tl.sum(acc_s, axis=0),
                     mask=mask)
        if MODE == 1:
            tl.store(db_ptr + pid * d + cols, tl.sum(acc_b, axis=0),
                     mask=mask)

    @triton.jit
    def col_sum_kernel(ps_ptr, pb_ptr, os_ptr, ob_ptr, programs, d,
                       BIAS: tl.constexpr, COLS: tl.constexpr,
                       PARTS: tl.constexpr):
        cols = tl.program_id(0) * COLS + tl.arange(0, COLS)
        mask = cols < d
        acc_s = tl.zeros([COLS], dtype=tl.float32)
        acc_b = tl.zeros([COLS], dtype=tl.float32)
        for i in range(0, programs, PARTS):
            part = i + tl.arange(0, PARTS)
            live = (part < programs)[:, None] & mask[None, :]
            off = part[:, None] * d + cols[None, :]
            acc_s += tl.sum(tl.load(ps_ptr + off, mask=live, other=0.0),
                            axis=0)
            if BIAS:
                acc_b += tl.sum(tl.load(pb_ptr + off, mask=live, other=0.0),
                                axis=0)
        tl.store(os_ptr + cols, acc_s.to(os_ptr.dtype.element_ty), mask=mask)
        if BIAS:
            tl.store(ob_ptr + cols, acc_b.to(ob_ptr.dtype.element_ty),
                     mask=mask)

    return triton, norm_bwd_kernel, col_sum_kernel


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
    has none). Launches the Triton kernel and, where the mode has an
    affine, the finishing kernel that sums its column partials: one
    launch in ``layernorm_bwd.launches``."""
    need = _check(x, scale, bias, mode)
    on_cuda(dy)
    contiguous(dy=dy)
    rows, d = x.shape
    if dy.shape != x.shape or dy.dtype not in FLOAT_DTYPES:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} for x "
                         f"{tuple(x.shape)}")
    triton, kern, col_sum = _bwd_kernel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    programs, per, rows_at_once, n_warps = bwd_plan(rows, d, sms,
                                                    partials=bool(need))
    # every output first: the host's work between the two launches stays
    # inside the first kernel's time
    dx = torch.empty_like(x)
    part = {n: torch.empty((programs, d), dtype=torch.float32,
                           device=x.device) for n in need}
    dscale = torch.empty_like(scale) if "scale" in part else None
    dbias = torch.empty_like(bias) if "bias" in part else None
    eps = NORM_EPS[mode] if eps is None else eps
    kern[(programs,)](x, scale if scale is not None else x, dy, dx,
                      part.get("scale", dx), part.get("bias", dx), rows, d,
                      per, eps, MODE=MODES[mode],
                      BLOCK=triton.next_power_of_2(d), ROWS=rows_at_once,
                      num_warps=n_warps)
    if dscale is not None:
        col_sum[(triton.cdiv(d, SUM_COLS),)](
            part["scale"], part.get("bias", part["scale"]), dscale,
            dscale if dbias is None else dbias, programs, d,
            BIAS=dbias is not None, COLS=SUM_COLS, PARTS=SUM_PARTS,
            num_warps=8)
    layernorm_bwd.launches += 1
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
