"""pim_matvec — the PIM twin: weight-streaming fused GEMV act(x @ W + b).

Replaces the TPU kernel ``repro/kernels/pim_matvec.py::pim_matvec``. The
kernel is hand-written CUDA (``csrc/pim_matvec.cu``, whose header says what
bounds it on an H100 and what its design does about that);
``ref.matvec_ref`` is its plain PyTorch version. It carries the decode
step's FC products; unlike the TPU kernel it takes any d_in and d_out.
``plan`` picks the kernel's tile and its split of d_in, in Python, so that
the CPU tests read what the card runs.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (contiguous, dtype_code, on_cuda,
                                         stream_of)
from repro_torch.kernels.ref import matvec_ref  # noqa: F401  (plain version)

ACTIVATIONS = {"none": 0, "gelu": 1, "silu": 2}
ROWS_PER_LAUNCH = 8    # x rows one launch takes: mma.sync's N
TARGET_CTAS = 256      # about two CTAs on each of an H100's 132 SMs
TILE_BYTES = 8192      # one W tile in shared memory (csrc/pim_matvec.cu)
MAX_SPLITS = 8         # CTAs of a cluster (the portable limit)
X_SLICE_BYTES = 32768  # a CTA's slice of x, held in shared memory


class Plan(NamedTuple):
    """How one launch cuts the product: ``bn`` output columns per CTA,
    ``splits`` CTAs per column tile (one cluster), each over ``slice`` rows
    of d_in (whole tiles of ``tile_rows`` rows; the last slice may be
    short); ``ctas`` in all."""
    bn: int
    splits: int
    slice: int
    tile_rows: int
    ctas: int


@functools.lru_cache(maxsize=None)
def plan(n: int, d_in: int, d_out: int, dtype: torch.dtype) -> Plan:
    """The widest column tile (128 down to 16 columns; 64 at most in f32,
    whose CUDA-core product gives each thread a column) and the fewest
    splits of d_in (1, 2, 4 or 8) that launch at least ``TARGET_CTAS``
    CTAs with a slice of x that fits ``X_SLICE_BYTES``; where none does,
    the plan with the most CTAs, one that fits first. Slices are whole
    tiles (a TMA box never reaches into the next slice's rows; a tile is a
    multiple of the 16-row k-step) and none is empty. ``n`` (rows, at most
    8 a launch) does not change the cut: the kernel always computes 8
    rows. Cached: a decode step asks for the same few shapes on every
    call."""
    if n < 1 or d_in < 1 or d_out < 1:
        raise ValueError(f"bad GEMV shape n {n} d_in {d_in} d_out {d_out}")
    es = torch.finfo(dtype).bits // 8
    best, best_key = None, None
    for bn in (128, 64, 32, 16) if es == 2 else (64, 32, 16):
        cols, tile = -(-d_out // bn), TILE_BYTES // (bn * es)
        for splits in (1, 2, 4, MAX_SPLITS):
            slice_ = -(-math.ceil(d_in / splits) // tile) * tile
            used = -(-d_in // slice_)
            p = Plan(bn, used, slice_, tile, cols * used)
            fits = ROWS_PER_LAUNCH * slice_ * es <= X_SLICE_BYTES
            if fits and p.ctas >= TARGET_CTAS:
                return p
            if best is None or (fits, p.ctas) > best_key:
                best, best_key = p, (fits, p.ctas)
    return best


def pim_matvec(x: torch.Tensor, w: torch.Tensor, bias=None,
               activation: str = "none") -> torch.Tensor:
    """x: (n, d_in); w: (d_in, d_out); bias: (d_out,) or None ->
    (n, d_out) in x.dtype. Launches the CUDA kernel once per 8 rows of x
    (decode batches are at most a few slots); each launch counts once."""
    ts = (x, w) if bias is None else (x, w, bias)
    on_cuda(*ts)
    code = dtype_code(*ts)
    contiguous(x=x, w=w, **({} if bias is None else {"bias": bias}))
    n, d_in = x.shape
    d_out = w.shape[1]
    if w.shape != (d_in, d_out) or (bias is not None
                                    and bias.shape != (d_out,)) or n < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    out = torch.empty((n, d_out), dtype=x.dtype, device=x.device)
    p = plan(min(n, ROWS_PER_LAUNCH), d_in, d_out, x.dtype)
    # the TMA route (bf16): every row of W and x starts 16-byte aligned
    vec = 16 // x.element_size()
    vec_ok = d_out % vec == 0 and d_in % vec == 0 \
        and w.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    lib = _build.load("pim_matvec")
    stream = stream_of(x)
    for r0 in range(0, n, ROWS_PER_LAUNCH):
        rows = min(ROWS_PER_LAUNCH, n - r0)
        err = lib.pim_matvec_launch(
            x[r0].data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out[r0].data_ptr(),
            rows, d_in, d_out, ACTIVATIONS[activation], code, int(vec_ok),
            p.bn, p.splits, p.slice, stream)
        _build.check(lib, err, "pim_matvec")
        pim_matvec.launches += 1
    return out


pim_matvec.launches = 0
