"""mamba_chunk_bwd — the gradient of the Mamba selective scan from a zero
state.

Replaces no TPU kernel: the reference differentiates ``mamba_mix``'s scan
(``repro/models/ssm.py``, ``chunked_linear_scan``) with XLA. On the card
the forward it differentiates is the hand-written ``csrc/mamba_chunk.cu``,
so its gradient is the hand-written ``csrc/mamba_chunk_bwd.cu`` (whose
header gives the adjoint recurrence, what bounds it on an H100 and what
its design does about that): it walks once, in reverse, from the states
that the forward kernel wrote every ``CK`` steps under a gradient
(``mamba_chunk(..., checkpoints=True)``), recomputing each stretch in
registers, never recovering a state by dividing by a = exp(dt A), which
underflows to 0. ``ref.mamba_chunk_bwd_ref`` is its plain PyTorch
version. One call is one launch in ``mamba_chunk_bwd.launches`` (the
source runs two kernels a call, the second summing dC's per-block
partials over the channels in a fixed order: two calls give the same
bits).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (contiguous, dtype_code, on_cuda,
                                         stream_of)
from repro_torch.kernels.mamba_chunk import CK
from repro_torch.kernels.ref import mamba_chunk_bwd_ref  # noqa: F401  (plain version)

MAX_N = 32
THREADS = 256


def blocks(d: int, n: int) -> int:
    """The first kernel's blocks a batch row: one thread an element, a
    channel's n states in a group of n rounded up to a power of two."""
    g = 1 << (n - 1).bit_length()
    return -(-d * g // THREADS)


def mamba_chunk_bwd(a: torch.Tensor, u: torch.Tensor, C: torch.Tensor,
                    dy: torch.Tensor, dh: torch.Tensor = None, *,
                    ck: torch.Tensor = None):
    """a, u: (B, T, d, n); C: (B, T, n); dy: (B, T, d), the gradient of y;
    contiguous, one dtype (bf16 or f32); dh: the gradient of h_T (B, d, n)
    f32, or None; ck: the forward kernel's checkpoints of these a and u
    (B, ceil(T/CK), d, n) f32, required. Returns (da, du, dC) in that
    dtype. Launches the CUDA kernels."""
    if ck is None:
        raise ValueError("mamba_chunk_bwd needs the forward's checkpoints: "
                         "ck from mamba_chunk(a, u, C, checkpoints=True)")
    on_cuda(a, u, C, dy, ck, *(() if dh is None else (dh,)))
    code = dtype_code(a, u, C, dy)
    if ck.dtype != torch.float32 or (dh is not None
                                     and dh.dtype != torch.float32):
        raise TypeError(f"ck and dh must be float32, got {ck.dtype}"
                        + ("" if dh is None else f", {dh.dtype}"))
    contiguous(a=a, u=u, C=C, dy=dy, ck=ck,
               **({} if dh is None else {"dh": dh}))
    if a.dim() != 4 or u.shape != a.shape:
        raise ValueError(f"bad shapes a {tuple(a.shape)} u {tuple(u.shape)}")
    B, T, d, n = a.shape
    if tuple(C.shape) != (B, T, n) or tuple(dy.shape) != (B, T, d) \
            or (dh is not None and tuple(dh.shape) != (B, d, n)) \
            or T < 1 or d < 1 or not 1 <= B <= 65535 \
            or not 1 <= n <= MAX_N or d * n * CK >= 2**31:
        raise ValueError(f"bad shapes a {tuple(a.shape)} C {tuple(C.shape)} "
                         f"dy {tuple(dy.shape)} (1 <= d_state <= {MAX_N}, "
                         f"B <= 65535, d d_state {CK} < 2^31)")
    if tuple(ck.shape) != (B, -(-T // CK), d, n):
        raise ValueError(f"bad checkpoints {tuple(ck.shape)}: want "
                         f"{(B, -(-T // CK), d, n)}, h every {CK} steps")
    da, du, dC = torch.empty_like(a), torch.empty_like(u), torch.empty_like(C)
    part = torch.empty((B, blocks(d, n), T, n), dtype=torch.float32,
                       device=a.device)
    lib = _build.load("mamba_chunk_bwd")
    err = lib.mamba_chunk_bwd_launch(
        a.data_ptr(), u.data_ptr(), C.data_ptr(), dy.data_ptr(),
        None if dh is None else dh.data_ptr(), ck.data_ptr(), da.data_ptr(),
        du.data_ptr(), dC.data_ptr(), part.data_ptr(), B, T, d, n, code,
        stream_of(a))
    _build.check(lib, err, "mamba_chunk_bwd")
    mamba_chunk_bwd.launches += 1
    return da, du, dC


mamba_chunk_bwd.launches = 0
