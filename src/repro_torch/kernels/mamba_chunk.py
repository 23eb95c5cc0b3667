"""mamba_chunk — the Mamba selective scan from a zero state (full-sequence
prefill).

Replaces the TPU kernel ``repro/kernels/mamba_chunk.py::mamba_chunk``. The
kernel is hand-written CUDA (``csrc/mamba_chunk.cu``, whose header says what
bounds it on an H100 and what its design does about that);
``ref.mamba_chunk_ref`` is its plain PyTorch version, the sequential
oracle. Unlike the TPU kernel it takes any T and any d (no tile has to
divide them); d_state may be at most 32. Under a gradient
(``ops.MambaChunkFn``) it also writes h before every ``CK`` steps, the
checkpoints that ``mamba_chunk_bwd`` walks back from;
``ref.mamba_checkpoints_ref`` is their plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (contiguous, dtype_code, on_cuda,
                                         stream_of)
from repro_torch.kernels.ref import mamba_chunk_ref  # noqa: F401  (plain version)

MAX_N = 32
CK = 16          # steps between checkpoints (csrc/mamba_chunk.cu: kCk)


def mamba_chunk(a: torch.Tensor, u: torch.Tensor, C: torch.Tensor, *,
                checkpoints: bool = False):
    """a, u: (B, T, d, n); C: (B, T, n); contiguous, one dtype (bf16 or
    f32). Returns (y (B, T, d) in a.dtype, h_T (B, d, n) f32), h_0 = 0,
    and with ``checkpoints`` also ck (B, ceil(T/CK), d, n) f32, h before
    steps 0, CK, 2 CK, ... Launches the CUDA kernel once."""
    on_cuda(a, u, C)
    code = dtype_code(a, u, C)
    contiguous(a=a, u=u, C=C)
    if a.dim() != 4 or u.shape != a.shape or C.dim() != 3:
        raise ValueError(f"bad shapes a {tuple(a.shape)} u {tuple(u.shape)} "
                         f"C {tuple(C.shape)}")
    B, T, d, n = a.shape
    if tuple(C.shape) != (B, T, n) or T < 1 or d < 1 \
            or not 1 <= B <= 65535 or not 1 <= n <= MAX_N:
        raise ValueError(f"bad shapes a {tuple(a.shape)} C {tuple(C.shape)} "
                         f"(1 <= d_state <= {MAX_N}, B <= 65535)")
    y = torch.empty((B, T, d), dtype=a.dtype, device=a.device)
    h = torch.empty((B, d, n), dtype=torch.float32, device=a.device)
    ck = torch.empty((B, -(-T // CK), d, n), dtype=torch.float32,
                     device=a.device) if checkpoints else None
    lib = _build.load("mamba_chunk")
    err = lib.mamba_chunk_launch(a.data_ptr(), u.data_ptr(), C.data_ptr(),
                                 y.data_ptr(), h.data_ptr(),
                                 None if ck is None else ck.data_ptr(), B, T,
                                 d, n, code, stream_of(a))
    _build.check(lib, err, "mamba_chunk")
    mamba_chunk.launches += 1
    return (y, h) if ck is None else (y, h, ck)


mamba_chunk.launches = 0
