"""rwkv_chunk_bwd — the gradient of the RWKV6 wkv from a zero state.

Replaces no TPU kernel: the reference differentiates its wkv
(``repro/models/ssm.py::_wkv_scan``) with XLA. On the card the forward it
differentiates is the hand-written ``csrc/rwkv_chunk.cu``, so its
gradient is the hand-written ``csrc/rwkv_chunk_bwd.cu`` (whose header
gives the adjoint recurrences, what bounds them on an H100 and what its
design does about that): a block of ``THREADS`` threads a row, 16 state
elements a thread; the states are checkpointed in device memory every
``CK`` steps, recomputed from there into shared-memory slots every
``SUB`` steps and into registers step by step, never recovered by
dividing by a decay; each step writes its parts of the sums to
shared-memory partials that a sub-chunk adds in a fixed order.
``ref.rwkv_chunk_bwd_ref`` is its plain PyTorch version. One call is one
launch in ``rwkv_chunk_bwd.launches`` (the source runs two kernels a
call, the second summing du over the rows that share u, in a fixed
order: two calls give the same bits).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (DTYPE_CODES, contiguous, dtype_code,
                                         on_cuda, stream_of)
from repro_torch.kernels.ref import rwkv_chunk_bwd_ref  # noqa: F401  (plain version)

MAX_K = 64       # the kernel's state width: K < 64 runs zero channels
SUB = 8          # steps a task stages, S_{t-1} in registers (kSub)
CK = 32          # steps between checkpoints in device memory (kSub * kQ)
THREADS = 256    # a block a row, 16 state elements a thread (kThreads)


def rwkv_chunk_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                   ds: torch.Tensor = None):
    """r, k, v: (BH, T, K) contiguous, one dtype (bf16 or f32); w: (BH, T,
    K) f32 decays; u: (U, K) f32 with BH % U == 0, row bh taking
    u[bh % U]; dy: (BH, T, K) in f32 or bf16, the gradient of y; ds: the
    gradient of S_T (BH, K, K) f32, or None. Returns (dr, dk, dv in r's
    dtype; dw (BH, T, K) f32; du (U, K) f32). Launches the CUDA kernels."""
    on_cuda(r, k, v, w, u, dy, *(() if ds is None else (ds,)))
    in_code = dtype_code(r, k, v)
    if dy.dtype not in DTYPE_CODES:
        raise TypeError(f"dy must be one of {list(DTYPE_CODES)}")
    if w.dtype != torch.float32 or u.dtype != torch.float32 or (
            ds is not None and ds.dtype != torch.float32):
        raise TypeError("w, u and ds must be float32")
    contiguous(r=r, k=k, v=v, w=w, u=u, dy=dy,
               **({} if ds is None else {"ds": ds}))
    BH, T, K = r.shape
    if any(t.shape != r.shape for t in (k, v, w, dy)) or u.dim() != 2 \
            or u.shape[1] != K or BH % u.shape[0] or T < 1 \
            or not 1 <= K <= MAX_K \
            or (ds is not None and ds.shape != (BH, K, K)):
        raise ValueError(f"bad shapes r {tuple(r.shape)} u {tuple(u.shape)} "
                         f"dy {tuple(dy.shape)} (K <= {MAX_K})")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du = torch.empty(u.shape, dtype=torch.float32, device=r.device)
    du_rows = torch.empty((BH, K), dtype=torch.float32, device=r.device)
    ck = torch.empty((BH, -(-T // CK), MAX_K * MAX_K),
                     dtype=torch.float32, device=r.device)
    lib = _build.load("rwkv_chunk_bwd")
    err = lib.rwkv_chunk_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        dy.data_ptr(), None if ds is None else ds.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        du_rows.data_ptr(), ck.data_ptr(), BH, T, K, u.shape[0], in_code,
        DTYPE_CODES[dy.dtype], stream_of(r))
    _build.check(lib, err, "rwkv_chunk_bwd")
    rwkv_chunk_bwd.launches += 1
    return dr, dk, dv, dw, du


rwkv_chunk_bwd.launches = 0
