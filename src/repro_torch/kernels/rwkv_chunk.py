"""rwkv_chunk — the RWKV6 wkv from a zero state (full-sequence prefill).

Replaces the TPU kernel ``repro/kernels/rwkv_chunk.py::rwkv_chunk``. The
kernel is hand-written CUDA (``csrc/rwkv_chunk.cu``, whose header says what
bounds it on an H100 and what its design does about that), in two routes
that the input dtype picks, with no hand-off between them:

  * bf16 r, k, v (the model's call): the tensor-core route. Sub-chunked
    decays (``SUB`` steps, and ``TILE`` inside the diagonal blocks) turn
    most of the chunk's pairwise decay ratios into products of decayed r
    and k, which run on ``mma.sync`` with each operand that is no bf16
    input split into two bf16 halves; ``tests/test_torch_rwkv_tiles.py``
    emulates its arithmetic on the CPU.
  * f32 r, k, v (the float32 parity paths): the CUDA cores, every product
    in f32 and the accurate expf, which the logits' 1e-4 against the CPU
    needs and tensor-core products would not meet.

``ref.rwkv_chunk_ref`` is its plain PyTorch version, the sequential
oracle. Unlike the TPU kernel it takes any T (the ragged last chunk is
masked in the kernel), broadcasts ``u`` over the batch, and writes y in a
dtype the caller names.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (DTYPE_CODES, contiguous, dtype_code,
                                         on_cuda, stream_of)
from repro_torch.kernels.ref import rwkv_chunk_ref  # noqa: F401  (plain version)

MAX_K = 64
CHUNK = 64     # the steps a block takes at once (csrc/rwkv_chunk.cu: kC)
SUB = 16       # the bf16 route's sub-chunk (kSub)
TILE = 4       # its register tiles inside the diagonal sub-chunk blocks


def rwkv_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, out_dtype=None):
    """r, k, v: (BH, T, K) contiguous, one dtype (bf16 or f32); w:
    (BH, T, K) f32 decays; u: (U, K) f32 with BH % U == 0, row bh taking
    u[bh % U]. Returns (y (BH, T, K) in ``out_dtype``, r.dtype by default;
    S_T (BH, K, K) f32, k-major). Launches the CUDA kernel once: the
    tensor-core route for bf16 inputs, the CUDA-core one for f32."""
    on_cuda(r, k, v, w, u)
    in_code = dtype_code(r, k, v)
    out_dtype = r.dtype if out_dtype is None else out_dtype
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"y dtype must be one of {list(DTYPE_CODES)}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"w and u must be float32, got {w.dtype}, {u.dtype}")
    contiguous(r=r, k=k, v=v, w=w, u=u)
    BH, T, K = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.dim() != 2 or u.shape[1] != K or BH % u.shape[0] \
            or T < 1 or not 1 <= K <= MAX_K:
        raise ValueError(f"bad shapes r {tuple(r.shape)} w {tuple(w.shape)} "
                         f"u {tuple(u.shape)} (K <= {MAX_K})")
    y = torch.empty((BH, T, K), dtype=out_dtype, device=r.device)
    s = torch.empty((BH, K, K), dtype=torch.float32, device=r.device)
    lib = _build.load("rwkv_chunk")
    err = lib.rwkv_chunk_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), s.data_ptr(), BH, T, K, u.shape[0], in_code,
        DTYPE_CODES[out_dtype], stream_of(r))
    _build.check(lib, err, "rwkv_chunk")
    rwkv_chunk.launches += 1
    return y, s


rwkv_chunk.launches = 0
