"""decode_attention — flash-decode: one query token per slot vs the cache.

Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention``. The kernel is
hand-written CUDA (``csrc/decode_attention.cu``, whose header says what
bounds it on an H100 and what its design does about that);
``ref.decode_attention_ref`` is its plain PyTorch version. It computes what
``repro.models.attention.decode_attention`` computes in layout A.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (contiguous, dtype_code, on_cuda,
                                         stream_of)
from repro_torch.kernels.ref import decode_attention_ref  # noqa: F401  (plain version)

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP_DIM = 1024   # (H // KH) * D held in shared memory per block


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, KH, S, D); lengths: (B,) int32, each at least
    1 (positions >= lengths[b] are masked) -> (B, H, D) in q.dtype.
    Launches the CUDA kernel."""
    on_cuda(q, k, v, lengths)
    code = dtype_code(q, k, v)
    contiguous(q=q, k=k, v=v, lengths=lengths)
    B, H, D = q.shape
    KH, S = k.shape[1], k.shape[2]
    if k.shape != (B, KH, S, D) or v.shape != k.shape or H % KH \
            or lengths.shape != (B,):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} lengths {tuple(lengths.shape)}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if D not in HEAD_DIMS or (H // KH) * D > MAX_GROUP_DIM:
        raise ValueError(f"head_dim {D} with {H // KH} grouped heads is not "
                         f"supported (D in {HEAD_DIMS}, G*D <= "
                         f"{MAX_GROUP_DIM})")
    o = torch.empty_like(q)
    lib = _build.load("decode_attention")
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), B, H, KH, S, D, 1.0 / math.sqrt(D), code, stream_of(q))
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
