"""flash_attention — blocked causal GQA attention for the prefill stage.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
in its static ``q_offset`` mode. The kernel is hand-written CUDA
(``csrc/flash_attention.cu``, whose header says what bounds it on an H100
and what its design does about that); ``ref.flash_attention_ref`` is its
plain PyTorch version. Unlike the TPU kernel it masks ragged edges itself,
so every chunk shape goes to it, including a last prefill chunk that
overhangs the cache.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import dtype_code, on_cuda, stream_of
from repro_torch.kernels.ref import flash_attention_ref  # noqa: F401  (plain version)

HEAD_DIMS = (16, 32, 64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, S, D) contiguous; k, v: (B, KH, Skv, D) with contiguous
    (Skv, D) rows per head (a prefix slice of a cache is fine) ->
    (B, H, S, D) in q.dtype. Launches the CUDA kernel."""
    on_cuda(q, k, v)
    code = dtype_code(q, k, v)
    B, H, S, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if k.shape != (B, KH, Skv, D) or v.shape != k.shape or H % KH:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError("kernel needs a contiguous q")
    head_stride = k.stride(1)
    for name, t in (("k", k), ("v", v)):
        if (t.stride(3) != 1 or t.stride(2) != D or t.stride(1) != head_stride
                or t.stride(0) != KH * head_stride):
            raise ValueError(f"kernel needs {name} as (B, KH, Skv, D) rows "
                             f"of a (B, KH, L, D) layout, got strides "
                             f"{t.stride()}")
    if causal and q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    o = torch.empty_like(q)
    lib = _build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KH, S,
        Skv, D, head_stride, q_offset, int(causal), 1.0 / math.sqrt(D), code,
        stream_of(q))
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
