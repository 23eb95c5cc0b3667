"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(*ts: torch.Tensor) -> int:
    """The kernels' dtype code; every tensor must share one supported
    floating dtype."""
    dt = ts[0].dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in ts):
        raise TypeError(f"kernel takes one of {list(DTYPE_CODES)} for all "
                        f"operands, got {[t.dtype for t in ts]}")
    return DTYPE_CODES[dt]


def on_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"kernel needs CUDA tensors, got one on "
                             f"{t.device}")


def contiguous(**named: torch.Tensor) -> None:
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"kernel needs a contiguous {name}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
