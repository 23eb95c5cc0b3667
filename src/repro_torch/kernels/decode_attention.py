"""decode_attention — flash-decode: one query token per slot vs the cache.

Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention``. The kernel is
hand-written CUDA (``csrc/decode_attention.cu``, whose header says what
bounds it on an H100 and what its design does about that);
``ref.decode_attention_ref`` is its plain PyTorch version. It computes what
``repro.models.attention.decode_attention`` computes in layout A. ``plan``
(how many CTAs split each row's keys) and ``share`` (which keys each one
takes) are the kernel's arithmetic in Python, so that the CPU tests read
what the card runs.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (contiguous, dtype_code, on_cuda,
                                         stream_of)
from repro_torch.kernels.ref import decode_attention_ref  # noqa: F401  (plain version)

HEAD_DIMS = (16, 32, 64, 96, 112, 128, 160)
TILE = 64              # keys per tile of the kernel's ring
HEAD_GROUP = 16        # query heads per CTA (mma.sync's M)
SMS = 132              # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 8         # CTAs of a cluster (the portable limit)


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, KH: int, S: int) -> int:
    """CTAs per (head group, KV head, batch row), one cluster: the fewest
    that fill the card's 132 SMs once, at most 8 and no more than the
    cache has tiles. Cached: a decode step asks for one shape per layer."""
    base = B * KH * -(-(H // KH) // HEAD_GROUP)
    return max(1, min(-(-SMS // base), MAX_SPLITS, -(-S // TILE)))


def share(length: int, split: int, splits: int) -> Tuple[int, int]:
    """The keys [lo, hi) that CTA ``split`` of ``splits`` takes of a row
    of ``length`` valid keys: ceil(length / splits) rounded up to the tile;
    the shares cover [0, length) once, the last ones may be empty."""
    per = -(-length // splits)
    per = -(-per // TILE) * TILE
    lo = min(length, split * per)
    return lo, min(length, lo + per)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, KH, S, D); lengths: (B,) int32, each at least
    1 (positions >= lengths[b] are masked) -> (B, H, D) in q.dtype.
    Launches the CUDA kernel once (one count), which merges its splits
    itself."""
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
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not supported (D in {HEAD_DIMS})")
    # K/V tiles arrive by 16-byte copies, q by 4-byte loads
    if k.data_ptr() % 16 or v.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("decode_attention needs k and v 16-byte aligned "
                         "and q 4-byte aligned")
    o = torch.empty_like(q)
    lib = _build.load("decode_attention")
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), B, H, KH, S, D, 1.0 / math.sqrt(D), code,
        plan(B, H, KH, S), stream_of(q))
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
