"""flash_attention_bwd — the gradient of the flash kernel's static mode.

Replaces no TPU kernel: the reference's flash backward
(``repro/models/attention.py::_flash_bwd``, the custom VJP of
``flash_attention_fused``) is XLA. On the card the forward it
differentiates is the hand-written ``csrc/flash_attention.cu``, so its
gradient is the hand-written ``csrc/flash_attention_bwd.cu`` (whose header
says what bounds it and what its design does about that: bf16 at every
head dim on the tensor cores, through ``wgmma`` fed by TMA, D 96, 112 and
160 at the next multiple of 64; float32 on the CUDA cores). It recomputes P from (q, k, v, the
forward's o and its per-row log-sum-exp) and dO, as
``ref.flash_attention_bwd_ref`` does on the CPU. One call is one launch in
``flash_attention_bwd.launches`` (the source runs two kernels a call on
the tensor cores up to D 64, three above and on the CUDA cores, with no
atomics: two calls give the same bits).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (contiguous, dtype_code, on_cuda,
                                         stream_of)
from repro_torch.kernels.ref import flash_attention_bwd_ref  # noqa: F401  (plain version)

BWD_HEAD_DIMS = (16, 32, 64, 96, 112, 128, 160)
# the bf16 route's tiles (csrc/flash_attention_bwd.cu): 64 rows (wgmma's
# M) of keys or query rows, one a consumer warpgroup; a CTA of the dK/dV
# pass has two, one of the dQ pass three (two above D 64)
TILE = 64
KV_CTA_TILES = 2


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True):
    """q, o, do: (B, H, S, D); k, v: (B, KH, Skv, D), contiguous and of one
    dtype (float32 or bfloat16); lse: (B, H, S) float32 from the forward
    (``flash_attention(..., return_lse=True)``). Queries at positions
    [0, S). Returns (dq, dk, dv) in that dtype. Launches the CUDA
    kernels."""
    on_cuda(q, k, v, o, lse, do)
    code = dtype_code(q, k, v, o, do)
    contiguous(q=q, k=k, v=v, o=o, lse=lse, do=do)
    B, H, S, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if (k.shape != (B, KH, Skv, D) or v.shape != k.shape or H % KH
            or o.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} o {tuple(o.shape)} do "
                         f"{tuple(do.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (B, H, S):
        raise ValueError(f"lse must be float32 ({B}, {H}, {S}), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"the flash backward takes head_dim in "
                         f"{BWD_HEAD_DIMS}, got {D}")
    if any(t.data_ptr() % 16 for t in (o, do)) or (
            q.dtype == torch.bfloat16
            and any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("the kernels read 16 bytes at a time and the bf16 "
                         "route its tiles by TMA: o and do (and q, k, v in "
                         "bf16) must start 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd")
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, H, KH, S, Skv, D, int(causal),
        1.0 / math.sqrt(D), code, stream_of(q))
    _build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
