"""ops — the dispatch layer over the port's kernels.

The counterpart of ``repro/kernels/ops.py``. The models call these. Where
the operands lie decides the path, and nothing else does:

  * a CPU tensor goes to the kernel's plain PyTorch version (``ref``);
  * a CUDA tensor goes to the hand-written kernel, or the kernel raises.

There is no fallback from a failed kernel to the plain version and no
switch that picks one. Mixed operand dtypes promote first, as
``jnp.promote_types`` does in the reference, since the kernels take one
dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import \
    flash_attention_segmented as _flash_seg
from repro_torch.kernels.layernorm import layernorm as _norm
from repro_torch.kernels.mamba_chunk import mamba_chunk as _mamba_chunk
from repro_torch.kernels.masked_softmax import masked_softmax as _msoftmax
from repro_torch.kernels.pim_matvec import pim_matvec as _matvec
from repro_torch.kernels.rwkv_chunk import rwkv_chunk as _rwkv_chunk

KERNELS = {"flash_attention": _flash, "flash_attention_segmented": _flash_seg,
           "decode_attention": _decode, "pim_matvec": _matvec,
           "layernorm": _norm, "rwkv_chunk": _rwkv_chunk,
           "masked_softmax": _msoftmax, "mamba_chunk": _mamba_chunk}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _use_kernel(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for tensors on {t.device}")


def _common(*ts: torch.Tensor):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def fused_matvec(x, w, bias=None, activation: str = "none"):
    """act(x @ w + bias); x: (n, d_in), w: (d_in, d_out)."""
    if bias is None:
        x, w = _common(x, w)
    else:
        x, w, bias = _common(x, w, bias)
    if not _use_kernel(x):
        return ref.matvec_ref(x, w, bias, activation)
    return _matvec(x.contiguous(), w.contiguous(),
                   None if bias is None else bias.contiguous(), activation)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    segment_info=None):
    """q: (B, H, S, D); k, v: (B, KH, Skv, D) -> (B, H, S, D) in q.dtype.
    ``segment_info`` = (q_pos, q_seg, kv_pos, kv_seg) int arrays of shape
    (B, S), (B, S), (B, Skv), (B, Skv) replaces ``q_offset``/``causal``
    with the packed-prefill mask (the segmented kernel)."""
    out_dtype = q.dtype
    q, k, v = _common(q, k, v)
    if segment_info is not None:
        segment_info = [t.to(torch.int32) for t in segment_info]
    if not _use_kernel(q):
        o = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                    segment_info=segment_info)
    elif segment_info is not None:
        o = _flash_seg(q.contiguous(), k.contiguous(), v.contiguous(),
                       [t.contiguous() for t in segment_info])
    else:
        # the kernel reads a cache's prefix in place (contiguous (Skv, D)
        # rows of each head, heads at one stride, k and v alike); any other
        # layout is copied
        KH, D = k.shape[1], k.shape[3]
        rows = k.stride(3) == 1 and k.stride(2) == D \
            and k.stride(0) == KH * k.stride(1)
        if not rows or v.stride() != k.stride():
            k, v = k.contiguous(), v.contiguous()
        o = _flash(q.contiguous(), k, v, causal=causal, q_offset=q_offset)
    return o.to(out_dtype)


def decode_attention(q, k, v, lengths):
    """q: (B, H, D); k, v: (B, KH, S, D); lengths (B,) -> (B, H, D)."""
    out_dtype = q.dtype
    q, k, v = _common(q, k, v)
    lengths = lengths.to(torch.int32)
    if not _use_kernel(q):
        o = ref.decode_attention_ref(q, k, v, lengths)
    else:
        o = _decode(q.contiguous(), k.contiguous(), v.contiguous(),
                    lengths.contiguous())
    return o.to(out_dtype)


def layernorm(x, scale=None, bias=None, *, mode: str = "layernorm",
              eps=None):
    """x: (rows, d) -> (rows, d) in x.dtype; see ``ref.norm_ref``."""
    if not _use_kernel(x):
        return ref.norm_ref(x, scale, bias, mode=mode, eps=eps)
    return _norm(x.contiguous(), scale, bias, mode=mode, eps=eps)


def masked_softmax(x, mask_bitmap):
    """x: (..., n) scores; mask_bitmap: (..., n), nonzero = keep (bool or
    int8) -> softmax over the last axis in x.dtype, masked entries exactly
    0; see ``ref.masked_softmax_ref``."""
    if not _use_kernel(x):
        return ref.masked_softmax_ref(x, mask_bitmap)
    if mask_bitmap.dtype not in (torch.bool, torch.int8):
        mask_bitmap = mask_bitmap != 0
    n = x.shape[-1]
    o = _msoftmax(x.reshape(-1, n).contiguous(),
                  mask_bitmap.reshape(-1, n).contiguous())
    return o.reshape(x.shape)


def rwkv_chunk(r, k, v, w, u, *, out_dtype=None):
    """The RWKV6 wkv from a zero state. r, k, v, w: (BH, T, K); u: (BH, K)
    as in the reference's ops, or (H, K) broadcast over the batch (row bh
    takes u[bh % H]). r, k, v compute in f32 whatever their dtype; w and u
    are taken in f32. Returns (y (BH, T, K) in ``out_dtype``, r.dtype by
    default; S_T (BH, K, K) f32, k-major)."""
    r, k, v = _common(r, k, v)
    w, u = w.float(), u.float()
    if not _use_kernel(r):
        u = u.repeat(r.shape[0] // u.shape[0], 1)
        return ref.rwkv_chunk_ref(r, k, v, w, u, out_dtype=out_dtype)
    return _rwkv_chunk(r.contiguous(), k.contiguous(), v.contiguous(),
                       w.contiguous(), u.contiguous(), out_dtype=out_dtype)


def mamba_chunk(a, u, C):
    """The Mamba selective scan from a zero state. a, u: (B, T, d, n);
    C: (B, T, n), promoted to one dtype. Returns (y (B, T, d) in that
    dtype, h_T (B, d, n) f32)."""
    a, u, C = _common(a, u, C)
    if not _use_kernel(a):
        return ref.mamba_chunk_ref(a, u, C)
    return _mamba_chunk(a.contiguous(), u.contiguous(), C.contiguous())
