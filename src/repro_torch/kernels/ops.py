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
from repro_torch.kernels.pim_matvec import pim_matvec as _matvec

KERNELS = {"flash_attention": _flash, "flash_attention_segmented": _flash_seg,
           "decode_attention": _decode, "pim_matvec": _matvec,
           "layernorm": _norm}


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
