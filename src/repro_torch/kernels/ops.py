"""ops — the dispatch layer over the port's kernels.

The counterpart of ``repro/kernels/ops.py``. The models call these. Where
the operands lie decides the path, and nothing else does:

  * a CPU tensor goes to the kernel's plain PyTorch version (``ref``);
  * a CUDA tensor goes to the hand-written kernel, or the kernel raises.

There is no fallback from a failed kernel to the plain version and no
switch that picks one. Mixed operand dtypes promote first, as
``jnp.promote_types`` does in the reference, since the kernels take one
dtype.

A meta tensor (the dry run's shape inference, ``launch/cost.py``) gets
empty meta tensors of the shapes and dtypes the kernel returns, and what
the kernel's autograd Function saves on the card (flash's ``lse``, the
Mamba scan's checkpoints); nothing is computed there. Each wrapper and
each backward carries its kernel's cost formula (``_*_cost``: dot-class
flops as the reference's formulation of the function performs them,
the other flops, transcendentals, bytes read and written once), which
it adds to the active ``cost.CostCounter`` on every device.

Gradients: where an input requires one, the static flash mode (queries
from position 0) goes through ``FlashAttentionFn``, the norm through
``NormFn``, the RWKV6 wkv through ``RwkvChunkFn`` and the Mamba scan
through ``MambaChunkFn``. Each saves only its inputs (flash also its
output and ``lse``, the Mamba scan on the card the states its forward
kernel writes every 16 steps), and its backward follows the device as
the forward does: the plain backward (``ref.*_bwd_ref``) on the CPU,
the hand-written backward kernel on the card. These are the kernels of
the training path of every family. The rest (the GEMV, decode attention,
the masked softmax, the segmented and offset flash modes) serve decoding
and prefill only: they have no backward on the card and raise there if asked
for a gradient; on the CPU autograd runs through their plain versions.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import \
    flash_attention_segmented as _flash_seg
from repro_torch.kernels.flash_attention_bwd import \
    flash_attention_bwd as _flash_bwd
from repro_torch.kernels.layernorm import layernorm as _norm
from repro_torch.kernels.layernorm import layernorm_bwd as _norm_bwd
from repro_torch.kernels.mamba_chunk import CK as _MAMBA_CK
from repro_torch.kernels.mamba_chunk import mamba_chunk as _mamba_chunk
from repro_torch.kernels.mamba_chunk_bwd import \
    mamba_chunk_bwd as _mamba_chunk_bwd
from repro_torch.kernels.masked_softmax import masked_softmax as _msoftmax
from repro_torch.kernels.pim_matvec import pim_matvec as _matvec
from repro_torch.kernels.rwkv_chunk import rwkv_chunk as _rwkv_chunk
from repro_torch.kernels.rwkv_chunk_bwd import \
    rwkv_chunk_bwd as _rwkv_chunk_bwd
from repro_torch.launch import cost
from repro_torch.launch.cost import KernelCost, nbytes

KERNELS = {"flash_attention": _flash, "flash_attention_segmented": _flash_seg,
           "decode_attention": _decode, "pim_matvec": _matvec,
           "layernorm": _norm, "rwkv_chunk": _rwkv_chunk,
           "masked_softmax": _msoftmax, "mamba_chunk": _mamba_chunk,
           "flash_attention_bwd": _flash_bwd, "layernorm_bwd": _norm_bwd,
           "rwkv_chunk_bwd": _rwkv_chunk_bwd,
           "mamba_chunk_bwd": _mamba_chunk_bwd}


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


def _counted(name: str, cost_fn):
    """The wrapper adds ``cost_fn(*its arguments)`` to the active counter
    under ``name`` and the aten ops it runs are not counted; without a
    counter it runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not cost._ACTIVE:
                return fn(*args, **kwargs)
            with cost.kernel(name, cost_fn, *args, **kwargs):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _no_backward_on_card(name: str, *ts) -> None:
    """A serving kernel without a backward kernel refuses a gradient on
    the card rather than return an output autograd cannot differentiate.
    No training path calls one: training runs the static flash mode, the
    norm and the two recurrences, which have backward kernels."""
    if ts[0].is_cuda and _wants_grad(*ts):
        raise NotImplementedError(
            f"{name} serves decoding and prefill and has no backward kernel "
            f"on the card; the training path differentiates the static "
            f"flash mode, the norm, rwkv_chunk and mamba_chunk")


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting 16-byte aligned (the kernels' bf16 routes
    read 16 bytes at a time); a copy only where it is neither."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class FlashAttentionFn(torch.autograd.Function):
    """The static flash mode (queries at positions [0, S)) with the
    recomputing backward: the forward saves (q, k, v, o, lse) and the
    backward recomputes P from them, as the reference's custom VJP
    (``flash_attention_fused``) does. A CUDA tensor runs the flash kernel
    (with its ``lse`` output) and the backward kernel, at every head dim
    the forward takes (16, 32, 64, 96, 112, 128, 160; bf16 on the tensor
    cores, float32 on the CUDA cores; another raises), q, k, v and dO
    passed contiguous and 16-byte aligned for the TMA reads (a copy only
    where they are not); a CPU tensor the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = (_rows16(t) for t in (q, k, v))
        if q.is_meta:
            o, lse = torch.empty_like(q), q.new_empty(q.shape[:3],
                                                      dtype=torch.float32)
        elif _use_kernel(q):
            o, lse = _flash(q, k, v, causal=causal, return_lse=True)
        else:
            o, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                             return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        # saved tensors unpack once (remat's checkpoint allows no more)
        return (*_flash_backward(*ctx.saved_tensors, do, ctx.causal), None)


def _flash_bwd_cost(q, k, v, o, lse, do, causal) -> KernelCost:
    """The four products of attention's gradient (dV, dP, dQ, dK) over the
    full score matrix, as autodiff of the reference's attention takes
    them; the kernel's recomputed QK^T is not the function's work."""
    B, H, S, D = q.shape
    scores = B * H * S * k.shape[2]
    return KernelCost(dot=8 * scores * D, other=4 * scores,
                      bytes=nbytes(q, k, v, o, lse, do) + nbytes(q, k, v))


@_counted("flash_attention_bwd", _flash_bwd_cost)
def _flash_backward(q, k, v, o, lse, do, causal):
    if q.is_meta:
        return tuple(torch.empty_like(t) for t in (q, k, v))
    if _use_kernel(q):
        return _flash_bwd(q, k, v, o, lse, _rows16(do), causal=causal)
    return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)


class NormFn(torch.autograd.Function):
    """The norm with its backward: statistics recomputed from x, nothing
    saved but the inputs. A CUDA tensor runs the Triton forward and
    backward kernels; a CPU tensor the plain versions."""

    @staticmethod
    def forward(ctx, x, scale, bias, mode: str, eps):
        x = x.contiguous()
        if x.is_meta:
            y = torch.empty_like(x)
        elif _use_kernel(x):
            y = _norm(x, scale, bias, mode=mode, eps=eps)
        else:
            y = ref.norm_ref(x, scale, bias, mode=mode, eps=eps)
        ctx.save_for_backward(x, scale, bias)
        ctx.mode, ctx.eps = mode, eps
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*_norm_backward(*ctx.saved_tensors, dy, ctx.mode, ctx.eps),
                None, None)


def _norm_bwd_cost(x, scale, bias, dy, mode, eps) -> KernelCost:
    n = x.numel()
    return KernelCost(other=(_NORM_PASSES[mode] + 6) * n,
                      transcendentals=n // x.shape[-1],
                      bytes=nbytes(x, scale, bias, dy)
                      + nbytes(x, scale, bias))


@_counted("layernorm_bwd", _norm_bwd_cost)
def _norm_backward(x, scale, bias, dy, mode, eps):
    if x.is_meta:
        return tuple(None if t is None else torch.empty_like(t)
                     for t in (x, scale, bias))
    if _use_kernel(x):
        return _norm_bwd(x, scale, bias, dy.contiguous(), mode=mode,
                         eps=eps)
    return ref.norm_bwd_ref(x, scale, bias, dy, mode=mode, eps=eps)


def _common(*ts: torch.Tensor):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _matvec_cost(x, w, bias=None, activation: str = "none") -> KernelCost:
    n, d_in = x.shape
    out = n * w.shape[1]
    act = activation != "none"
    return KernelCost(dot=2 * out * d_in,
                      other=out * ((bias is not None) + act),
                      transcendentals=out * act,
                      bytes=nbytes(x, w, bias) + out * x.element_size())


@_counted("pim_matvec", _matvec_cost)
def fused_matvec(x, w, bias=None, activation: str = "none"):
    """act(x @ w + bias); x: (n, d_in), w: (d_in, d_out)."""
    if bias is None:
        x, w = _common(x, w)
    else:
        x, w, bias = _common(x, w, bias)
    _no_backward_on_card("pim_matvec", x, w, bias)
    if x.is_meta:
        return x.new_empty((x.shape[0], w.shape[1]))
    if not _use_kernel(x):
        return ref.matvec_ref(x, w, bias, activation)
    return _matvec(x.contiguous(), w.contiguous(),
                   None if bias is None else bias.contiguous(), activation)


def _flash_cost(q, k, v, *, causal: bool = True, q_offset: int = 0,
                segment_info=None) -> KernelCost:
    """Both products over the full (Sq, Skv) score matrix, masked or
    not, as the reference's masked attention computes them; the softmax's
    five passes a score."""
    B, H, S, D = q.shape
    scores = B * H * S * k.shape[2]
    return KernelCost(dot=4 * scores * D, other=5 * scores,
                      transcendentals=scores,
                      bytes=nbytes(q, k, v, *(segment_info or ()))
                      + nbytes(q))


@_counted("flash_attention", _flash_cost)
def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    segment_info=None):
    """q: (B, H, S, D); k, v: (B, KH, Skv, D) -> (B, H, S, D) in q.dtype.
    ``segment_info`` = (q_pos, q_seg, kv_pos, kv_seg) int arrays of shape
    (B, S), (B, S), (B, Skv), (B, Skv) replaces ``q_offset``/``causal``
    with the packed-prefill mask (the segmented kernel). Under a gradient
    the static mode from position 0 runs through ``FlashAttentionFn``."""
    out_dtype = q.dtype
    q, k, v = _common(q, k, v)
    if segment_info is None and q_offset == 0 and _wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal).to(out_dtype)
    _no_backward_on_card("flash_attention" if segment_info is None
                         else "flash_attention_segmented", q, k, v)
    if segment_info is not None:
        segment_info = [t.to(torch.int32) for t in segment_info]
    if q.is_meta:
        return torch.empty_like(q, dtype=out_dtype)
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


def _decode_cost(q, k, v, lengths, return_lse: bool = False) -> KernelCost:
    """Both products over every cache position, as the reference's decode
    attention computes them."""
    B, H, D = q.shape
    scores = B * H * k.shape[2]
    return KernelCost(dot=4 * scores * D, other=5 * scores,
                      transcendentals=scores,
                      bytes=nbytes(q, k, v, lengths) + nbytes(q)
                      + 4 * B * H * return_lse)


@_counted("decode_attention", _decode_cost)
def decode_attention(q, k, v, lengths, return_lse: bool = False):
    """q: (B, H, D); k, v: (B, KH, S, D); lengths (B,) -> (B, H, D);
    ``return_lse`` (the partial mode of layout B's cache shards) -> (o,
    the f32 (B, H) log-sum-exp), lengths of 0 allowed."""
    out_dtype = q.dtype
    q, k, v = _common(q, k, v)
    _no_backward_on_card("decode_attention", q, k, v)
    lengths = lengths.to(torch.int32)
    if q.is_meta:
        out = (q.new_empty(q.shape), q.new_empty(q.shape[:2],
                                                 dtype=torch.float32))
        out = out if return_lse else out[0]
    elif not _use_kernel(q):
        out = ref.decode_attention_ref(q, k, v, lengths, return_lse)
    else:
        out = _decode(q.contiguous(), k.contiguous(), v.contiguous(),
                      lengths.contiguous(), return_lse=return_lse)
    if return_lse:
        return out[0].to(out_dtype), out[1]
    return out.to(out_dtype)


_NORM_PASSES = {"layernorm": 7, "np_layernorm": 5, "rmsnorm": 4}


def _norm_cost(x, scale=None, bias=None, *, mode: str = "layernorm",
               eps=None) -> KernelCost:
    n = x.numel()
    return KernelCost(other=_NORM_PASSES[mode] * n,
                      transcendentals=n // x.shape[-1],
                      bytes=nbytes(x, scale, bias) + nbytes(x))


@_counted("layernorm", _norm_cost)
def layernorm(x, scale=None, bias=None, *, mode: str = "layernorm",
              eps=None):
    """x: (rows, d) -> (rows, d) in x.dtype; see ``ref.norm_ref``. Under a
    gradient it runs through ``NormFn``."""
    if _wants_grad(x, scale, bias):
        return NormFn.apply(x, scale, bias, mode, eps)
    if x.is_meta:
        return torch.empty_like(x)
    if not _use_kernel(x):
        return ref.norm_ref(x, scale, bias, mode=mode, eps=eps)
    return _norm(x.contiguous(), scale, bias, mode=mode, eps=eps)


def _softmax_cost(x, mask_bitmap) -> KernelCost:
    n = x.numel()
    return KernelCost(other=6 * n, transcendentals=n,
                      bytes=nbytes(x, mask_bitmap) + nbytes(x))


@_counted("masked_softmax", _softmax_cost)
def masked_softmax(x, mask_bitmap):
    """x: (..., n) scores; mask_bitmap: (..., n), nonzero = keep (bool or
    int8) -> softmax over the last axis in x.dtype, masked entries exactly
    0; see ``ref.masked_softmax_ref``."""
    _no_backward_on_card("masked_softmax", x)
    if x.is_meta:
        return torch.empty_like(x)
    if not _use_kernel(x):
        return ref.masked_softmax_ref(x, mask_bitmap)
    if mask_bitmap.dtype not in (torch.bool, torch.int8):
        mask_bitmap = mask_bitmap != 0
    n = x.shape[-1]
    o = _msoftmax(x.reshape(-1, n).contiguous(),
                  mask_bitmap.reshape(-1, n).contiguous())
    return o.reshape(x.shape)


class RwkvChunkFn(torch.autograd.Function):
    """The wkv with its backward: the forward saves only its inputs, and
    the backward runs the adjoint recurrences from them (recomputing the
    states). A CUDA tensor runs the ``rwkv_chunk`` and ``rwkv_chunk_bwd``
    kernels; a CPU tensor the plain versions. u is (U, K), row bh taking
    u[bh % U]."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, out_dtype):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        return _rwkv_forward(r, k, v, w, u, out_dtype)

    @staticmethod
    def backward(ctx, dy, ds):
        return (*_rwkv_backward(*ctx.saved_tensors, dy, ds), None)


def _rwkv_bwd_cost(r, k, v, w, u, dy, ds) -> KernelCost:
    """Autodiff of the reference's einsums: two products for each."""
    BH, T, K = r.shape
    V = v.shape[-1]
    steps = BH * T
    return KernelCost(dot=4 * steps * (K * V + K + V),
                      other=6 * steps * K * V,
                      bytes=nbytes(r, k, v, w, u, dy, ds) + nbytes(r, k, v)
                      + 4 * (steps * K + u.numel()))


@_counted("rwkv_chunk_bwd", _rwkv_bwd_cost)
def _rwkv_backward(r, k, v, w, u, dy, ds):
    if dy is None:
        dy = torch.zeros(r.shape, dtype=w.dtype, device=r.device)
    if r.is_meta:
        return (*(torch.empty_like(t) for t in (r, k, v)),
                torch.empty_like(r, dtype=w.dtype),
                torch.empty_like(u, dtype=torch.float32))
    if _use_kernel(r):
        return _rwkv_chunk_bwd(r, k, v, w, u, dy.contiguous(),
                               None if ds is None else ds.contiguous())
    return ref.rwkv_chunk_bwd_ref(r, k, v, w, u, dy, ds)


def _rwkv_forward(r, k, v, w, u, out_dtype):
    if r.is_meta:
        BH, _, K = r.shape
        return (torch.empty_like(r, dtype=out_dtype or r.dtype),
                r.new_empty((BH, K, v.shape[-1]), dtype=torch.float32))
    if not _use_kernel(r):
        u_rows = u.repeat(r.shape[0] // u.shape[0], 1)
        return ref.rwkv_chunk_ref(r, k, v, w, u_rows, out_dtype=out_dtype)
    return _rwkv_chunk(r, k, v, w, u, out_dtype=out_dtype)


def _rwkv_cost(r, k, v, w, u, *, out_dtype=None) -> KernelCost:
    """The reference's einsums once a step (``_wkv_scan``: r.S, then
    r.(u k) and its product with v); the state's update k v^T, w S, +."""
    BH, T, K = r.shape
    V = v.shape[-1]
    steps = BH * T
    out = (out_dtype or r.dtype).itemsize
    return KernelCost(dot=2 * steps * (K * V + K + V),
                      other=steps * (3 * K * V + K + V),
                      bytes=nbytes(r, k, v, w, u) + steps * V * out
                      + 4 * BH * K * V)


@_counted("rwkv_chunk", _rwkv_cost)
def rwkv_chunk(r, k, v, w, u, *, out_dtype=None):
    """The RWKV6 wkv from a zero state. r, k, v, w: (BH, T, K); u: (BH, K)
    as in the reference's ops, or (H, K) broadcast over the batch (row bh
    takes u[bh % H]). r, k, v compute in f32 whatever their dtype; w and u
    are taken in f32 (float64 stays float64 on the CPU: ``ref.wide``).
    Returns (y (BH, T, K) in ``out_dtype``, r.dtype by
    default; S_T (BH, K, K) f32, k-major). Under a gradient it runs
    through ``RwkvChunkFn``."""
    r, k, v = (t.contiguous() for t in _common(r, k, v))
    w, u = ref.wide(w).contiguous(), ref.wide(u).contiguous()
    if _wants_grad(r, k, v, w, u):
        return RwkvChunkFn.apply(r, k, v, w, u, out_dtype)
    return _rwkv_forward(r, k, v, w, u, out_dtype)


class MambaChunkFn(torch.autograd.Function):
    """The selective scan with its backward: the forward saves its inputs
    and, on the card, the states the forward kernel writes every 16 steps,
    and the backward runs the adjoint recurrence from them (recomputing
    the states between checkpoints). A CUDA tensor runs the
    ``mamba_chunk`` and ``mamba_chunk_bwd`` kernels; a CPU tensor the
    plain versions."""

    @staticmethod
    def forward(ctx, a, u, C):
        ctx.set_materialize_grads(False)
        if a.is_meta:
            y, h, ck = _mamba_meta(a, checkpoints=True)
        elif _use_kernel(a):
            y, h, ck = _mamba_chunk(a, u, C, checkpoints=True)
        else:
            (y, h), ck = ref.mamba_chunk_ref(a, u, C), None
        ctx.save_for_backward(a, u, C, ck)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        return _mamba_backward(*ctx.saved_tensors, dy, dh)


def _mamba_bwd_cost(a, u, C, ck, dy, dh) -> KernelCost:
    """Autodiff of the einsum (dh += dy C, dC = h.dy) once a step."""
    B, T, d, n = a.shape
    return KernelCost(dot=4 * B * T * d * n, other=4 * B * T * d * n,
                      bytes=nbytes(a, u, C, ck, dy, dh) + nbytes(a, u, C))


@_counted("mamba_chunk_bwd", _mamba_bwd_cost)
def _mamba_backward(a, u, C, ck, dy, dh):
    if dy is None:
        dy = a.new_zeros(a.shape[:3])
    dy = dy.to(a.dtype)
    if a.is_meta:
        return tuple(torch.empty_like(t) for t in (a, u, C))
    if _use_kernel(a):
        return _mamba_chunk_bwd(a, u, C, dy.contiguous(),
                                None if dh is None else dh.contiguous(),
                                ck=ck)
    return ref.mamba_chunk_bwd_ref(a, u, C, dy, dh)


def _mamba_meta(a, checkpoints: bool = False):
    """``mamba_chunk``'s outputs as empty meta tensors: y, h_T and, where
    the forward saves them, the checkpoints every ``CK`` steps."""
    B, T, d, n = a.shape
    y = a.new_empty((B, T, d))
    h = a.new_empty((B, d, n), dtype=torch.float32)
    if not checkpoints:
        return y, h
    return y, h, a.new_empty((B, -(-T // _MAMBA_CK), d, n),
                             dtype=torch.float32)


def _mamba_forward(a, u, C):
    if a.is_meta:
        return _mamba_meta(a)
    if not _use_kernel(a):
        return ref.mamba_chunk_ref(a, u, C)
    return _mamba_chunk(a, u, C)


def _mamba_cost(a, u, C) -> KernelCost:
    """The reference's einsum h.C once a step; h = a h + u."""
    B, T, d, n = a.shape
    ck = 4 * B * -(-T // _MAMBA_CK) * d * n if _wants_grad(a, u, C) else 0
    return KernelCost(dot=2 * B * T * d * n, other=2 * B * T * d * n,
                      bytes=nbytes(a, u, C) + B * T * d * a.element_size()
                      + 4 * B * d * n + ck)


@_counted("mamba_chunk", _mamba_cost)
def mamba_chunk(a, u, C):
    """The Mamba selective scan from a zero state. a, u: (B, T, d, n);
    C: (B, T, n), promoted to one dtype. Returns (y (B, T, d) in that
    dtype, h_T (B, d, n) f32). Under a gradient it runs through
    ``MambaChunkFn``."""
    a, u, C = (t.contiguous() for t in _common(a, u, C))
    if _wants_grad(a, u, C):
        return MambaChunkFn.apply(a, u, C)
    return _mamba_forward(a, u, C)
