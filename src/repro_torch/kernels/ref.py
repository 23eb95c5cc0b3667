"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its kernel computes, with plain tensor
operations: the CPU tests run these against the reference package's
oracles, and ``chip_smoke.py`` holds each CUDA/Triton kernel against them
on the card. They repeat the kernels' arithmetic (f32 math, ``-1e30``
masking, the ``1e-30`` clamp) and are no yardstick of speed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
NORM_EPS = {"rmsnorm": 1e-6, "layernorm": 1e-5, "np_layernorm": 1e-5}


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    """The matvec epilogue; GELU is the tanh form, as ``jax.nn.gelu``'s
    default."""
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if activation == "silu":
        return F.silu(x)
    if activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    return x


def matvec_ref(x, w, bias=None, activation: str = "none") -> torch.Tensor:
    """x: (n, d_in); w: (d_in, d_out) -> act(x @ w + b), f32 accumulation,
    out in x.dtype."""
    out = x.float() @ w.float()
    if bias is not None:
        out = out + bias.float()
    return activate(out, activation).to(x.dtype)


def flash_attention_ref(q, k, v, causal: bool = True, q_offset: int = 0,
                        segment_info=None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KH, Skv, D) -> (B, H, S, D). Queries sit
    at global positions [q_offset, q_offset + S) against keys [0, Skv).
    ``segment_info`` = (q_pos, q_seg, kv_pos, kv_seg) replaces
    ``q_offset``/``causal`` with the packed-prefill mask
    (``segment_attention_ref``)."""
    if segment_info is not None:
        return segment_attention_ref(q, k, v, *segment_info)
    S, Skv = q.shape[2], k.shape[2]
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(S, device=q.device)
        kv_pos = torch.arange(Skv, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
    return _masked_attention(q, k, v, mask)


def segment_attention_ref(q, k, v, q_pos, q_seg, kv_pos,
                          kv_seg) -> torch.Tensor:
    """The packed-prefill mask. q: (B, H, Sq, D); k, v: (B, KH, Skv, D);
    q_pos/q_seg: (B, Sq); kv_pos/kv_seg: (B, Skv) int32. A query attends a
    key iff they share a segment id and the key's position does not exceed
    the query's (causal within the segment). A query that matches no key
    (padding, segment -2) averages every key, as a softmax over equal
    ``-1e30`` scores does."""
    mask = ((q_seg[:, :, None] == kv_seg[:, None, :])
            & (q_pos[:, :, None] >= kv_pos[:, None, :]))     # (B, Sq, Skv)
    return _masked_attention(q, k, v, mask[:, None, None])


def _masked_attention(q, k, v, mask) -> torch.Tensor:
    """Softmax attention in f32 with masked scores at ``-1e30`` and the row
    sum clamped at 1e-30; ``mask`` broadcasts to (B, KH, G, S, Skv)."""
    B, H, S, D = q.shape
    KH = k.shape[1]
    qg = q.reshape(B, KH, H // KH, S, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float())
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.reshape(B, H, S, D).to(q.dtype)


def decode_attention_ref(q, k, v, lengths) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, KH, S, D); lengths: (B,) valid prefix
    lengths (at least 1) -> (B, H, D)."""
    B, H, D = q.shape
    KH, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, KH, H // KH, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bkgd,bkcd->bkgc", qg, k.float())
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgc,bkcd->bkgd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.reshape(B, H, D).to(q.dtype)


def norm_ref(x, scale=None, bias=None, *, mode: str = "layernorm",
             eps=None) -> torch.Tensor:
    """x: (rows, d). ``mode``: "rmsnorm" (scale; eps 1e-6), "layernorm"
    (scale and bias; eps 1e-5, the reference's two-phase LN) or
    "np_layernorm" (no affine; eps 1e-5). f32 math, out in x.dtype."""
    if mode not in NORM_EPS:
        raise ValueError(f"unknown norm mode {mode!r}")
    eps = NORM_EPS[mode] if eps is None else eps
    xf = x.float()
    if mode == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        y = y * scale.float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if mode == "layernorm":
            y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def masked_softmax_ref(x, mask_bitmap) -> torch.Tensor:
    """x: (..., n); mask_bitmap: (..., n), nonzero = keep. Softmax over the
    last axis with the max subtracted, in f32: masked entries are exactly 0,
    and a fully masked row is all zeros (its sum is clamped at 1e-30). Out
    in x.dtype."""
    keep = mask_bitmap != 0
    xf = torch.where(keep, x.float(), torch.full_like(x, NEG_INF,
                                                      dtype=torch.float32))
    m = xf.amax(dim=-1, keepdim=True)
    e = torch.exp(xf - m) * keep.float()
    return (e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
            ).to(x.dtype)


def rwkv_chunk_ref(r, k, v, w, u, out_dtype=None):
    """The sequential oracle of the RWKV6 wkv from a zero state, batched
    over BH. r, k, v, w: (BH, T, K); u: (BH, K). Per step, in f32,
    y_t = r_t . (S + diag(u) k_t v_t^T) and S <- diag(w_t) S + k_t v_t^T.
    Returns (y (BH, T, K) in ``out_dtype``, r.dtype by default; S_T
    (BH, K, K) f32, k-major)."""
    BH, T, K = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    s = torch.zeros((BH, K, K), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(T):
        kv = kf[:, t, :, None] * vf[:, t, None, :]                # (BH, K, K)
        ys.append(torch.einsum("bk,bkv->bv", rf[:, t], s + uf[:, :, None] * kv))
        s = wf[:, t, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else rf.new_zeros((BH, 0, K))
    return y.to(r.dtype if out_dtype is None else out_dtype), s


def mamba_chunk_ref(a, u, C):
    """The sequential oracle of the Mamba selective scan from a zero state,
    batched over B. a, u: (B, T, d, n); C: (B, T, n). Per step, in f32,
    h_t = a_t * h_{t-1} + u_t and y_t = sum_n h_t C_t. Returns (y (B, T, d)
    in a.dtype, h_T (B, d, n) f32); T >= 1."""
    B, T, d, n = a.shape
    h = torch.zeros((B, d, n), dtype=torch.float32, device=a.device)
    ys = []
    for t in range(T):
        h = a[:, t].float() * h + u[:, t].float()
        ys.append((h * C[:, t, None, :].float()).sum(-1))
    return torch.stack(ys, dim=1).to(a.dtype), h
