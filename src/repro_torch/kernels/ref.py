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


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32, the plain versions' arithmetic; a float64 t stays
    float64, so that the whole plain path runs in float64 as a yardstick
    for float32 results."""
    return t if t.dtype == torch.float64 else t.float()
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


def _static_mask(q, k, causal: bool, q_offset: int):
    if not causal:
        return None
    q_pos = q_offset + torch.arange(q.shape[2], device=q.device)
    kv_pos = torch.arange(k.shape[2], device=q.device)
    return q_pos[:, None] >= kv_pos[None, :]


def flash_attention_ref(q, k, v, causal: bool = True, q_offset: int = 0,
                        segment_info=None, return_lse: bool = False):
    """q: (B, H, S, D); k, v: (B, KH, Skv, D) -> (B, H, S, D). Queries sit
    at global positions [q_offset, q_offset + S) against keys [0, Skv).
    ``segment_info`` = (q_pos, q_seg, kv_pos, kv_seg) replaces
    ``q_offset``/``causal`` with the packed-prefill mask
    (``segment_attention_ref``). ``return_lse=True`` (static mode) also
    returns each row's log-sum-exp (B, H, S) f32 in natural-log units of
    the scaled scores, ``m + log(max(l, 1e-30))`` as the reference's
    ``flash_attention_xla`` defines it."""
    if segment_info is not None:
        if return_lse:
            raise ValueError("return_lse is the static mode's")
        return segment_attention_ref(q, k, v, *segment_info)
    return _masked_attention(q, k, v, _static_mask(q, k, causal, q_offset),
                             return_lse=return_lse)


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


def _masked_attention(q, k, v, mask, return_lse: bool = False):
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
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float()) / l
    o = o.reshape(B, H, S, D).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).reshape(B, H, S)
    return o


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """The recomputing flash backward, a plain port of the reference's
    ``_flash_bwd`` (``repro/models/attention.py``): from the forward's
    inputs, its output o and its ``lse`` (B, H, S) f32, and the output's
    gradient do (B, H, S, D) -> (dq, dk, dv) in the dtypes of q, k, v.
    P = exp(s - lse) is recomputed from the scaled scores, D = rowsum(dO o)
    in f32, dS = P (dP - D); a KV head's dk and dv sum over its G query
    heads. Static mode, queries from position 0 (Sq = Skv when causal)."""
    B, H, S, hd = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KH, G, S, hd).float() * scale
    dog = do.reshape(B, KH, G, S, hd).float()
    og = o.reshape(B, KH, G, S, hd).float()
    kf, vf = k.float(), v.float()
    delta = (dog * og).sum(-1)                                # (B,KH,G,S)
    s = torch.einsum("bkgqh,bkch->bkgqc", qg, kf)
    mask = _static_mask(q, k, causal, 0)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.reshape(B, KH, G, S, 1).float())
    dv = torch.einsum("bkgqc,bkgqh->bkch", p, dog)
    dp = torch.einsum("bkgqh,bkch->bkgqc", dog, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqc,bkch->bkgqh", ds, kf) * scale
    dk = torch.einsum("bkgqc,bkgqh->bkch", ds, qg)           # qg has scale
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q, k, v, lengths, return_lse: bool = False):
    """q: (B, H, D); k, v: (B, KH, S, D); lengths: (B,) valid prefix
    lengths (at least 1) -> (B, H, D). ``return_lse`` (the partial mode)
    also returns the f32 (B, H) log-sum-exp of the scaled scores and takes
    lengths of 0, for which o = 0 and lse = -inf."""
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
    if not return_lse:
        return o.reshape(B, H, D).to(q.dtype)
    seen = (lengths > 0)[:, None, None, None]
    o = torch.where(seen, o, torch.zeros_like(o))
    lse = torch.where(seen, m + torch.log(l),
                      torch.full_like(m, -math.inf))
    return o.reshape(B, H, D).to(q.dtype), lse.reshape(B, H)


def norm_ref(x, scale=None, bias=None, *, mode: str = "layernorm",
             eps=None) -> torch.Tensor:
    """x: (rows, d). ``mode``: "rmsnorm" (scale; eps 1e-6), "layernorm"
    (scale and bias; eps 1e-5, the reference's two-phase LN) or
    "np_layernorm" (no affine; eps 1e-5). f32 math, out in x.dtype."""
    if mode not in NORM_EPS:
        raise ValueError(f"unknown norm mode {mode!r}")
    eps = NORM_EPS[mode] if eps is None else eps
    xf = wide(x)
    if mode == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        y = y * wide(scale)
    else:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if mode == "layernorm":
            y = y * wide(scale) + wide(bias)
    return y.to(x.dtype)


def norm_bwd_ref(x, scale, bias, dy, *, mode: str = "layernorm",
                 eps=None):
    """The gradient of ``norm_ref``: x, dy (rows, d) -> (dx in x.dtype,
    dscale and dbias in the dtypes of scale and bias, or None where the
    mode has none). The statistics are recomputed from x in f32; the
    column sums over rows are f32 before the cast."""
    if mode not in NORM_EPS:
        raise ValueError(f"unknown norm mode {mode!r}")
    eps = NORM_EPS[mode] if eps is None else eps
    xf, g = wide(x), wide(dy)
    d = x.shape[-1]
    dscale = dbias = None
    if mode == "rmsnorm":
        r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        xhat = xf * r
        dscale = (g * xhat).sum(0).to(scale.dtype)
        gs = g * wide(scale)
        dx = r * (gs - xhat * (gs * xhat).sum(-1, keepdim=True) / d)
    else:
        mean = xf.mean(-1, keepdim=True)
        xc = xf - mean
        r = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
        xhat = xc * r
        gs = g
        if mode == "layernorm":
            dscale = (g * xhat).sum(0).to(scale.dtype)
            dbias = g.sum(0).to(bias.dtype)
            gs = g * wide(scale)
        dx = r * (gs - gs.mean(-1, keepdim=True)
                  - xhat * (gs * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), dscale, dbias


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
    rf, kf, vf, wf = (wide(a) for a in (r, k, v, w))
    uf = wide(u)
    s = torch.zeros((BH, K, K), dtype=rf.dtype, device=r.device)
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


def mamba_checkpoints_ref(a, u, every: int = 16):
    """The states that ``mamba_chunk``'s kernel writes under a gradient:
    h before steps 0, every, 2 every, ... of ``mamba_chunk_ref``'s
    recurrence (h before step 0 is 0). a, u: (B, T, d, n). Returns
    (B, ceil(T / every), d, n) f32."""
    B, T, d, n = a.shape
    h = torch.zeros((B, d, n), dtype=torch.float32, device=a.device)
    out = []
    for t in range(T):
        if t % every == 0:
            out.append(h)
        h = a[:, t].float() * h + u[:, t].float()
    return torch.stack(out, dim=1)


def rwkv_chunk_bwd_ref(r, k, v, w, u, dy, ds=None):
    """The gradient of ``rwkv_chunk_ref`` as explicit adjoint recurrences
    (no autograd). r, k, v, w, dy: (BH, T, K); u: (U, K) with BH % U == 0,
    row bh taking u[bh % U]; ds: the final state's gradient (BH, K, K) or
    None. In f32, with S_{t-1} the state before step t (S_{-1} = 0) and
    G_t the gradient of S_t (G_{T-1} = ds):

      dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
      dk_t = G_t v_t + u * r_t (v_t . dy_t)
      dv_t = G_t^T k_t + dy_t (r_t . (u * k_t))
      dw_t = rowsum(G_t * S_{t-1})
      du   = sum_t r_t * k_t (v_t . dy_t), summed over the rows bh that
             share u[bh % U]
      G_{t-1} = diag(w_t) G_t + r_t dy_t^T

    Returns (dr, dk, dv in r.dtype; dw (BH, T, K) f32; du (U, K) f32)."""
    BH, T, K = r.shape
    U = u.shape[0]
    rf, kf, vf, wf, gy = (wide(a) for a in (r, k, v, w, dy))
    uf = wide(u).repeat(BH // U, 1)                          # (BH, K)
    vdy = (vf * gy).sum(-1, keepdim=True)                    # (BH, T, 1)
    s = torch.zeros((BH, K, K), dtype=rf.dtype, device=r.device)
    states, dr = [], torch.empty_like(rf)
    for t in range(T):
        states.append(s)
        dr[:, t] = torch.einsum("bij,bj->bi", s, gy[:, t]) \
            + uf * kf[:, t] * vdy[:, t]
        s = wf[:, t, :, None] * s + kf[:, t, :, None] * vf[:, t, None, :]
    g = s.new_zeros(s.shape) if ds is None else wide(ds)
    dk, dv, dw = (torch.empty_like(rf) for _ in range(3))
    for t in reversed(range(T)):
        dk[:, t] = torch.einsum("bij,bj->bi", g, vf[:, t]) \
            + uf * rf[:, t] * vdy[:, t]
        dv[:, t] = torch.einsum("bij,bi->bj", g, kf[:, t]) \
            + gy[:, t] * (rf[:, t] * uf * kf[:, t]).sum(-1, keepdim=True)
        dw[:, t] = (g * states[t]).sum(-1)
        g = wf[:, t, :, None] * g + rf[:, t, :, None] * gy[:, t, None, :]
    du = (rf * kf * vdy).sum(1).reshape(BH // U, U, K).sum(0)
    return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du


def mamba_chunk_bwd_ref(a, u, C, dy, dh=None):
    """The gradient of ``mamba_chunk_ref`` as an explicit adjoint
    recurrence (no autograd). a, u: (B, T, d, n); C: (B, T, n); dy
    (B, T, d); dh: the final state's gradient (B, d, n) or None. In f32,
    with h_{t-1} the state before step t (h_{-1} = 0) and g_t the gradient
    of h_t:

      g_t  = dy_t[:, None] * C_t + a_{t+1} * g_{t+1}   (g_T-1 adds dh)
      da_t = g_t * h_{t-1};  du_t = g_t;  dC_t = sum_d h_t * dy_t[:, None]

    h_{t-1} is kept from a forward pass, never recovered as
    (h_t - u_t) / a_t (a underflows to 0). Returns (da, du, dC) in a's
    dtype."""
    B, T, d, n = a.shape
    af, uf, Cf, gy = (x.float() for x in (a, u, C, dy))
    h = torch.zeros((B, d, n), dtype=torch.float32, device=a.device)
    states, dC = [], torch.empty_like(Cf)
    for t in range(T):
        states.append(h)
        h = af[:, t] * h + uf[:, t]
        dC[:, t] = (h * gy[:, t, :, None]).sum(1)
    g = h.new_zeros(h.shape) if dh is None else dh.float()
    a_next = torch.ones_like(g)
    da, du = torch.empty_like(af), torch.empty_like(uf)
    for t in reversed(range(T)):
        g = gy[:, t, :, None] * Cf[:, t, None, :] + a_next * g
        da[:, t] = g * states[t]
        du[:, t] = g
        a_next = af[:, t]
    return da.to(a.dtype), du.to(a.dtype), dC.to(a.dtype)
