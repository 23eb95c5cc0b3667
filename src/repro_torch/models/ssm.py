"""Recurrent mixers of the port: RWKV6 (Finch) time mix and channel mix,
and the Mamba selective SSM (as interleaved in Jamba).

Counterpart of ``repro/models/ssm.py``. Layouts, dtypes and float32
handling follow the reference: r, k, v and the decay w enter the wkv in
f32, and w = exp(-exp(clip(log w, -10, 4))) is computed in f32 (in bf16 a
decay within 4.5e-5 of 1 rounds to exactly 1); Mamba's dt, B, C, the
discretized a = exp(dt A) and u = dt x B are f32 too.

Both recurrences have two paths, as the reference's module docstring
splits them:

  * from a zero state over a whole sequence (``state=None``, the
    full-sequence prefill): the ``rwkv_chunk`` kernel through
    ``ops.rwkv_chunk`` (y in f32), and the ``mamba_chunk`` kernel through
    ``ops.mamba_chunk``;
  * from a carried state (the engine's decode and sequential prefill,
    T = 1): ``_wkv_scan`` and Mamba's scan over ``chunked_linear_scan`` in
    plain PyTorch (both kernels start from zero, as the TPU kernels do).

At T = 1 with a state (the decode step) the FC products go through the GEMV
kernel (``ops.fused_matvec``): RWKV's r, k, v, g, output projection and the
channel mix's three, eight launches a layer; Mamba's ``in_proj_x``,
``in_proj_z`` and ``out_proj``, three. The low-rank products (RWKV's decay
LoRA, Mamba's dt, B and C projections) stay matmuls. Elsewhere the
products are plain matmuls, as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import mm
from repro_torch.models.params import ParamDef


# --------------------------------------------------------------------------- #
# elementwise-decay linear scan (the stateful path)
# --------------------------------------------------------------------------- #
def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t (elementwise, any trailing state dims).

    a, b: (T, ...state); h0: (...state). Returns (h_all (T, ...state)
    inclusive states, h_final). Plain PyTorch, one step at a time."""
    h, hs = h0, []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        hs.append(h)
    return torch.stack(hs), h


# --------------------------------------------------------------------------- #
# RWKV6 (Finch)
# --------------------------------------------------------------------------- #
def rwkv_defs(cfg: ModelConfig, stacked: Optional[int] = None) -> dict:
    """The reference's RWKV6 parameters. As there, no dtype is passed, so
    every leaf takes ``ParamDef``'s default, bfloat16."""
    d, f = cfg.d_model, cfg.d_ff
    H, hd = cfg.num_heads, cfg.rwkv_head_dim
    r = max(32, d // 64)  # decay-lora rank
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)

    def pd(shape, axes, init="normal", scale=1.0):
        return ParamDef(lead + shape, la + axes, init, scale)

    return {
        # time-mix interpolation coefficients (static ddlerp part)
        "mu_r": pd((d,), ("d_model",), "zeros"),
        "mu_k": pd((d,), ("d_model",), "zeros"),
        "mu_v": pd((d,), ("d_model",), "zeros"),
        "mu_g": pd((d,), ("d_model",), "zeros"),
        "mu_w": pd((d,), ("d_model",), "zeros"),
        # projections
        "wr": pd((d, H, hd), ("d_model", "rwkv_heads", "head_dim")),
        "wk": pd((d, H, hd), ("d_model", "rwkv_heads", "head_dim")),
        "wv": pd((d, H, hd), ("d_model", "rwkv_heads", "head_dim")),
        "wg": pd((d, H, hd), ("d_model", "rwkv_heads", "head_dim")),
        "wo": pd((H, hd, d), ("rwkv_heads", "head_dim", "d_model")),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": pd((H, hd), ("rwkv_heads", "head_dim"), "decay"),
        "w_lora_a": pd((d, r), ("d_model", None), "small_normal"),
        "w_lora_b": pd((r, H, hd), (None, "rwkv_heads", "head_dim"), "zeros"),
        # bonus
        "u": pd((H, hd), ("rwkv_heads", "head_dim"), "small_normal"),
        # per-head group norm on the wkv output
        "ln_scale": pd((H, hd), ("rwkv_heads", "head_dim"), "ones"),
        "ln_bias": pd((H, hd), ("rwkv_heads", "head_dim"), "zeros"),
        # channel mix
        "mu_ck": pd((d,), ("d_model",), "zeros"),
        "mu_cr": pd((d,), ("d_model",), "zeros"),
        "wck": pd((d, f), ("d_model", "d_ff")),
        "wcv": pd((f, d), ("d_ff", "d_model")),
        "wcr": pd((d, d), ("d_model", None)),
    }


def _fc(x: torch.Tensor, w: torch.Tensor, gemv: bool) -> torch.Tensor:
    """x: (B, T, d_in) @ w (d_in, d_out) in the promoted dtype; through the
    GEMV kernel for decode rows (T = 1), else a matmul."""
    if not gemv:
        return mm(x, w)
    B, T, d_in = x.shape
    return ops.fused_matvec(x.reshape(B * T, d_in), w).reshape(B, T, -1)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_prev[t] = x[t-1]; position 0 takes ``prev`` (decode carry) or
    zeros."""
    B, _, d = x.shape
    first = x.new_zeros((B, 1, d)) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1, :]], dim=1)


def _ddlerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _wkv_scan(r, k, v, w, u, s0):
    """r, k, v, w: (B, H, T, hd); u: (H, hd); s0: (B, H, hd, hd) k-major.

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);
    S_t = diag(w_t) S_{t-1} + k_t v_t^T. Returns (y (B, H, T, hd) f32,
    s_final)."""
    # time leading for the scan: (T, B, H, ...)
    rt, kt, vt, wt = (a.permute(2, 0, 1, 3).float() for a in (r, k, v, w))
    b = kt[..., None] * vt[..., None, :]                  # (T,B,H,hd_k,hd_v)
    a = wt[..., None].expand(b.shape)
    s0 = s0.float()
    s_all, s_fin = chunked_linear_scan(a, b, s0)
    s_prev = torch.cat([s0[None], s_all[:-1]], dim=0)     # exclusive states
    bonus = u.float()[None, None] * kt                    # (T,B,H,hd_k)
    y = torch.einsum("tbhk,tbhkv->tbhv", rt, s_prev) \
        + (rt * bonus).sum(-1, keepdim=True) * vt
    return y.permute(1, 2, 0, 3), s_fin                   # (B,H,T,hd)


def _group_norm(y: torch.Tensor, scale, bias) -> torch.Tensor:
    """Per-head LayerNorm of the wkv output (RWKV's ln_x), in f32."""
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = (yf - mean).square().mean(-1, keepdim=True)
    yn = (yf - mean) * torch.rsqrt(var + 1e-5)
    return yn * scale.float()[None, :, None, :] \
        + bias.float()[None, :, None, :]


def rwkv_time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  state: Optional[dict] = None):
    """x: (B, T, d). state (decode): {"shift_tm": (B, d),
    "wkv": (B, H, hd, hd)}. Returns (out (B, T, d), new_state)."""
    B, T, d = x.shape
    H, hd = cfg.num_heads, cfg.rwkv_head_dim
    c = min(cfg.ssm_chunk, T)
    if T % c:
        raise ValueError(f"sequence length {T} is not a multiple of "
                         f"ssm_chunk {c}")
    gemv = state is not None and T == 1
    prev = None if state is None else state["shift_tm"]
    xp = _token_shift(x, prev)

    def proj(mu, w):                                      # -> (B, H, T, hd)
        xm = _ddlerp(x, xp, mu)
        return _fc(xm, w.reshape(d, H * hd), gemv).reshape(
            B, T, H, hd).permute(0, 2, 1, 3)

    r = proj(p["mu_r"], p["wr"])
    k = proj(p["mu_k"], p["wk"])
    v = proj(p["mu_v"], p["wv"])
    g = proj(p["mu_g"], p["wg"])

    # data-dependent decay (the Finch contribution), in f32
    xw = _ddlerp(x, xp, p["mu_w"])
    dd = torch.einsum("btr,rhk->bthk",
                      torch.tanh(mm(xw, p["w_lora_a"]).float()),
                      p["w_lora_b"].float())
    logw = p["w0"].float()[None, None] + dd               # (B, T, H, hd)
    w = torch.exp(-torch.exp(torch.clamp(logw, -10.0, 4.0)))
    w = w.permute(0, 2, 1, 3)                             # (B, H, T, hd)

    if state is None:
        y, s_fin = ops.rwkv_chunk(
            r.reshape(B * H, T, hd), k.reshape(B * H, T, hd),
            v.reshape(B * H, T, hd), w.reshape(B * H, T, hd), p["u"],
            out_dtype=torch.float32)
        y, s_fin = y.reshape(B, H, T, hd), s_fin.reshape(B, H, hd, hd)
    else:
        y, s_fin = _wkv_scan(r, k, v, w, p["u"], state["wkv"])
    y = _group_norm(y, p["ln_scale"], p["ln_bias"])
    y = y.to(x.dtype) * F.silu(g)
    y = y.permute(0, 2, 1, 3).reshape(B, T, H * hd)
    out = _fc(y, p["wo"].reshape(H * hd, d), gemv)
    return out, {"shift_tm": x[:, -1, :], "wkv": s_fin}


def rwkv_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     state: Optional[dict] = None):
    """x: (B, T, d). state (decode): {"shift_cm": (B, d)}. Squared-ReLU key,
    sigmoid receptance. Returns (out (B, T, d), new_state)."""
    gemv = state is not None and x.shape[1] == 1
    prev = None if state is None else state["shift_cm"]
    xp = _token_shift(x, prev)
    xk = _ddlerp(x, xp, p["mu_ck"])
    xr = _ddlerp(x, xp, p["mu_cr"])
    k = torch.square(torch.relu(_fc(xk, p["wck"], gemv)))
    v = _fc(k, p["wcv"], gemv)
    r = torch.sigmoid(_fc(xr, p["wcr"], gemv))
    return r * v, {"shift_cm": x[:, -1, :]}


# --------------------------------------------------------------------------- #
# Mamba (selective SSM, as interleaved in Jamba)
# --------------------------------------------------------------------------- #
def mamba_defs(cfg: ModelConfig, stacked: Optional[int] = None) -> dict:
    """The reference's Mamba parameters. As there, no dtype is passed, so
    every leaf takes ``ParamDef``'s default, bfloat16."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_d_state
    r = max(16, d // 16)  # dt rank
    cw = cfg.ssm_conv
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)

    def pd(shape, axes, init="normal", scale=1.0):
        return ParamDef(lead + shape, la + axes, init, scale)

    return {
        "in_proj_x": pd((d, di), ("d_model", "d_inner")),
        "in_proj_z": pd((d, di), ("d_model", "d_inner")),
        "conv_w": pd((cw, di), ("conv", "d_inner"), "normal", scale=2.0),
        "conv_b": pd((di,), ("d_inner",), "zeros"),
        "w_b": pd((di, n), ("d_inner", "d_state"), "small_normal"),
        "w_c": pd((di, n), ("d_inner", "d_state"), "small_normal"),
        "w_dt_in": pd((di, r), ("d_inner", None), "small_normal"),
        "w_dt_out": pd((r, di), (None, "d_inner"), "small_normal"),
        "dt_bias": pd((di,), ("d_inner",), "decay", scale=0.5),
        "a_log": pd((di, n), ("d_inner", "d_state"), "decay", scale=-1.0),
        "d_skip": pd((di,), ("d_inner",), "ones"),
        "out_proj": pd((di, d), ("d_inner", "d_model")),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           state: Optional[torch.Tensor]):
    """x: (B, T, di); w: (cw, di). Causal width-cw depthwise conv as a sum
    of shifted slices. state (decode): (B, cw-1, di) history. Returns
    (out (B, T, di), new history)."""
    cw = w.shape[0]
    B, T, di = x.shape
    hist = x.new_zeros((B, cw - 1, di)) if state is None else state
    dt = torch.promote_types(hist.dtype, x.dtype)
    xp = torch.cat([hist.to(dt), x.to(dt)], dim=1)        # (B, T+cw-1, di)
    out = sum(xp[:, j:j + T, :] * w[j][None, None] for j in range(cw))
    new_state = xp[:, T:, :] if cw > 1 else hist
    return out + b[None, None], new_state


def mamba_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
              state: Optional[dict] = None):
    """x: (B, T, d). state (decode): {"conv": (B, cw-1, di),
    "ssm": (B, di, n)}. Returns (out (B, T, d), new_state)."""
    B, T, d = x.shape
    c = min(cfg.ssm_chunk, T)
    if T % c:
        raise ValueError(f"sequence length {T} is not a multiple of "
                         f"ssm_chunk {c}")
    gemv = state is not None and T == 1
    xz = _fc(x, p["in_proj_x"], gemv)
    z = _fc(x, p["in_proj_z"], gemv)

    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_depthwise_conv(xz, p["conv_w"], p["conv_b"],
                                          conv_state)
    xc = F.silu(xc)

    # selective parameters, in f32
    dt = mm(mm(xc, p["w_dt_in"]), p["w_dt_out"])
    dt = F.softplus(dt.float() + p["dt_bias"].float())    # (B, T, di)
    Bt = mm(xc, p["w_b"]).float()
    Ct = mm(xc, p["w_c"]).float()
    A = -torch.exp(p["a_log"].float())                    # (di, n) < 0

    # (B, T, di, n) each: 2.15 GB in f32 at jamba's B 2 x S 2048, so the
    # exp is taken in place
    a = (dt[..., None] * A).exp_()
    u = (dt * xc.float())[..., None] * Bt[:, :, None, :]
    if state is None:
        y, h_fin = ops.mamba_chunk(a, u, Ct)              # (B, T, di) f32
    else:
        h_all, h_fin = chunked_linear_scan(a.transpose(0, 1),
                                           u.transpose(0, 1),
                                           state["ssm"].float())
        y = torch.einsum("tbdn,tbn->btd", h_all, Ct.transpose(0, 1))
    y = y + p["d_skip"].float() * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = _fc(y, p["out_proj"], gemv)
    return out, {"conv": new_conv, "ssm": h_fin}
