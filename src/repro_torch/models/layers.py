"""Shared building blocks: norms, RoPE, dense MLP, embeddings, loss.

Counterpart of ``repro/models/layers.py``. Products follow the reference's
dtype flow: the residual stream takes the embedding table's dtype, and a
product of two dtypes computes in their promotion (``torch.matmul`` refuses
mixed operands, so ``mm`` promotes explicitly). The decode step's FC
products go through the GEMV kernel (``apply_mlp_gemv``); prefill products
and the LM head stay plain matmuls, as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two (``jnp.promote_types``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


# --------------------------------------------------------------------------- #
# Norms (the norm kernel; kernels/layernorm.py)
# --------------------------------------------------------------------------- #
def norm_defs(cfg: ModelConfig, stacked: Optional[int] = None) -> dict:
    if cfg.norm == "np_layernorm":
        return {}
    shape = (cfg.d_model,)
    axes: tuple = ("d_model",)
    if stacked is not None:
        shape = (stacked,) + shape
        axes = ("layers",) + axes
    out = {"scale": ParamDef(shape, axes, "ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamDef(shape, axes, "zeros")
    return out


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """rmsnorm (eps 1e-6), layernorm / np_layernorm (eps 1e-5), computed in
    f32 and cast back to x.dtype."""
    y = ops.layernorm(x.reshape(-1, x.shape[-1]), p.get("scale"),
                      p.get("bias"), mode=cfg.norm)
    return y.reshape(x.shape)


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# --------------------------------------------------------------------------- #
# RoPE (f32 math, rotate-half layout)
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: broadcastable to (..., seq)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Dense (SwiGLU / GELU) MLP
# --------------------------------------------------------------------------- #
def mlp_defs(cfg: ModelConfig, stacked: Optional[int] = None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)
    out = {
        "wi": ParamDef(lead + (d, f), la + ("d_model", "d_ff")),
        "wo": ParamDef(lead + (f, d), la + ("d_ff", "d_model")),
    }
    if cfg.act == "silu":  # gated
        out["wg"] = ParamDef(lead + (d, f), la + ("d_model", "d_ff"))
    return out


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); the prefill-stage (GEMM) MLP."""
    h = mm(x, p["wi"])
    if "wg" in p:
        h = activation(cfg, mm(x, p["wg"])) * h
    else:
        h = activation(cfg, h)
    return mm(h, p["wo"])


def apply_mlp_gemv(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (n, d) decode rows -> (n, d) through the GEMV kernel: the gated
    MLP is matvec(x, wg, act) * matvec(x, wi), then matvec(., wo)."""
    if "wg" in p:
        h = ops.fused_matvec(x, p["wg"], activation=cfg.act) \
            * ops.fused_matvec(x, p["wi"])
    else:
        h = ops.fused_matvec(x, p["wi"], activation=cfg.act)
    return ops.fused_matvec(h, p["wo"])


# --------------------------------------------------------------------------- #
# Embedding / LM head
# --------------------------------------------------------------------------- #
def embed_defs(cfg: ModelConfig) -> dict:
    out = {"tok": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "d_model"),
                           "small_normal")}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                  ("d_model", "vocab"))
    return out


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_logits(p: dict, x: torch.Tensor, tie: bool) -> torch.Tensor:
    return mm(x, p["tok"].t() if tie else p["lm_head"])


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NLL in f32 over (..., V) logits and (...) integer labels; with
    ``mask`` (nonzero = counted) the masked mean, its denominator at
    least 1. Plain PyTorch, as the reference leaves it to XLA."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) \
        - lf.gather(-1, labels.long()[..., None])[..., 0]
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
