"""Shared building blocks: norms, RoPE, dense MLP, embeddings, loss.

Counterpart of ``repro/models/layers.py``. Products follow the reference's
dtype flow: the residual stream takes the embedding table's dtype, and a
product of two dtypes computes in their promotion (``torch.matmul`` refuses
mixed operands, so ``mm`` promotes explicitly). The decode step's FC
products go through the GEMV kernel (``apply_mlp_gemv``); prefill products
and the LM head stay plain matmuls, as the reference leaves them to XLA.

Tensor parallelism: a layer finds its weights' sharding from their local
shapes against ``cfg``'s (``tp_mesh``). A rank of any family under a mesh
whose 'model' extent m is above 1 holds 1/m of d_ff
(the MLP is column-parallel ``wi``/``wg``, row-parallel ``wo``, then the
psum) and of the vocabulary: the embedding looks up the ids in its range
and psums, the LM head gives the local columns, and the loss is the
vocabulary-parallel cross-entropy (``softmax_xent``). A vocabulary that m
does not divide (whisper-medium's 51,865) stays whole, as the rule table
leaves it, and these take their one-rank forms.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import wide
from repro_torch.models.params import ParamDef
from repro_torch.sharding import comm
from repro_torch.sharding.axes import _current_mesh, model_extent


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two (``jnp.promote_types``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def tp_mesh(local: int, full: int):
    """The current mesh when a dim of ``full`` elements is held as
    ``local`` of them, split over its 'model' axis; None when it is
    whole."""
    if local == full:
        return None
    mesh = _current_mesh()
    if local * model_extent(mesh) != full:
        raise ValueError(f"a dim of {full} held as {local} under a 'model' "
                         f"extent of {model_extent(mesh)}")
    return mesh


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
    """x: (B, S, d) -> (B, S, d); the prefill-stage (GEMM) MLP. With d_ff
    split over 'model': this rank's columns of ``wi``/``wg`` and rows of
    ``wo``, then the psum."""
    mesh = tp_mesh(p["wi"].shape[-1], cfg.d_ff)
    x = comm.copy_to_model(x, mesh)
    h = mm(x, p["wi"])
    if "wg" in p:
        h = activation(cfg, mm(x, p["wg"])) * h
    else:
        h = activation(cfg, h)
    return comm.reduce_from_model(mm(h, p["wo"]), mesh)


def apply_mlp_gemv(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (n, d) decode rows -> (n, d) through the GEMV kernel: the gated
    MLP is matvec(x, wg, act) * matvec(x, wi), then matvec(., wo) (with
    d_ff split, at the local width, then the psum)."""
    mesh = tp_mesh(p["wi"].shape[-1], cfg.d_ff)
    if "wg" in p:
        h = ops.fused_matvec(x, p["wg"], activation=cfg.act) \
            * ops.fused_matvec(x, p["wi"])
    else:
        h = ops.fused_matvec(x, p["wi"], activation=cfg.act)
    return comm.reduce_from_model(ops.fused_matvec(h, p["wo"]), mesh)


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


def vocab_shard(p: dict, vocab: int):
    """(the mesh, the rank's first vocabulary id) of an embedding tree
    whose vocabulary is split over 'model'; (None, 0) when it is whole."""
    rows = p["tok"].shape[0]
    mesh = tp_mesh(rows, vocab)
    return mesh, (0 if mesh is None else
                  comm.axis_index(mesh, "model") * rows)


def embed_tokens(p: dict, tokens: torch.Tensor,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """The rows of ``tokens``. With the vocabulary split (``vocab`` the
    whole one's size), a rank looks up the ids in its range, writes zeros
    for the others, and the psum gives every rank the rows."""
    mesh, lo = vocab_shard(p, vocab or p["tok"].shape[0])
    if mesh is None:
        return p["tok"][tokens]
    local = tokens.long() - lo
    ours = (local >= 0) & (local < p["tok"].shape[0])
    x = p["tok"][torch.where(ours, local, torch.zeros_like(local))]
    x = torch.where(ours[..., None], x, torch.zeros_like(x))
    return comm.reduce_from_model(x, mesh)


def lm_logits(p: dict, x: torch.Tensor, tie: bool,
              vocab: Optional[int] = None) -> torch.Tensor:
    """x @ the head: with the vocabulary split, this rank's columns."""
    w = p["tok"].t() if tie else p["lm_head"]
    mesh = tp_mesh(w.shape[-1], vocab or w.shape[-1])
    return mm(comm.copy_to_model(x, mesh), w)


def xent_stats(lf: torch.Tensor, labels: torch.Tensor,
               lo: int) -> torch.Tensor:
    """One vocabulary shard's part of the cross-entropy: f32 logits
    (..., V_loc) of the ids [lo, lo + V_loc) -> (..., 3): the shard's max
    (no gradient), the sum of exp(logit - that max), and the label's
    logit where the shard holds it, else 0 (the reference's iota mask)."""
    top = lf.detach().amax(dim=-1)
    sums = torch.exp(lf - top[..., None]).sum(dim=-1)
    iota = lo + torch.arange(lf.shape[-1], device=lf.device)
    hit = iota == labels.long()[..., None]
    target = torch.where(hit, lf, torch.zeros_like(lf)).sum(dim=-1)
    return torch.stack([top, sums, target], dim=-1)


def merge_xent(parts) -> torch.Tensor:
    """The NLL (...) from the shards' ``xent_stats`` in rank order: the
    largest max, the sums rescaled to it, the log-sum-exp less the label's
    logit."""
    top = parts[0][..., 0]
    for p in parts[1:]:
        top = torch.maximum(top, p[..., 0])
    total, target = 0.0, 0.0
    for p in parts:
        total = total + p[..., 1] * torch.exp(p[..., 0] - top)
        target = target + p[..., 2]
    return top + torch.log(total) - target


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, *,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Mean NLL in f32 over (..., V) logits and (...) integer labels; with
    ``mask`` (nonzero = counted) the masked mean, its denominator at
    least 1. Plain PyTorch, as the reference leaves it to XLA. Logits of a
    vocabulary split over 'model' (``vocab`` the whole one's size) take
    the vocabulary-parallel form: each rank's ``xent_stats``, one
    all-gather, ``merge_xent``."""
    lf = wide(logits)
    mesh = tp_mesh(lf.shape[-1], vocab or lf.shape[-1])
    if mesh is None:
        nll = torch.logsumexp(lf, dim=-1) \
            - lf.gather(-1, labels.long()[..., None])[..., 0]
    else:
        lo = comm.axis_index(mesh, "model") * lf.shape[-1]
        stats = xent_stats(lf, labels, lo)
        nll = merge_xent(comm.all_gather(stats[None], mesh, "model", dim=0))
    if mask is not None:
        m = mask.to(lf.dtype)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
