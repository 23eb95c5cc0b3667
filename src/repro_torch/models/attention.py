"""Attention, main-path subset: GQA prefill against the slot cache and
flash-decode serving.

Counterpart of ``repro/models/attention.py``, with its layouts: q is
(B, H, S, hd), a cache leaf (B, KH, L, hd). Prefill attention goes through
the flash kernel (every chunk shape, ragged ones included) and decode
attention through the decode kernel (layout A: heads unsharded); the
decode step's projections go through the GEMV kernel.

The reference is functional; the port writes K/V into the cache tensors in
place (an update returns the same tensors it was given), which saves a copy
of the cache per layer and step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import apply_rope, mm
from repro_torch.models.params import ParamDef


def attn_defs(cfg: ModelConfig, stacked: Optional[int] = None) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)
    return {
        "wq": ParamDef(lead + (d, h, hd), la + ("d_model", "heads", "head_dim")),
        "wk": ParamDef(lead + (d, kh, hd), la + ("d_model", "kv_heads", "head_dim")),
        "wv": ParamDef(lead + (d, kh, hd), la + ("d_model", "kv_heads", "head_dim")),
        "wo": ParamDef(lead + (h, hd, d), la + ("heads", "head_dim", "d_model")),
    }


def _heads(y: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, n*hd) -> (B, n, S, hd)."""
    B, S, _ = y.shape
    return y.reshape(B, S, n_heads, -1).permute(0, 2, 1, 3)


def qkv_project(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: Optional[torch.Tensor], rope: bool = True):
    """x: (B, S, d) -> q (B, H, S, hd), k/v (B, KH, S, hd); GEMM path."""
    d = x.shape[-1]
    q = _heads(mm(x, p["wq"].reshape(d, -1)), p["wq"].shape[1])
    k = _heads(mm(x, p["wk"].reshape(d, -1)), p["wk"].shape[1])
    v = _heads(mm(x, p["wv"].reshape(d, -1)), p["wv"].shape[1])
    if rope and positions is not None:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def out_project(p: dict, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out: (B, H, S, hd) -> (B, S, d); GEMM path."""
    B, H, S, hd = attn_out.shape
    merged = attn_out.permute(0, 2, 1, 3).reshape(B, S, H * hd)
    return mm(merged, p["wo"].reshape(H * hd, -1))


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, chunk_q: int, chunk_kv: int,
                        q_offset: int = 0) -> torch.Tensor:
    """The reference's blocked online-softmax attention (its XLA path), in
    plain PyTorch: q (B, H, Sq, hd) at global positions
    [q_offset, q_offset + Sq) against k, v (B, KH, Skv, hd). Blocks are the
    largest divisors of Sq and Skv not above the chunk sizes."""
    B, H, Sq, hd = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(hd)

    def fit(S, c):
        c = min(c, S)
        while S % c:
            c -= 1
        return c

    cq, ckv = fit(Sq, chunk_q), fit(Skv, chunk_kv)
    qg = q.reshape(B, KH, G, Sq, hd)
    blocks = []
    for qi in range(Sq // cq):
        qb = qg[:, :, :, qi * cq:(qi + 1) * cq].float() * scale
        q_pos = q_offset + qi * cq + torch.arange(cq, device=q.device)
        o = torch.zeros((B, KH, G, cq, hd), dtype=torch.float32,
                        device=q.device)
        m = torch.full((B, KH, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KH, G, cq), dtype=torch.float32, device=q.device)
        for ki in range(Skv // ckv):
            kb = k[:, :, ki * ckv:(ki + 1) * ckv].float()
            vb = v[:, :, ki * ckv:(ki + 1) * ckv].float()
            s = torch.einsum("bkgqh,bkch->bkgqc", qb, kb)
            if causal:
                kv_pos = ki * ckv + torch.arange(ckv, device=q.device)
                mask = q_pos[:, None] >= kv_pos[None, :]
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bkgqc,bkch->bkgqh", pr, vb)
            m = m_new
        blocks.append((o / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    return torch.cat(blocks, dim=3).reshape(B, H, Sq, hd)


# --------------------------------------------------------------------------- #
# Batched serving prefill: a whole prompt chunk against the slot cache
# --------------------------------------------------------------------------- #
def write_kv_chunk(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   tok_valid: torch.Tensor, offset: int):
    """Write a chunk's K/V into the slot cache, in place.

    k_new/v_new: (B, KH, C, hd); token j of row b lands at cache position
    offset + j. Invalid tokens (``tok_valid`` False) and positions past the
    cache end are not written, as the reference's sentinel-position
    ``mode="drop"`` scatter drops them: the chunk's rows [offset, offset+C)
    are a contiguous span, so the mask is applied on that span directly."""
    L = k_cache.shape[2]
    span = min(k_new.shape[2], L - offset)
    if span <= 0:
        return k_cache, v_cache
    keep = tok_valid[:, None, :span, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        region = cache[:, :, offset:offset + span]
        region.copy_(torch.where(keep, new[:, :, :span].to(cache.dtype),
                                 region))
    return k_cache, v_cache


def attention_prefill_cached(cfg: ModelConfig, p: dict, x: torch.Tensor,
                             cache: dict, tok_valid: torch.Tensor,
                             offset: int):
    """One prefill chunk against the slot cache. x: (B, C, d) at global
    positions [offset, offset + C). Writes the chunk's K/V into the cache
    and attends causally over cache[:offset + C] through the flash kernel.
    Returns (out (B, C, d), cache). Padding rows give finite garbage that
    callers discard; their cache writes are dropped."""
    B, C, _ = x.shape
    positions = offset + torch.arange(C, device=x.device)[None].expand(B, C)
    q, k_new, v_new = qkv_project(cfg, p, x, positions)
    k_cache, v_cache = write_kv_chunk(cache["k"], cache["v"], k_new, v_new,
                                      tok_valid, offset)
    span = min(offset + C, k_cache.shape[2])
    o = ops.flash_attention(q, k_cache[:, :, :span], v_cache[:, :, :span],
                            causal=True, q_offset=offset)
    return out_project(p, o), {"k": k_cache, "v": v_cache}


# --------------------------------------------------------------------------- #
# Decode (generation stage): one token against the KV cache
# --------------------------------------------------------------------------- #
def decode_attention(cfg: ModelConfig, q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, H, 1, hd); caches (B, KH, S_max, hd) valid on [0, cur_len).
    Layout A of the reference (heads unsharded): the decode kernel."""
    B, H, _, hd = q.shape
    o = ops.decode_attention(q.reshape(B, H, hd), k_cache, v_cache, cur_len)
    return o.reshape(B, H, 1, hd)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    cur_len: torch.Tensor, method: str = "onehot"):
    """Insert one token's K/V at position cur_len of every row, in place.

    k_new/v_new: (B, KH, 1, hd).
    method="onehot": cache * (1 - onehot) + onehot * new over the whole
    cache, as the reference computes it: every row gets position cur_len
    written, inactive slots included, and every cache byte is touched.
    method="scatter": one position per row; a cur_len outside [0, S) is
    dropped (the reference's ``mode="drop"``)."""
    S = k_cache.shape[2]
    if method == "scatter":
        b_idx = torch.arange(k_cache.shape[0], device=k_cache.device)
        valid = ((cur_len >= 0) & (cur_len < S))[:, None, None]
        pos = cur_len.clamp(0, S - 1)
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            old = cache[b_idx, :, pos]                          # (B, KH, hd)
            cache[b_idx, :, pos] = torch.where(
                valid, new[:, :, 0].to(cache.dtype), old)
        return k_cache, v_cache
    if method != "onehot":
        raise ValueError(f"unknown kv_update {method!r}")
    onehot = torch.arange(S, device=k_cache.device)[None, :] == cur_len[:, None]
    oh = onehot[:, None, :, None].to(k_cache.dtype)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache.mul_(1 - oh).add_(oh * new.to(cache.dtype))
    return k_cache, v_cache


def _project_rows(p: dict, x: torch.Tensor, name: str) -> torch.Tensor:
    """(B, d) rows through the GEMV kernel with w viewed as (d, heads*hd)."""
    w = p[name]
    return ops.fused_matvec(x, w.reshape(w.shape[0], -1))


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache: dict, cur_len: torch.Tensor):
    """One decode step. x: (B, 1, d); cache {"k", "v"} (B, KH, S_max, hd).
    The projections run as GEMVs over the B slot rows. Returns
    (out (B, 1, d), cache)."""
    B, _, d = x.shape
    rows = x.reshape(B, d)
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = cur_len[:, None]                                  # (B, 1)
    q = apply_rope(_project_rows(p, rows, "wq").reshape(B, H, 1, hd),
                   positions[:, None, :], cfg.rope_theta)
    k_new = apply_rope(_project_rows(p, rows, "wk").reshape(B, KH, 1, hd),
                       positions[:, None, :], cfg.rope_theta)
    v_new = _project_rows(p, rows, "wv").reshape(B, KH, 1, hd)
    k_cache, v_cache = update_kv_cache(cache["k"], cache["v"], k_new, v_new,
                                       cur_len, method=cfg.kv_update)
    o = decode_attention(cfg, q, k_cache, v_cache, cur_len + 1)
    wo = p["wo"]
    out = ops.fused_matvec(o.reshape(B, H * hd), wo.reshape(H * hd, -1))
    return out.reshape(B, 1, -1), {"k": k_cache, "v": v_cache}
