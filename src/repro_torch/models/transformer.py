"""The dense decoder of the port: parameter and cache trees, batched
chunked prefill, and the one-call decode + sample + terminate step.

Counterpart of ``repro/models/transformer.py`` for the ``dense`` family.
The trees keep the reference's nesting: parameters stacked with a leading
layer axis under ``blocks/pos0`` (a dense stack's superblock period is 1),
the cache ``pos0/{k, v}`` of shape (n_layers, B, KH, L, hd), plus
``pos0/{k_scale, v_scale}`` (n_layers, B, KH, L) for the int8 cache. The
reference's ``lax.scan`` over layers is a Python loop over the layer index
of the stacked tensors; cache updates land in place in the stacked cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port serves the dense family; {cfg.family!r} stacks are "
            f"ROADMAP queue 1 items 10-12")


def param_defs(cfg: ModelConfig) -> dict:
    _require_dense(cfg)
    n = cfg.num_layers
    return {
        "embed": L.embed_defs(cfg),
        "blocks": {"pos0": {
            "norm1": L.norm_defs(cfg, stacked=n),
            "attn": A.attn_defs(cfg, stacked=n),
            "norm2": L.norm_defs(cfg, stacked=n),
            "ffn": L.mlp_defs(cfg, stacked=n),
        }},
        "final_norm": L.norm_defs(cfg),
    }


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Decode-time state: one K and V slot cache per layer, stacked, in
    ``cfg.dtype``; with ``kv_dtype="int8"`` the K/V are int8 and each
    (slot, head, position) carries a float32 scale."""
    _require_dense(cfg)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    axes = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
    kv_dt = "int8" if cfg.kv_dtype == "int8" else cfg.dtype
    c = {"k": ParamDef(shape, axes, "zeros", dtype=kv_dt),
         "v": ParamDef(shape, axes, "zeros", dtype=kv_dt)}
    if cfg.kv_dtype == "int8":
        s_shape, s_axes = shape[:-1], axes[:-1]
        c["k_scale"] = ParamDef(s_shape, s_axes, "zeros", dtype="float32")
        c["v_scale"] = ParamDef(s_shape, s_axes, "zeros", dtype="float32")
    return {"pos0": c}


def _layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked tree (views, so writes reach the stack)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


_KV_KEYS = ("k", "v", "k_scale", "v_scale")


def _kv_layer(kv: dict, i: int) -> dict:
    """Layer i's attention cache leaves (K/V, and the int8 cache's scales),
    as views into the stacked cache."""
    return {k: kv[k][i] for k in _KV_KEYS if k in kv}


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """Attention-mixer stacks only (all the port serves)."""
    return (cfg.family != "encdec"
            and all(k == "attn" for k in cfg.layer_kinds()))


# --------------------------------------------------------------------------- #
# decode step (generation stage)
# --------------------------------------------------------------------------- #
def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                cache: dict, cur_len: torch.Tensor):
    """tokens: (B, 1) int; cur_len: (B,) int32 current context lengths.
    Returns (logits (B, V), cache) with this token's K/V written."""
    x = L.embed_tokens(params["embed"], tokens)                # (B, 1, d)
    B, _, d = x.shape
    blocks, kv = params["blocks"]["pos0"], cache["pos0"]
    for i in range(cfg.num_layers):
        p = _layer(blocks, i)
        h = L.apply_norm(cfg, p["norm1"], x)
        y, _ = A.attention_decode(cfg, p["attn"], h, _kv_layer(kv, i),
                                  cur_len)
        x = x + y
        h = L.apply_norm(cfg, p["norm2"], x)
        x = x + L.apply_mlp_gemv(cfg, p["ffn"], h.reshape(B, d)
                                 ).reshape(B, 1, -1)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(params["embed"], x, cfg.tie_embeddings)
    return logits[:, 0, :], cache


def decode_and_sample(cfg: ModelConfig, params: dict, cache: dict,
                      last_tok: torch.Tensor, lens: torch.Tensor,
                      active: torch.Tensor, gen_count: torch.Tensor,
                      max_new: torch.Tensor,
                      generator: Optional[torch.Generator], *,
                      temperature: float, eos_token: Optional[int],
                      max_len: int):
    """One generation step across all slots in one call: decode, sample,
    and the per-slot length / termination update, all on the device. The
    host's whole view of the step is the (3, B) int32 ``fetch`` = stack of
    (token, done, new length). Inactive slots are frozen: their token stays
    ``last_tok`` and their lens/gen_count do not advance. Temperature
    sampling is Gumbel-max with noise from ``generator`` (the reference's
    ``jax.random.categorical`` draws differ). Returns
    (fetch, cache, toks, lens, gen_count, generator)."""
    logits, cache = decode_step(cfg, params, last_tok[:, None], cache, lens)
    if temperature > 0:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        toks = torch.argmax(logits.float() / temperature + gumbel, dim=-1)
    else:
        toks = torch.argmax(logits, dim=-1)
    toks = torch.where(active, toks.to(torch.int32), last_tok)
    act32 = active.to(torch.int32)
    lens = lens + act32
    gen_count = gen_count + act32
    if eos_token is not None:
        eos = toks == eos_token
    else:
        eos = torch.zeros_like(active)
    done = active & (eos | (gen_count >= max_new) | (lens >= max_len - 1))
    fetch = torch.stack([toks, done.to(torch.int32), lens])
    return fetch, cache, toks, lens, gen_count, generator


# --------------------------------------------------------------------------- #
# batched prefill (summarization stage)
# --------------------------------------------------------------------------- #
def _prefill_stack(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   cache: dict, attend) -> dict:
    """Run a prompt chunk's tokens through the full stack; each layer's
    attention is ``attend(p_attn, h, layer_cache)``, which writes the
    chunk's K/V into the layer's cache. Emits no logits. Returns the
    cache."""
    x = L.embed_tokens(params["embed"], tokens)
    blocks, kv = params["blocks"]["pos0"], cache["pos0"]
    for i in range(cfg.num_layers):
        p = _layer(blocks, i)
        h = L.apply_norm(cfg, p["norm1"], x)
        y, _ = attend(p["attn"], h, _kv_layer(kv, i))
        x = x + y
        h = L.apply_norm(cfg, p["norm2"], x)
        x = x + L.apply_mlp(cfg, p["ffn"], h)
    return cache


def prefill_chunk(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  cache: dict, tok_valid: torch.Tensor, *, offset: int):
    """One batched-prefill call: tokens (B, C) at global positions
    [offset, offset + C) run through the full stack; every layer writes its
    chunk K/V into the cache (writes masked by ``tok_valid``, so only
    admitted slots' rows change). Emits no logits. Returns the cache."""
    return _prefill_stack(cfg, params, tokens, cache, lambda p, h, kv:
                          A.attention_prefill_cached(cfg, p, h, kv,
                                                     tok_valid, offset))


def prefill_chunk_packed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                         cache: dict, seg_slot: torch.Tensor,
                         seg_pos: torch.Tensor, seg_ids: torch.Tensor,
                         tok_valid: torch.Tensor, row_slot: torch.Tensor,
                         prefix_len: torch.Tensor, *, prefix_span: int):
    """One PACKED batched-prefill call: tokens (R, C), each lane carrying
    one or more prompt segments (``sched/packing.py``). The per-token
    target (seg_slot, seg_pos) drives the K/V scatter; ``seg_ids`` and the
    per-lane (row_slot, prefix_len) drive the segment mask, so a packed
    prompt attends only its own K/V. ``prefix_span`` is a host int. Emits
    no logits. Returns the cache."""
    return _prefill_stack(cfg, params, tokens, cache, lambda p, h, kv:
                          A.attention_prefill_packed(
                              cfg, p, h, kv, seg_slot, seg_pos, seg_ids,
                              tok_valid, row_slot, prefix_len,
                              prefix_span=prefix_span))
