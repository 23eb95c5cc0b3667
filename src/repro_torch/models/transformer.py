"""The model of the port: parameter and cache trees, the one-token decode
step, the full-sequence forward, batched chunked prefill, and the one-call
decode + sample + terminate step.

Counterpart of ``repro/models/transformer.py`` for the ``dense``, ``ssm``
(RWKV6) and ``hybrid`` (Jamba: Mamba and attention mixers, dense and MoE
FFNs) families; ``vlm``, ``encdec`` and ``moe`` raise
``NotImplementedError``. The trees keep the reference's superblock nesting:
parameters of position j of the superblock stacked with a leading axis of
n_super = n_layers / period under ``blocks/pos{j}`` (dense and ssm stacks
have period 1, so ``pos0``; jamba's is 8, its ``.reduced()`` 2). The cache
of an attention position is ``{k, v}`` of shape (n_super, B, KH, L, hd),
plus ``{k_scale, v_scale}`` (n_super, B, KH, L) for the int8 cache; of an
RWKV position ``wkv`` (n_super, B, H, hd, hd) f32 and ``{shift_tm,
shift_cm}`` (n_super, B, d) in ``cfg.dtype``; of a Mamba position ``conv``
(n_super, B, cw - 1, d_inner) in ``cfg.dtype`` and ``ssm`` (n_super, B,
d_inner, d_state) f32. The reference's ``lax.scan`` over superblocks is a
Python loop over the leading index of the stacked tensors; cache updates
land in place in the stacked cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.params import ParamDef

_UNPORTED = {"moe": "the moe family's serving (its batched and packed "
                    "prefill through MoE), ROADMAP queue 1 item 11",
             "encdec": "ROADMAP queue 1 item 12",
             "vlm": "ROADMAP queue 1 item 12"}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"the port serves the dense, ssm and hybrid families; "
            f"{cfg.family!r} stacks are "
            f"{_UNPORTED.get(cfg.family, 'not ported')}")


# --------------------------------------------------------------------------- #
# superblock structure
# --------------------------------------------------------------------------- #
def superblock_period(cfg: ModelConfig) -> int:
    kinds = list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and kinds == kinds[:p] * (n // p):
            return p
    return n


def _position_kinds(cfg: ModelConfig):
    p = superblock_period(cfg)
    return list(zip(cfg.layer_kinds()[:p], cfg.ffn_kinds()[:p]))


# --------------------------------------------------------------------------- #
# parameter and cache defs
# --------------------------------------------------------------------------- #
def _block_defs(cfg: ModelConfig, mixer: str, ffn: str, n_super: int
                ) -> dict:
    d = {"norm1": L.norm_defs(cfg, stacked=n_super),
         "norm2": L.norm_defs(cfg, stacked=n_super)}
    if mixer == "rwkv":
        # time mix (mixer) + channel mix (its own FFN); norm2 separates them
        d["rwkv"] = S.rwkv_defs(cfg, stacked=n_super)
        return d
    d[mixer] = (A.attn_defs(cfg, stacked=n_super) if mixer == "attn"
                else S.mamba_defs(cfg, stacked=n_super))
    d["ffn"] = (M.moe_defs(cfg, stacked=n_super) if ffn == "moe"
                else L.mlp_defs(cfg, stacked=n_super))
    return d


def param_defs(cfg: ModelConfig) -> dict:
    _require_ported(cfg)
    n_super = cfg.num_layers // superblock_period(cfg)
    return {
        "embed": L.embed_defs(cfg),
        "blocks": {f"pos{j}": _block_defs(cfg, mixer, ffn, n_super)
                   for j, (mixer, ffn) in enumerate(_position_kinds(cfg))},
        "final_norm": L.norm_defs(cfg),
    }


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Decode-time state. Attention: one K and V slot cache per layer,
    stacked, in ``cfg.dtype``; with ``kv_dtype="int8"`` the K/V are int8
    and each (slot, head, position) carries a float32 scale. RWKV: the wkv
    state in float32 and the two token-shift carries in ``cfg.dtype``.
    Mamba: the conv history in ``cfg.dtype`` and the ssm state in
    float32."""
    _require_ported(cfg)
    n_super = cfg.num_layers // superblock_period(cfg)
    out = {}
    for j, (mixer, _ffn) in enumerate(_position_kinds(cfg)):
        if mixer == "attn":
            shape = (n_super, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
            axes = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
            kv_dt = "int8" if cfg.kv_dtype == "int8" else cfg.dtype
            c = {"k": ParamDef(shape, axes, "zeros", dtype=kv_dt),
                 "v": ParamDef(shape, axes, "zeros", dtype=kv_dt)}
            if cfg.kv_dtype == "int8":
                s_shape, s_axes = shape[:-1], axes[:-1]
                c["k_scale"] = ParamDef(s_shape, s_axes, "zeros",
                                        dtype="float32")
                c["v_scale"] = ParamDef(s_shape, s_axes, "zeros",
                                        dtype="float32")
        elif mixer == "mamba":
            c = {"conv": ParamDef((n_super, batch, cfg.ssm_conv - 1,
                                   cfg.d_inner),
                                  ("layers", "batch", None, "d_inner"),
                                  "zeros", dtype=cfg.dtype),
                 "ssm": ParamDef((n_super, batch, cfg.d_inner,
                                  cfg.ssm_d_state),
                                 ("layers", "batch", "d_inner", "d_state"),
                                 "zeros", dtype="float32")}
        else:
            hd = cfg.rwkv_head_dim
            shift = ParamDef((n_super, batch, cfg.d_model),
                             ("layers", "batch", "d_model"), "zeros",
                             dtype=cfg.dtype)
            c = {"wkv": ParamDef((n_super, batch, cfg.num_heads, hd, hd),
                                 ("layers", "batch", "rwkv_heads",
                                  "head_dim", None), "zeros",
                                 dtype="float32"),
                 "shift_tm": shift, "shift_cm": shift}
        out[f"pos{j}"] = c
    return out


def _layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked tree (views, so writes reach the stack)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """Attention-mixer stacks only: an RWKV or Mamba prompt needs its state
    threaded token by token, so the engine prefills it sequentially."""
    return (cfg.family != "encdec"
            and all(k == "attn" for k in cfg.layer_kinds()))


# --------------------------------------------------------------------------- #
# layer application
# --------------------------------------------------------------------------- #
def _apply_ffn(cfg: ModelConfig, ffn: str, p: dict, h: torch.Tensor,
               gemv: bool):
    """The block's FFN on h (B, S, d): MoE, or the dense MLP (through the
    GEMV kernel for decode rows). Returns (y, aux loss)."""
    if ffn == "moe":
        return M.apply_moe(cfg, p, h)
    if not gemv:
        return L.apply_mlp(cfg, p, h), None
    B, _, d = h.shape
    return L.apply_mlp_gemv(cfg, p, h.reshape(B, d)).reshape(B, 1, -1), None


def _apply_block_full(cfg: ModelConfig, kind: Tuple[str, str], p: dict,
                      x: torch.Tensor, positions: torch.Tensor):
    """Full-sequence (prefill) block from a zero state. x: (B, S, d).
    Returns (x, aux loss or None)."""
    mixer, ffn = kind
    h = L.apply_norm(cfg, p["norm1"], x)
    if mixer == "rwkv":
        y, _ = S.rwkv_time_mix(cfg, p["rwkv"], h)
        x = x + y
        h = L.apply_norm(cfg, p["norm2"], x)
        y, _ = S.rwkv_channel_mix(cfg, p["rwkv"], h)
        return x + y, None
    if mixer == "attn":
        x = x + A.attention_prefill(cfg, p["attn"], h, positions)
    else:
        x = x + S.mamba_mix(cfg, p["mamba"], h)[0]
    h = L.apply_norm(cfg, p["norm2"], x)
    y, aux = _apply_ffn(cfg, ffn, p["ffn"], h, gemv=False)
    return x + y, aux


def _apply_block_decode(cfg: ModelConfig, kind: Tuple[str, str], p: dict,
                        x: torch.Tensor, cache: dict,
                        cur_len: torch.Tensor) -> torch.Tensor:
    """One-token block. x: (B, 1, d); ``cache`` holds this layer's leaves
    as views into the stacked cache, which are updated in place."""
    mixer, ffn = kind
    h = L.apply_norm(cfg, p["norm1"], x)
    if mixer == "rwkv":
        y, st = S.rwkv_time_mix(cfg, p["rwkv"], h, state={
            "shift_tm": cache["shift_tm"], "wkv": cache["wkv"]})
        cache["shift_tm"].copy_(st["shift_tm"])
        cache["wkv"].copy_(st["wkv"])
        x = x + y
        h = L.apply_norm(cfg, p["norm2"], x)
        y, st = S.rwkv_channel_mix(cfg, p["rwkv"], h,
                                   state={"shift_cm": cache["shift_cm"]})
        cache["shift_cm"].copy_(st["shift_cm"])
        return x + y
    if mixer == "attn":
        y, _ = A.attention_decode(cfg, p["attn"], h, cache, cur_len)
    else:
        y, st = S.mamba_mix(cfg, p["mamba"], h, state={
            "conv": cache["conv"], "ssm": cache["ssm"]})
        cache["conv"].copy_(st["conv"])
        cache["ssm"].copy_(st["ssm"])
    x = x + y
    h = L.apply_norm(cfg, p["norm2"], x)
    y, _ = _apply_ffn(cfg, ffn, p["ffn"], h, gemv=True)
    return x + y


# --------------------------------------------------------------------------- #
# full-sequence forward (the serving prefill step)
# --------------------------------------------------------------------------- #
def forward_full(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                 last_only: bool = False):
    """tokens (B, S) -> (logits (B, S, V), aux loss), every layer from a
    zero state; ``last_only=True`` emits only the final position's logits
    (B, 1, V) (the serving prefill: a (B, S, V) tensor at a long S and a
    large vocab does not fit). Attention runs through the flash kernel, the
    RWKV time mix through the ``rwkv_chunk`` kernel and the Mamba scan
    through the ``mamba_chunk`` kernel. The aux loss is the sum of the MoE
    layers' balance terms (0 without MoE)."""
    _require_ported(cfg)
    x = L.embed_tokens(params["embed"], tokens)
    B, Stot = x.shape[0], x.shape[1]
    positions = torch.arange(Stot, device=x.device)[None].expand(B, Stot)
    kinds = _position_kinds(cfg)
    n_super = cfg.num_layers // len(kinds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_super):
        for j, kind in enumerate(kinds):
            x, a = _apply_block_full(cfg, kind,
                                     _layer(params["blocks"][f"pos{j}"], i),
                                     x, positions)
            if a is not None:
                aux = aux + a
    if last_only:
        x = x[:, -1:, :]
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(params["embed"], x, cfg.tie_embeddings)
    return logits, aux


# --------------------------------------------------------------------------- #
# decode step (generation stage)
# --------------------------------------------------------------------------- #
def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                cache: dict, cur_len: torch.Tensor):
    """tokens: (B, 1) int; cur_len: (B,) int32 current context lengths.
    Returns (logits (B, V), cache) with this token's K/V (or recurrent
    state) written for every row."""
    x = L.embed_tokens(params["embed"], tokens)                # (B, 1, d)
    kinds = _position_kinds(cfg)
    n_super = cfg.num_layers // len(kinds)
    for i in range(n_super):
        for j, kind in enumerate(kinds):
            x = _apply_block_decode(cfg, kind,
                                    _layer(params["blocks"][f"pos{j}"], i),
                                    x, _layer(cache[f"pos{j}"], i), cur_len)
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
    if not supports_batched_prefill(cfg) or cfg.is_moe:
        raise NotImplementedError(
            "batched prefill covers attention mixers with dense FFNs only "
            "(through MoE: ROADMAP queue 1 item 11)")
    x = L.embed_tokens(params["embed"], tokens)
    blocks, kv = params["blocks"]["pos0"], cache["pos0"]
    for i in range(cfg.num_layers):
        p = _layer(blocks, i)
        h = L.apply_norm(cfg, p["norm1"], x)
        y, _ = attend(p["attn"], h, _layer(kv, i))
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
