"""Attention: GQA prefill against the slot cache (chunked and packed),
flash-decode serving, the int8 KV cache, and whisper's cross attention.

Counterpart of ``repro/models/attention.py``, with its layouts: q is
(B, H, S, hd), a cache leaf (B, KH, L, hd), an int8 cache's scales
(B, KH, L). Prefill attention goes through the flash kernel (every chunk
shape, ragged ones included; packed rows through its segmented mode;
whisper's encoder and the full-sequence cross attention through its
non-causal mode) and decode attention through the decode kernel (the
cross attention at every encoder position too); the decode step's
projections go through the GEMV kernel. Decode takes the reference's two
layouts: A, the heads whole on each rank, and, under a mesh whose 'model'
extent does not divide the KV heads, B: each rank holds the positions
[shard S/m, (shard + 1) S/m) of the cache, the decode kernel's partial
mode gives the shard's attention and log-sum-exp, and one all-gather over
'model' combines them. A prefill chunk writes the positions its rank owns
and all-gathers the prefix it reads (the reference leaves that gather to
GSPMD). An int8 cache is
dequantized to bf16 in plain PyTorch before the kernels, as the reference
does it outside its kernels.

Tensor parallelism: with the query heads split over 'model' (a rank's
weights in any family; ``layers.tp_mesh`` reads it off ``wq``), a
rank projects its heads, and its KV heads where m divides them (layout
A), attends them, and the row-parallel ``wo`` ends in the psum. Layout B
is decided from the model's KV heads, not the local cache's: its KV
weights stay whole, and in decode the local query heads are all-gathered
before the partial mode (the reference's ``shard_map`` sees every query
head), the rank's heads taken back from the combined output before
``wo``. Whisper's cross attention splits the same way: its queries,
``encoder_kv``'s keys and values and the cross cache are the rank's
heads, and its ``wo`` ends in the psum.

The reference is functional; the port writes K/V into the cache tensors in
place (an update returns the same tensors it was given), which saves a copy
of the cache per layer and step. No cache write reads a device value on the
host: masked writes go through ``torch.where`` over a fixed index set, never
through boolean indexing, ``nonzero`` or ``item``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import apply_rope, mm, tp_mesh
from repro_torch.models.params import ParamDef
from repro_torch.sharding import comm
from repro_torch.sharding.axes import (_current_mesh, active_rules,
                                       model_extent)


def attn_defs(cfg: ModelConfig, stacked: Optional[int] = None,
              cross: bool = False) -> dict:
    """The projections of a self-attention (or, ``cross=True``, a
    cross-attention: the same leaves) block."""
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


def _heads_mesh(cfg: ModelConfig, p: dict):
    """The mesh when this rank holds a share of the query heads, else
    None."""
    return tp_mesh(p["wq"].shape[-2], cfg.num_heads)


def qkv_project(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: Optional[torch.Tensor], rope: bool = True):
    """x: (B, S, d) -> q (B, H, S, hd), k/v (B, KH, S, hd) at the local
    head counts; GEMM path."""
    d = x.shape[-1]
    x = comm.copy_to_model(x, _heads_mesh(cfg, p))
    q = _heads(mm(x, p["wq"].reshape(d, -1)), p["wq"].shape[1])
    k = _heads(mm(x, p["wk"].reshape(d, -1)), p["wk"].shape[1])
    v = _heads(mm(x, p["wv"].reshape(d, -1)), p["wv"].shape[1])
    if rope and positions is not None:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def out_project(p: dict, attn_out: torch.Tensor,
                cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """attn_out: (B, H, S, hd) -> (B, S, d); GEMM path (with ``cfg``, a
    rank's share of the heads: the row-parallel product, then the
    psum)."""
    B, H, S, hd = attn_out.shape
    merged = attn_out.permute(0, 2, 1, 3).reshape(B, S, H * hd)
    out = mm(merged, p["wo"].reshape(H * hd, -1))
    if cfg is None:
        return out
    return comm.reduce_from_model(out, _heads_mesh(cfg, p))


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, chunk_q: int, chunk_kv: int,
                        q_offset: int = 0, segment_info=None) -> torch.Tensor:
    """The reference's blocked online-softmax attention (its XLA path), in
    plain PyTorch: q (B, H, Sq, hd) at global positions
    [q_offset, q_offset + Sq) against k, v (B, KH, Skv, hd). Blocks are the
    largest divisors of Sq and Skv not above the chunk sizes.
    ``segment_info`` = (q_pos (B, Sq), q_seg (B, Sq), kv_pos (B, Skv),
    kv_seg (B, Skv)) replaces the static mask with the packed-prefill rule:
    attend iff segments match and q_pos >= kv_pos."""
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
        if segment_info is not None:
            qp = segment_info[0][:, qi * cq:(qi + 1) * cq]          # (B, cq)
            qs = segment_info[1][:, qi * cq:(qi + 1) * cq]
        o = torch.zeros((B, KH, G, cq, hd), dtype=torch.float32,
                        device=q.device)
        m = torch.full((B, KH, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KH, G, cq), dtype=torch.float32, device=q.device)
        for ki in range(Skv // ckv):
            kb = k[:, :, ki * ckv:(ki + 1) * ckv].float()
            vb = v[:, :, ki * ckv:(ki + 1) * ckv].float()
            s = torch.einsum("bkgqh,bkch->bkgqc", qb, kb)
            if segment_info is not None:
                kp = segment_info[2][:, ki * ckv:(ki + 1) * ckv]    # (B, ckv)
                ks = segment_info[3][:, ki * ckv:(ki + 1) * ckv]
                mask = ((qs[:, :, None] == ks[:, None, :])
                        & (qp[:, :, None] >= kp[:, None, :]))     # (B, cq, ckv)
                s = torch.where(mask[:, None, None], s,
                                torch.full_like(s, NEG_INF))
            elif causal:
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


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, chunk_q: int,
                          chunk_kv: int) -> torch.Tensor:
    """The reference's ``flash_attention_fused``: flash attention whose
    backward recomputes the score blocks from (q, k, v, o, lse) instead of
    saving them (``ops.FlashAttentionFn``: the flash kernel and its
    backward kernel on the card, the plain versions on the CPU). The chunk
    sizes block the reference's XLA loops; the kernels tile themselves,
    so they take no part here."""
    del chunk_q, chunk_kv
    return ops.flash_attention(q, k, v, causal=causal)


def attention_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, *,
                      causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (``forward_full``; ``causal=False`` in
    whisper's encoder): x (B, S, d) at ``positions`` (B, S) -> (B, S, d),
    through the flash kernel's static mode (the reference's
    ``flash_attention_xla`` on this path). Under a gradient it runs through
    ``flash_attention_fused``: ``cfg.flash_vjp`` chooses, in the
    reference, between autodiff through its blocked loops and that
    recomputing backward; the port's backward is always the recomputing
    one, so both values take one path."""
    q, k, v = qkv_project(cfg, p, x, positions)
    o = flash_attention_fused(q, k, v, causal, cfg.chunk_q, cfg.chunk_kv)
    return out_project(p, o, cfg)


# --------------------------------------------------------------------------- #
# Batched serving prefill: a whole prompt chunk against the slot cache
# --------------------------------------------------------------------------- #
def _write_span(cache: torch.Tensor, new: torch.Tensor,
                tok_valid: torch.Tensor, offset: int) -> None:
    """cache (B, KH, L, ...) <- new (B, KH, C, ...) at positions
    [offset, offset + C) of every row, in place, where ``tok_valid`` (B, C)
    holds and the position lies in the cache. ``offset`` is relative to the
    cache's first position and may be negative (a layout-B shard holds a
    chunk's tail only)."""
    j0, j1 = max(0, -offset), min(new.shape[2], cache.shape[2] - offset)
    if j1 <= j0:
        return
    keep = tok_valid[:, None, j0:j1].reshape(
        (new.shape[0], 1, j1 - j0) + (1,) * (new.dim() - 3))
    region = cache[:, :, offset + j0:offset + j1]
    region.copy_(torch.where(keep, new[:, :, j0:j1].to(cache.dtype), region))


def write_kv_chunk(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   tok_valid: torch.Tensor, offset: int):
    """Write a chunk's K/V into the slot cache, in place.

    k_new/v_new: (B, KH, C, hd); token j of row b lands at cache position
    offset + j. Invalid tokens (``tok_valid`` False) and positions past the
    cache end are not written, as the reference's sentinel-position
    ``mode="drop"`` scatter drops them: the chunk's rows [offset, offset+C)
    are a contiguous span, so the mask is applied on that span directly."""
    _write_span(k_cache, k_new, tok_valid, offset)
    _write_span(v_cache, v_new, tok_valid, offset)
    return k_cache, v_cache


def _write_scale_chunk(scale_cache: torch.Tensor, scale_new: torch.Tensor,
                       tok_valid: torch.Tensor, offset: int) -> torch.Tensor:
    """scale_cache: (B, KH, L); scale_new: (B, KH, C); in place."""
    _write_span(scale_cache, scale_new, tok_valid, offset)
    return scale_cache


def _dequantize(q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 K or V (..., hd) times its per-position scale (...), in bf16
    whatever the model's dtype, as the reference computes it."""
    return q8.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def attention_prefill_cached(cfg: ModelConfig, p: dict, x: torch.Tensor,
                             cache: dict, tok_valid: torch.Tensor,
                             offset: int):
    """One prefill chunk against the slot cache. x: (B, C, d) at global
    positions [offset, offset + C). Writes the chunk's K/V into the cache
    (quantized, with its scales, for the int8 cache) and attends causally
    over cache[:offset + C] through the flash kernel. Returns
    (out (B, C, d), cache). Padding rows give finite garbage that callers
    discard; their cache writes are dropped."""
    B, C, _ = x.shape
    positions = offset + torch.arange(C, device=x.device)[None].expand(B, C)
    q, k_new, v_new = qkv_project(cfg, p, x, positions)
    new_cache = {}
    mesh, first = _seq_shard(cfg, cache["k"])
    if mesh is not None and cfg.kv_dtype == "int8":
        raise NotImplementedError(
            "the int8 cache is not sequence-sharded (layout B) in the port")
    if cfg.kv_dtype == "int8":
        kq, ks = _quantize_kv(k_new)                 # scales (B, KH, C)
        vq, vs = _quantize_kv(v_new)
        k_cache, v_cache = write_kv_chunk(cache["k"], cache["v"], kq, vq,
                                          tok_valid, offset)
        k_sc = _write_scale_chunk(cache["k_scale"], ks, tok_valid, offset)
        v_sc = _write_scale_chunk(cache["v_scale"], vs, tok_valid, offset)
        new_cache.update(k_scale=k_sc, v_scale=v_sc)
    else:
        k_cache, v_cache = write_kv_chunk(cache["k"], cache["v"], k_new, v_new,
                                          tok_valid, offset - first)
    if mesh is None:
        span = min(offset + C, k_cache.shape[2])
        k_att, v_att = k_cache[:, :, :span], v_cache[:, :, :span]
    else:
        k_att, v_att = _gather_prefix(k_cache, v_cache, offset + C, mesh)
    if cfg.kv_dtype == "int8":
        k_att = _dequantize(k_att, k_sc[:, :, :span])
        v_att = _dequantize(v_att, v_sc[:, :, :span])
    o = ops.flash_attention(q, k_att, v_att, causal=True, q_offset=offset)
    new_cache.update(k=k_cache, v=v_cache)
    return out_project(p, o, cfg), new_cache


# --------------------------------------------------------------------------- #
# Packed serving prefill: one chunk ROW carries several prompts (or the tail
# of a long one) -- per-token (slot, position) K/V scatter, per-row cache
# prefix gather, segment-masked flash attention
# --------------------------------------------------------------------------- #
def _scatter_packed(cache: torch.Tensor, new: torch.Tensor,
                    seg_slot: torch.Tensor, seg_pos: torch.Tensor,
                    tok_valid: torch.Tensor) -> None:
    """cache (B, KH, L, ...) <- new (R, KH, C, ...) at cache row
    ``seg_slot[r, j]``, position ``seg_pos[r, j]``, in place, for valid
    tokens only, without a host sync.

    The reference drops an invalid token's write (``mode="drop"``); here it
    goes to (slot 0, position L-1) and writes that cell's own current value
    back. No valid prefill token targets position L-1 (a prompt holds at
    most max_len-1 tokens, so its cached prefix ends at L-3), and every
    duplicate write to that cell carries the same value, so the result is
    the reference's exactly."""
    L = cache.shape[2]
    slot = torch.where(tok_valid, seg_slot, 0).long()
    pos = torch.where(tok_valid, seg_pos, L - 1).long()
    keep = tok_valid.reshape(tok_valid.shape + (1,) * (new.dim() - 2))
    old = cache[slot, :, pos]                     # (R, C, KH, ...)
    cache[slot, :, pos] = torch.where(keep, new.transpose(1, 2).to(cache.dtype),
                                      old)


def write_kv_packed(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    seg_slot: torch.Tensor, seg_pos: torch.Tensor,
                    tok_valid: torch.Tensor):
    """Scatter a PACKED chunk's K/V into the slot cache, in place.

    k_new/v_new: (R, KH, C, hd); token j of lane r lands at cache row
    ``seg_slot[r, j]``, position ``seg_pos[r, j]`` (the lane count R is
    decoupled from the cache's slot count). Invalid tokens (padding between
    packed segments) are not written. The packing planner covers every
    prompt position once, so no two valid tokens of one dispatch share a
    cell; valid positions lie below L-1 (see ``_scatter_packed``)."""
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        _scatter_packed(cache, new, seg_slot, seg_pos, tok_valid)
    return k_cache, v_cache


def _write_scale_packed(scale_cache: torch.Tensor, scale_new: torch.Tensor,
                        seg_slot: torch.Tensor, seg_pos: torch.Tensor,
                        tok_valid: torch.Tensor) -> torch.Tensor:
    """scale_cache: (B, KH, L); scale_new: (R, KH, C); in place."""
    _scatter_packed(scale_cache, scale_new, seg_slot, seg_pos, tok_valid)
    return scale_cache


def packed_segment_info(seg_pos: torch.Tensor, seg_ids: torch.Tensor,
                        tok_valid: torch.Tensor, prefix_len: torch.Tensor,
                        span: int):
    """The (q_pos, q_seg, kv_pos, kv_seg) arrays of a packed dispatch whose
    keys are [a prefix of ``span`` cache positions ; the chunk]: padded
    queries get segment -2 (they match no key), padded chunk keys -1, and
    prefix positions at or past a lane's ``prefix_len`` -1, so a
    continuation segment (id 0) sees exactly its cached prefix."""
    R = seg_pos.shape[0]
    q_seg = torch.where(tok_valid, seg_ids, -2)
    kv_seg = torch.where(tok_valid, seg_ids, -1)
    kv_pos = seg_pos
    if span > 0:
        pref_pos = torch.arange(span, dtype=seg_pos.dtype,
                                device=seg_pos.device)[None].expand(R, span)
        pref_seg = torch.where(pref_pos < prefix_len[:, None], 0, -1
                               ).to(seg_ids.dtype)
        kv_pos = torch.cat([pref_pos, seg_pos], dim=1)
        kv_seg = torch.cat([pref_seg, kv_seg], dim=1)
    return seg_pos, q_seg, kv_pos, kv_seg


def attention_prefill_packed(cfg: ModelConfig, p: dict, x: torch.Tensor,
                             cache: dict, seg_slot: torch.Tensor,
                             seg_pos: torch.Tensor, seg_ids: torch.Tensor,
                             tok_valid: torch.Tensor, row_slot: torch.Tensor,
                             prefix_len: torch.Tensor, *, prefix_span: int):
    """One PACKED prefill chunk against the slot cache.

    x: (R, C, d); lane r carries one or more prompt segments laid out by the
    packing planner (``sched/packing.py``): ``seg_slot``/``seg_pos`` (R, C)
    give each token's target cache row and global position, ``seg_ids``
    (R, C) its within-lane segment id (0: the lane's continuation segment,
    the tail of a prompt whose earlier chunks are cached; >= 1: whole
    prompts; -1: padding). ``row_slot``/``prefix_len`` (R,) name the cache
    row and true extent of the lane's continuation prefix; ``prefix_span``
    (a chunk multiple, a host int) is the padded prefix length.

    K/V scatter to (seg_slot, seg_pos) first; then attention runs over
    [the gathered prefix rows ; the chunk's K/V] under the segment mask,
    through the flash kernel's segmented mode. Padding rows give finite
    garbage that callers discard; their cache writes are dropped. Returns
    (out (R, C, d), cache)."""
    if _seq_shard(cfg, cache["k"])[0] is not None:
        raise NotImplementedError(
            "packed prefill does not write a sequence-sharded cache "
            "(layout B) in the port")
    q, k_new, v_new = qkv_project(cfg, p, x, seg_pos)
    new_cache = {}
    if cfg.kv_dtype == "int8":
        kq, ks = _quantize_kv(k_new)                        # scales (R, KH, C)
        vq, vs = _quantize_kv(v_new)
        k_cache, v_cache = write_kv_packed(cache["k"], cache["v"], kq, vq,
                                           seg_slot, seg_pos, tok_valid)
        k_sc = _write_scale_packed(cache["k_scale"], ks, seg_slot, seg_pos,
                                   tok_valid)
        v_sc = _write_scale_packed(cache["v_scale"], vs, seg_slot, seg_pos,
                                   tok_valid)
        new_cache.update(k_scale=k_sc, v_scale=v_sc)
        # the chunk attends its own K/V through the same int8 round trip
        # the cache stores
        k_att, v_att = _dequantize(kq, ks), _dequantize(vq, vs)
    else:
        k_cache, v_cache = write_kv_packed(cache["k"], cache["v"], k_new,
                                           v_new, seg_slot, seg_pos,
                                           tok_valid)
        k_att, v_att = k_new, v_new
    new_cache.update(k=k_cache, v=v_cache)

    span = min(prefix_span, k_cache.shape[2]) if prefix_span > 0 else 0
    if span > 0:
        # each lane's continuation prefix, gathered from its cache row after
        # the scatter (a later lane may read what an earlier lane of this
        # dispatch just wrote); the mask trims it to prefix_len
        k_pref = k_cache[:, :, :span].index_select(0, row_slot.long())
        v_pref = v_cache[:, :, :span].index_select(0, row_slot.long())
        if cfg.kv_dtype == "int8":
            k_pref = _dequantize(k_pref, k_sc[:, :, :span].index_select(
                0, row_slot.long()))
            v_pref = _dequantize(v_pref, v_sc[:, :, :span].index_select(
                0, row_slot.long()))
        k_att = torch.cat([k_pref.to(k_att.dtype), k_att], dim=2)
        v_att = torch.cat([v_pref.to(v_att.dtype), v_att], dim=2)
    info = packed_segment_info(seg_pos, seg_ids, tok_valid, prefix_len, span)
    o = ops.flash_attention(q, k_att, v_att, segment_info=info)
    return out_project(p, o, cfg), new_cache


# --------------------------------------------------------------------------- #
# Cross attention (whisper's decoder)
# --------------------------------------------------------------------------- #
def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    enc_kv) -> torch.Tensor:
    """x: (B, S, d) decoder states against ``enc_kv`` = (k, v), each
    (B, KH, S_enc, hd): q projected without RoPE, every encoder position
    attended, no mask, through the flash kernel's non-causal static mode
    (Sq = S, Skv = S_enc). A tensor-parallel rank projects and attends
    its heads; ``wo`` ends in the psum. -> (B, S, d)."""
    d = x.shape[-1]
    x = comm.copy_to_model(x, _heads_mesh(cfg, p))
    q = _heads(mm(x, p["wq"].reshape(d, -1)), p["wq"].shape[1])
    k, v = enc_kv
    return out_project(p, ops.flash_attention(q, k, v, causal=False), cfg)


def cross_attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                           enc_kv) -> torch.Tensor:
    """``cross_attention`` for one decode token a row: x (B, 1, d) against
    a layer's view of the cross cache ``enc_kv`` = (ck, cv), each
    (B, KH, S_enc, hd) (a tensor-parallel rank's KV heads). The q and out
    projections run as GEMVs over the B rows, at the rank's heads, and the
    attention through the decode kernel with every length S_enc; ``wo``
    ends in the psum. -> (B, 1, d)."""
    B, _, d = x.shape
    ck, cv = enc_kv
    H, hd = p["wq"].shape[-2], cfg.head_dim
    q = _project_rows(p, x.reshape(B, d), "wq").reshape(B, H, hd)
    lengths = torch.full((B,), ck.shape[2], dtype=torch.int32,
                         device=x.device)
    o = ops.decode_attention(q, ck, cv, lengths)
    wo = p["wo"]
    out = ops.fused_matvec(o.reshape(B, H * hd), wo.reshape(H * hd, -1))
    return comm.reduce_from_model(out, _heads_mesh(cfg, p)).reshape(B, 1, -1)


def encoder_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor):
    """The cross-attention keys and values of encoder states enc_out
    (B, S_enc, d): each (B, KH, S_enc, hd), plain products (a
    tensor-parallel rank's KV heads: the column-parallel products' input
    takes the conjugate copy)."""
    d = enc_out.shape[-1]
    enc_out = comm.copy_to_model(enc_out, _heads_mesh(cfg, p))
    k = _heads(mm(enc_out, p["wk"].reshape(d, -1)), p["wk"].shape[1])
    v = _heads(mm(enc_out, p["wv"].reshape(d, -1)), p["wv"].shape[1])
    return k, v


# --------------------------------------------------------------------------- #
# Decode (generation stage): one token against the KV cache
# --------------------------------------------------------------------------- #
def _seq_shard(cfg: ModelConfig, k_cache: torch.Tensor, mesh=None):
    """(the mesh, the shard's first global position) when ``k_cache`` (B,
    KH, S_loc, hd) is a layout-B shard: under a mesh whose 'model' extent
    m > 1 does not divide the model's KV heads (``cfg.num_kv_heads``: a
    layout-A rank may hold fewer than m of them, one at KH = m) and whose
    rules put the cache's sequence on 'model'; else (None, 0)."""
    mesh = mesh or _current_mesh()
    m = model_extent(mesh)
    if m == 1 or cfg.num_kv_heads % m == 0 \
            or "model" not in active_rules().get("kv_seq", ()):
        return None, 0
    return mesh, comm.axis_index(mesh, "model") * k_cache.shape[2]


def _gather_prefix(k_cache: torch.Tensor, v_cache: torch.Tensor, end: int,
                   mesh):
    """Positions [0, min(end, S)) of a layout-B cache, all-gathered over
    'model' in one collective: each rank sends the same number of its
    first positions, the fewest that cover the span."""
    S_loc = k_cache.shape[2]
    span = min(end, S_loc * model_extent(mesh))
    n = min(S_loc, span)
    parts = comm.gather_parts(torch.stack([k_cache[:, :, :n],
                                           v_cache[:, :, :n]]), mesh, "model")
    kv = torch.cat([part[:, :, :, :min(n, span - r * S_loc)]
                    for r, part in enumerate(parts) if span > r * S_loc],
                   dim=3)
    return kv[0], kv[1]


def decode_attention(cfg: ModelConfig, q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor,
                     mesh=None) -> torch.Tensor:
    """q: (B, H, 1, hd); caches (B, KH, S, hd) valid on [0, cur_len), or
    this rank's shard of them in layout B (``_seq_shard``): its partial
    through the decode kernel's partial mode, then the combine over
    'model' -- one all-gather of every rank's (o, lse), merged on each rank
    in rank order (global max, rescaled sums, then the divide), so every
    rank gets the same bits. An empty shard (lse = -inf) adds nothing."""
    B, H, _, hd = q.shape
    mesh, first = _seq_shard(cfg, k_cache, mesh)
    if mesh is None:
        o = ops.decode_attention(q.reshape(B, H, hd), k_cache, v_cache,
                                 cur_len)
        return o.reshape(B, H, 1, hd)
    S_loc = k_cache.shape[2]
    lengths = torch.clamp(cur_len - first, 0, S_loc)
    o, lse = ops.decode_attention(q.reshape(B, H, hd), k_cache, v_cache,
                                  lengths, return_lse=True)
    parts = comm.gather_parts(torch.cat([o.float(), lse[..., None]], -1),
                              mesh, "model")
    return merge_decode(parts).to(q.dtype).reshape(B, H, 1, hd)


def merge_decode(parts) -> torch.Tensor:
    """The ranks' partial decode outputs (..., hd + 1), o then its
    log-sum-exp, in rank order, merged to (..., hd) float32: the largest
    lse, the outputs rescaled to it and summed, then the divide. An empty
    shard (lse -inf) adds nothing."""
    hd = parts[0].shape[-1] - 1
    lses = [part[..., hd] for part in parts]
    top = lses[0]
    for x in lses[1:]:
        top = torch.maximum(top, x)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    num, den = 0.0, 0.0
    for part, x in zip(parts, lses):
        w = torch.exp(x - top)
        num = num + w[..., None] * part[..., :hd]
        den = den + w
    return num / torch.clamp(den, min=1e-30)[..., None]


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


def _quantize_kv(x: torch.Tensor):
    """x: (B, KH, S, hd) -> (int8 (B, KH, S, hd), scale (B, KH, S) f32):
    symmetric per-position scale amax/127 (floored at 1e-8), rounding half
    to even, clamped to +-127, as the reference quantizes."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q8 = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q8.to(torch.int8), scale


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache: dict, cur_len: torch.Tensor):
    """One decode step. x: (B, 1, d); cache {"k", "v"} (B, KH, S_max, hd)
    (+ "k_scale"/"v_scale" (B, KH, S_max) for the int8 cache). The
    projections run as GEMVs over the B slot rows. Returns
    (out (B, 1, d), cache)."""
    B, _, d = x.shape
    rows = x.reshape(B, d)
    # the local head counts: a tensor-parallel rank's share
    H, KH, hd = p["wq"].shape[-2], p["wk"].shape[-2], cfg.head_dim
    heads = _heads_mesh(cfg, p)
    positions = cur_len[:, None]                                  # (B, 1)
    # a layout-B shard writes the positions it owns
    seq_mesh, first = _seq_shard(cfg, cache["k"])
    at = cur_len - first if first else cur_len
    q = apply_rope(_project_rows(p, rows, "wq").reshape(B, H, 1, hd),
                   positions[:, None, :], cfg.rope_theta)
    k_new = apply_rope(_project_rows(p, rows, "wk").reshape(B, KH, 1, hd),
                       positions[:, None, :], cfg.rope_theta)
    v_new = _project_rows(p, rows, "wv").reshape(B, KH, 1, hd)
    new_cache = {}
    if cfg.kv_dtype == "int8":
        # quantize the inserted token; the whole cache dequantizes to bf16
        # before the decode kernel
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        k_cache, v_cache = update_kv_cache(cache["k"], cache["v"], kq, vq,
                                           at, method=cfg.kv_update)
        k_sc, v_sc = update_kv_cache(
            cache["k_scale"][..., None], cache["v_scale"][..., None],
            ks[..., None], vs[..., None], at, method=cfg.kv_update)
        k_sc, v_sc = k_sc[..., 0], v_sc[..., 0]
        new_cache.update(k_scale=k_sc, v_scale=v_sc)
        k_att, v_att = _dequantize(k_cache, k_sc), _dequantize(v_cache, v_sc)
    else:
        k_cache, v_cache = update_kv_cache(cache["k"], cache["v"], k_new,
                                           v_new, at, method=cfg.kv_update)
        k_att, v_att = k_cache, v_cache
    gather = seq_mesh is not None and heads is not None
    if gather:
        # layout B's partial mode takes every query head
        q = comm.all_gather(q, heads, "model", dim=1)
    o = decode_attention(cfg, q, k_att, v_att, cur_len + 1)
    if gather:
        o = o.narrow(1, comm.axis_index(heads, "model") * H, H)
    wo = p["wo"]
    out = ops.fused_matvec(o.reshape(B, H * hd), wo.reshape(H * hd, -1))
    new_cache.update(k=k_cache, v=v_cache)
    return comm.reduce_from_model(out, heads).reshape(B, 1, -1), new_cache
