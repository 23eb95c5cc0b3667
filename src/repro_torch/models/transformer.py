"""The model of the port: parameter and cache trees, the one-token decode
step, the full-sequence forward and the training loss (``loss_fn``;
``cfg.remat`` checkpoints its superblock loop and whisper's encoder blocks
under a gradient), whisper's encoder, batched chunked prefill, the
teacher-forced ``prefill_with_cache``, the one-call decode + sample +
terminate step, decode supersteps and fused overlapped steps.

Counterpart of ``repro/models/transformer.py`` for every family: ``dense``,
``moe`` (attention mixers, MoE FFNs), ``ssm`` (RWKV6), ``hybrid`` (Jamba:
Mamba and attention mixers, dense and MoE FFNs), ``vlm`` (pixtral: a dense
stack whose full-sequence forward takes a prefix of patch embeddings) and
``encdec`` (whisper: a bidirectional encoder over frame embeddings under
``encoder``, and decoder blocks with a cross attention, ``norm_cross`` and
``cross``, whose cache holds each layer's encoder keys and values ``ck``,
``cv`` (n_super, B, KH, encoder_seq, hd) in ``cfg.dtype``). The trees
keep the reference's superblock nesting: parameters of position j of the
superblock stacked with a leading
axis of n_super = n_layers / period under ``blocks/pos{j}`` (dense and ssm
stacks have period 1, so ``pos0``; jamba's is 8, its ``.reduced()`` 2). The
cache of an attention position is ``{k, v}`` of shape (n_super, B, KH, L,
hd), plus ``{k_scale, v_scale}`` (n_super, B, KH, L) for the int8 cache; of
an RWKV position ``wkv`` (n_super, B, H, hd, hd) f32 and ``{shift_tm,
shift_cm}`` (n_super, B, d) in ``cfg.dtype``; of a Mamba position ``conv``
(n_super, B, cw - 1, d_inner) in ``cfg.dtype`` and ``ssm`` (n_super, B,
d_inner, d_state) f32. The reference's ``lax.scan`` over superblocks is a
Python loop over the leading index of the stacked tensors; cache updates
land in place in the stacked cache.

Under tensor parallelism (a rank's resident weights in any family,
``models/params.py::resident_axes``) the layers find their shares from
their weights' shapes, and the cache holds the rank's part: an attention
position's KV heads (or, in layout B, its positions) and whisper's cross
keys and values, an RWKV position's ``wkv`` heads (the token-shift
carries whole), a Mamba position's ``d_inner`` channels. The logits are
the rank's vocabulary columns, the loss the vocabulary-parallel
cross-entropy, and sampling merges the ranks' (max, global index) in one
all-gather (``comm.sharded_argmax``), the Gumbel noise hashed from each
cell's global index; a vocabulary that 'model' does not divide stays
whole and takes the one-rank forms.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.params import ParamDef
from repro_torch.sharding import comm
from repro_torch.sharding.axes import _current_mesh, use_mesh

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
def _block_defs(cfg: ModelConfig, mixer: str, ffn: str, n_super: int,
                cross: bool = False) -> dict:
    d = {"norm1": L.norm_defs(cfg, stacked=n_super),
         "norm2": L.norm_defs(cfg, stacked=n_super)}
    if cross and mixer == "attn":
        d["norm_cross"] = L.norm_defs(cfg, stacked=n_super)
        d["cross"] = A.attn_defs(cfg, stacked=n_super, cross=True)
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
    n_super = cfg.num_layers // superblock_period(cfg)
    cross = cfg.family == "encdec"
    defs = {
        "embed": L.embed_defs(cfg),
        "blocks": {f"pos{j}": _block_defs(cfg, mixer, ffn, n_super, cross)
                   for j, (mixer, ffn) in enumerate(_position_kinds(cfg))},
        "final_norm": L.norm_defs(cfg),
    }
    if cross:
        defs["encoder"] = {
            "blocks": {"pos0": _block_defs(cfg, "attn", "dense",
                                           cfg.encoder_layers)},
            "final_norm": L.norm_defs(cfg)}
    return defs


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Decode-time state. Attention: one K and V slot cache per layer,
    stacked, in ``cfg.dtype``; with ``kv_dtype="int8"`` the K/V are int8
    and each (slot, head, position) carries a float32 scale. RWKV: the wkv
    state in float32 and the two token-shift carries in ``cfg.dtype``.
    Mamba: the conv history in ``cfg.dtype`` and the ssm state in
    float32. An encdec attention layer also holds its cross keys and
    values ``ck``/``cv`` over the ``encoder_seq`` frames, in
    ``cfg.dtype``."""
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
            if cfg.family == "encdec":
                xshape = (n_super, batch, cfg.num_kv_heads, cfg.encoder_seq,
                          cfg.head_dim)
                xaxes = ("layers", "batch", "kv_heads", None, "head_dim")
                c["ck"] = ParamDef(xshape, xaxes, "zeros", dtype=cfg.dtype)
                c["cv"] = ParamDef(xshape, xaxes, "zeros", dtype=cfg.dtype)
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


def _layers(tree: dict, n: int) -> list:
    """The n layers of a stacked tree, each leaf unbound once along its
    leading axis. The same views as ``_layer``'s, but under a gradient the
    layers' gradients meet in one stack a leaf, where indexing each layer
    would add a stack-sized gradient a layer."""
    cols = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


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
                      x: torch.Tensor, positions: torch.Tensor,
                      enc_kv=None, causal: bool = True):
    """Full-sequence (prefill) block from a zero state. x: (B, S, d);
    ``enc_kv`` (an encdec decoder block's encoder keys and values) adds
    the cross attention after the self attention; ``causal=False`` is the
    encoder's. Returns (x, aux loss or None)."""
    mixer, ffn = kind
    h = L.apply_norm(cfg, p["norm1"], x)
    if mixer == "rwkv":
        y, _ = S.rwkv_time_mix(cfg, p["rwkv"], h)
        x = x + y
        h = L.apply_norm(cfg, p["norm2"], x)
        y, _ = S.rwkv_channel_mix(cfg, p["rwkv"], h)
        return x + y, None
    if mixer == "attn":
        x = x + A.attention_prefill(cfg, p["attn"], h, positions,
                                    causal=causal)
        if enc_kv is not None:
            h = L.apply_norm(cfg, p["norm_cross"], x)
            x = x + A.cross_attention(cfg, p["cross"], h, enc_kv)
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
        if "ck" in cache:
            x = x + y
            h = L.apply_norm(cfg, p["norm_cross"], x)
            y = A.cross_attention_decode(cfg, p["cross"], h,
                                         (cache["ck"], cache["cv"]))
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
# activation checkpointing (cfg.remat), as the reference's _remat sets it
# --------------------------------------------------------------------------- #
# the matmuls whose outputs the "dots" policy saves: products without batch
# dimensions, as jax's dots_with_no_batch_dims_saveable
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """The superblock body under ``cfg.remat`` when autograd records it:
    ``"none"`` saves every activation, ``"full"`` only the superblock's
    boundaries (the body runs again in the backward), ``"dots"`` the
    matmul outputs too (``torch.utils.checkpoint``'s selective policy).
    Without a gradient the body runs as it is."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    # the recomputation runs in the backward, on autograd's device thread
    # for a CUDA tensor, where the caller's ``use_mesh`` is not set: the
    # body sets it again
    mesh = _current_mesh()

    def body(*args):
        with use_mesh(mesh):
            return fn(*args)
    return lambda *args: ckpt.checkpoint(body, *args, use_reentrant=False,
                                         **kw)


# --------------------------------------------------------------------------- #
# encoder (whisper)
# --------------------------------------------------------------------------- #
def encode(cfg: ModelConfig, params: dict,
           frame_embeds: torch.Tensor) -> torch.Tensor:
    """frame_embeds (B, S_enc, d), the stub frontend's output, taken in
    its own dtype as the reference takes it -> encoder states (B, S_enc,
    d): ``encoder_layers`` bidirectional blocks (the flash kernel's
    non-causal mode), each under ``cfg.remat`` as the reference's
    ``_loop_blocks`` runs them, and the encoder's final norm."""
    x = frame_embeds
    positions = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[0], x.shape[1])
    enc = params["encoder"]
    blocks = _layers(enc["blocks"]["pos0"], cfg.encoder_layers)

    def block(x, i):
        return _apply_block_full(cfg, ("attn", "dense"), blocks[i], x,
                                 positions, causal=False)[0]

    body = _remat(cfg, block)
    for i in range(cfg.encoder_layers):
        x = body(x, i)
    return L.apply_norm(cfg, enc["final_norm"], x)


# --------------------------------------------------------------------------- #
# full-sequence forward (the serving prefill step)
# --------------------------------------------------------------------------- #
def forward_full(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                 patch_embeds: Optional[torch.Tensor] = None,
                 frame_embeds: Optional[torch.Tensor] = None,
                 last_only: bool = False):
    """tokens (B, S) -> (logits (B, S_tot, V), aux loss), every layer from
    a zero state; ``last_only=True`` emits only the final position's logits
    (B, 1, V) (the serving prefill: a (B, S, V) tensor at a long S and a
    large vocab does not fit). A ``vlm`` stack takes ``patch_embeds``
    (B, P, d), cast to the activations' dtype and prepended, so that
    S_tot = P + S and positions run over both; an ``encdec`` stack takes
    ``frame_embeds`` (B, S_enc, d), encodes them, and each decoder layer
    attends its own keys and values of the encoder states. Attention runs
    through the flash kernel, the RWKV time mix through the ``rwkv_chunk``
    kernel and the Mamba scan through the ``mamba_chunk`` kernel. The aux
    loss is the sum of the MoE layers' balance terms (0 without MoE)."""
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError("a vlm forward takes patch_embeds")
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    enc_out = None
    if cfg.family == "encdec":
        if frame_embeds is None:
            raise ValueError("an encdec forward takes frame_embeds")
        enc_out = encode(cfg, params, frame_embeds)
    B, Stot = x.shape[0], x.shape[1]
    positions = torch.arange(Stot, device=x.device)[None].expand(B, Stot)
    kinds = _position_kinds(cfg)
    n_super = cfg.num_layers // len(kinds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stack = [_layers(params["blocks"][f"pos{j}"], n_super)
             for j in range(len(kinds))]

    def superblock(x, i):
        auxes = []
        for j, kind in enumerate(kinds):
            p = stack[j][i]
            ekv = None
            if enc_out is not None and kind[0] == "attn":
                ekv = A.encoder_kv(cfg, p["cross"], enc_out)
            x, a = _apply_block_full(cfg, kind, p, x, positions, enc_kv=ekv)
            auxes.append(a)
        return x, auxes

    body = _remat(cfg, superblock)
    for i in range(n_super):
        x, auxes = body(x, i)
        for a in auxes:
            if a is not None:
                aux = aux + a
    if last_only:
        x = x[:, -1:, :]
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(params["embed"], x, cfg.tie_embeddings,
                         cfg.vocab_size)
    return logits, aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """batch: ``tokens`` (B, S), ``labels`` (B, S), an optional
    ``loss_mask`` and the family's stub inputs, as tensors on the params'
    device -> (loss, {"nll", "aux"}): the mean NLL (a ``vlm`` batch's over
    its text positions only) plus 0.01 times the MoE balance loss."""
    logits, aux = forward_full(
        cfg, params, batch["tokens"],
        patch_embeds=batch.get("patch_embeds"),
        frame_embeds=batch.get("frame_embeds"))
    if cfg.family == "vlm":
        # logits cover [patches; text]; the loss only the text positions
        logits = logits[:, cfg.num_patches:, :]
    nll = L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"),
                         vocab=cfg.vocab_size)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


# --------------------------------------------------------------------------- #
# prefill that also fills the cache (teacher-forced decode steps)
# --------------------------------------------------------------------------- #
def prefill_with_cache(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                       cache: dict, *,
                       patch_embeds: Optional[torch.Tensor] = None,
                       frame_embeds: Optional[torch.Tensor] = None):
    """Sequential prefill through ``decode_step`` (teacher-forced), one
    call a token (a Python loop where the reference scans). With an encdec
    stack and ``frame_embeds``, the frames are encoded first and each
    layer's ``ck``/``cv`` filled once, in place and in the cache's dtype
    (the reference's leaves take the encoder's: the same where the frames
    come in ``cfg.dtype``). ``patch_embeds`` is taken and not read, as in
    the reference. Returns (last logits (B, V) float32, cache, lengths
    (B,) int32)."""
    del patch_embeds
    B, S = tokens.shape
    dev = tokens.device
    if cfg.family == "encdec" and frame_embeds is not None:
        enc_out = encode(cfg, params, frame_embeds)
        for j, (mixer, _ffn) in enumerate(_position_kinds(cfg)):
            if mixer != "attn":
                continue
            cross, c = params["blocks"][f"pos{j}"]["cross"], cache[f"pos{j}"]
            for i in range(c["ck"].shape[0]):
                k, v = A.encoder_kv(cfg, _layer(cross, i), enc_out)
                c["ck"][i].copy_(k)
                c["cv"][i].copy_(v)
    lens = torch.zeros((B,), dtype=torch.int32, device=dev)
    logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32,
                         device=dev)
    for t in range(S):
        out, cache = decode_step(cfg, params, tokens[:, t:t + 1], cache, lens)
        logits = out.float()
        lens = lens + 1
    return logits, cache, lens


# --------------------------------------------------------------------------- #
# decode step (generation stage)
# --------------------------------------------------------------------------- #
def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                cache: dict, cur_len: torch.Tensor):
    """tokens: (B, 1) int; cur_len: (B,) int32 current context lengths.
    Returns (logits (B, V), cache) with this token's K/V (or recurrent
    state) written for every row."""
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)  # (B, 1, d)
    kinds = _position_kinds(cfg)
    n_super = cfg.num_layers // len(kinds)
    for i in range(n_super):
        for j, kind in enumerate(kinds):
            x = _apply_block_decode(cfg, kind,
                                    _layer(params["blocks"][f"pos{j}"], i),
                                    x, _layer(cache[f"pos{j}"], i), cur_len)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(params["embed"], x, cfg.tie_embeddings,
                         cfg.vocab_size)
    return logits[:, 0, :], cache


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply, two rounds) of x in
    [0, 2^32), in int64 tensor ops: the multiplier is under 2^27, so no
    product leaves int64, and every step is exact on any device."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    return (x >> 16) ^ x


def uniform_noise(seed: int, draw: torch.Tensor, shape, device,
                  offset: int = 0, vocab: Optional[int] = None
                  ) -> torch.Tensor:
    """Uniform float32 noise in [2^-24, 1 - 2^-24] of ``shape`` (B, V) for
    draw number ``draw`` (a () int64 device tensor) of the stream
    ``seed``: element (b, v) is a hash of (seed, draw, b * V + v), so the
    stream needs no generator object and no host value, a round that
    draws nothing leaves the stream where it was, and every device gives
    the same bits. A vocabulary shard's columns [offset, offset + V_loc)
    of a ``vocab``-wide draw hash their global cells b * vocab + offset +
    v, the same noise as the whole draw's."""
    k1 = _mix32(_mix32(draw & _M32) ^ (seed & _M32))
    k2 = _mix32(k1 ^ 0x9E3779B9)
    V = shape[1] if vocab is None else vocab
    idx = (torch.arange(shape[0], device=device, dtype=torch.int64)[:, None]
           * V + offset + torch.arange(shape[1], device=device,
                                       dtype=torch.int64)[None, :])
    h = _mix32(_mix32(idx ^ k1) ^ k2)
    # 23 bits, centred in their cell
    return ((h >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def gumbel_noise(seed: int, draw: torch.Tensor, shape, device,
                 offset: int = 0, vocab: Optional[int] = None
                 ) -> torch.Tensor:
    """Gumbel(0, 1) noise from ``uniform_noise``'s draw ``draw``."""
    return -torch.log(-torch.log(uniform_noise(seed, draw, shape, device,
                                               offset, vocab)))


def decode_and_sample(cfg: ModelConfig, params: dict, cache: dict,
                      last_tok: torch.Tensor, lens: torch.Tensor,
                      active: torch.Tensor, gen_count: torch.Tensor,
                      max_new: torch.Tensor, draw: Optional[torch.Tensor], *,
                      temperature: float, eos_token: Optional[int],
                      max_len: int, seed: int = 0):
    """One generation step across all slots in one call: decode, sample,
    and the per-slot length / termination update, all on the device. The
    host's whole view of the step is the (3, B) int32 ``fetch`` = stack of
    (token, done, new length). Inactive slots are frozen: their token stays
    ``last_tok`` and their lens/gen_count do not advance. Temperature
    sampling is Gumbel-max with ``gumbel_noise(seed, draw)`` (the
    reference's ``jax.random.categorical`` draws differ); the draw counter
    ``draw`` advances by one when a lane is live, on the device (greedy
    decoding draws nothing and passes it through). Returns
    (fetch, cache, toks, lens, gen_count, draw)."""
    logits, cache = decode_step(cfg, params, last_tok[:, None], cache, lens)
    # a vocabulary shard's columns: its (max, global index), merged
    mesh, lo = L.vocab_shard(params["embed"], cfg.vocab_size)
    if temperature > 0:
        noise = gumbel_noise(seed, draw, logits.shape, logits.device, lo,
                             cfg.vocab_size)
        toks = comm.sharded_argmax(logits.float() / temperature + noise, lo,
                                   mesh)
        draw = draw + active.any()
    else:
        toks = comm.sharded_argmax(logits, lo, mesh)
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
    return fetch, cache, toks, lens, gen_count, draw


def decode_superstep(cfg: ModelConfig, params: dict, cache: dict,
                     last_tok: torch.Tensor, lens: torch.Tensor,
                     active: torch.Tensor, gen_count: torch.Tensor,
                     max_new: torch.Tensor, draw: Optional[torch.Tensor], *,
                     k: int, temperature: float, eos_token: Optional[int],
                     max_len: int, seed: int = 0):
    """k generation steps in one call: k ``decode_and_sample`` rounds, the
    termination mask carried on the device (a lane that finishes at round
    t is frozen for the rest), the fetches stacked to (k, 3, B). A round
    with no live lane draws no noise, so the tokens equal k single steps',
    under temperature too. Issues no host read of a device value. Dead
    rounds still write K/V at frozen cursors, in rows that admission
    resets before reuse. Returns (fetches, cache, toks, lens, gen_count,
    draw)."""
    fetches = []
    for _ in range(k):
        fetch, cache, last_tok, lens, gen_count, draw = decode_and_sample(
            cfg, params, cache, last_tok, lens, active, gen_count, max_new,
            draw, temperature=temperature, eos_token=eos_token,
            max_len=max_len, seed=seed)
        active = active & (fetch[1] == 0)
        fetches.append(fetch)
    return torch.stack(fetches), cache, last_tok, lens, gen_count, draw


# --------------------------------------------------------------------------- #
# batched prefill (summarization stage)
# --------------------------------------------------------------------------- #
def _prefill_stack(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   cache: dict, attend) -> dict:
    """Run a prompt chunk's tokens through the full stack; each layer's
    attention is ``attend(p_attn, h, layer_cache)``, which writes the
    chunk's K/V into the layer's cache. A MoE FFN routes the whole (B, C, d)
    chunk as one group, idle rows included, as the reference's
    ``_apply_block_prefill`` does. Emits no logits. Returns the cache."""
    if not supports_batched_prefill(cfg):
        raise NotImplementedError(
            "batched prefill covers attention mixers only")
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
    kinds = _position_kinds(cfg)
    n_super = cfg.num_layers // len(kinds)
    for i in range(n_super):
        for j, (_mixer, ffn) in enumerate(kinds):
            p = _layer(params["blocks"][f"pos{j}"], i)
            h = L.apply_norm(cfg, p["norm1"], x)
            y, _ = attend(p["attn"], h, _layer(cache[f"pos{j}"], i))
            x = x + y
            h = L.apply_norm(cfg, p["norm2"], x)
            x = x + _apply_ffn(cfg, ffn, p["ffn"], h, gemv=False)[0]
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


# --------------------------------------------------------------------------- #
# fused overlapped steps: the resident batch's decode and a prefill chunk in
# one call
# --------------------------------------------------------------------------- #
def fused_step(cfg: ModelConfig, params: dict, cache: dict,
               chunk: Callable[[dict], dict], last_tok: torch.Tensor,
               lens: torch.Tensor, active: torch.Tensor,
               gen_count: torch.Tensor, max_new: torch.Tensor,
               draw: Optional[torch.Tensor], *, temperature: float,
               eos_token: Optional[int], max_len: int, seed: int = 0):
    """One overlapped serving step as one dispatch: ``decode_and_sample``,
    then ``chunk(cache) -> cache``, a prefill chunk (``prefill_chunk`` or
    ``prefill_chunk_packed`` with its inputs bound). The order is the
    unfused step's and it keeps the in-place cache writes apart: the
    decode reads the pre-step cache and writes a mid-prefill slot's K/V at
    its parked max_len-1 cursor, then the chunk writes its rows below it.
    Returns decode_and_sample's tuple."""
    fetch, cache, last_tok, lens, gen_count, draw = decode_and_sample(
        cfg, params, cache, last_tok, lens, active, gen_count, max_new,
        draw, temperature=temperature, eos_token=eos_token, max_len=max_len,
        seed=seed)
    return (fetch, chunk(cache), last_tok, lens, gen_count, draw)
