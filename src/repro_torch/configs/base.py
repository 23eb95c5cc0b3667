"""Model configuration: the port's own copy of ``ModelConfig``.

Same fields, defaults and derived quantities as the reference package's
config, so a configuration means the same model on both sides. The port
serves every family: ``dense``, ``moe``, ``ssm``, ``hybrid``, ``encdec``
and ``vlm``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

Family = str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: Family
    source: str = ""          # provenance tag from the assignment table

    # core transformer dims
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 50304
    head_dim: int = 0          # 0 -> derived d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1         # apply MoE FFN on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # SSM (RWKV6 / Mamba)
    ssm_d_state: int = 16      # mamba state dim
    ssm_expand: int = 2        # mamba d_inner = ssm_expand * d_model
    ssm_conv: int = 4          # mamba depthwise conv width
    rwkv_head_dim: int = 64    # rwkv6 head size

    # hybrid (Jamba): one attention layer per `attn_period` layers
    attn_period: int = 0       # 0 -> all layers attention (or none for ssm family)
    attn_offset: int = 0

    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 1500    # whisper: 1500 frames after conv frontend (stubbed)

    # vlm stub frontend
    num_patches: int = 0       # pixtral: patch embeddings prepended to the text seq

    # misc architecture knobs
    norm: str = "rmsnorm"      # "rmsnorm" | "layernorm" | "np_layernorm" (olmo)
    act: str = "silu"          # "silu" | "gelu"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # execution knobs (overridable per run)
    fsdp_params: bool = False  # shard expert weights over 'data' too (ZeRO-3
                               # style, all-gathered per layer) — required
                               # when params exceed TP-only capacity (kimi-1T)
    remat: str = "full"        # "none" | "full" | "dots" — activation checkpointing
    scan_layers: bool = True   # scan over stacked layer params (O(1)-layer HLO)
    use_pallas: bool = False   # Pallas kernels (TPU target); XLA path on CPU dry-run
    chunk_q: int = 512         # flash-attention query block (XLA path)
    chunk_kv: int = 1024       # flash-attention KV block (XLA path)
    flash_vjp: bool = False    # flash BACKWARD (custom VJP): recompute score
                               # blocks in bwd instead of saving scan carries
    ssm_chunk: int = 128       # chunked scan block for rwkv/mamba
    kv_update: str = "onehot"  # "onehot" (naive baseline) | "scatter" (O(1) bytes)
    kv_dtype: str = "bf16"     # "bf16" | "int8" (quantized KV cache: halves
                               # decode HBM traffic; per-insert scales)
    rules_profile: str = "tp"  # sharding profile: "tp" | "dp" (see axes.py)
    moe_impl: str = "gspmd"    # "gspmd" | "ep" (resident 2D expert-parallel
                               # shard_map path — no per-step weight gathers)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.num_heads))
        if self.num_kv_heads == 0:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state does not grow quadratically with context
        (SSM / hybrid / linear attention) — gates the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: 'attn' | 'mamba' | 'rwkv'."""
        if self.family == "ssm":
            return tuple("rwkv" for _ in range(self.num_layers))
        if self.family == "hybrid" and self.attn_period > 0:
            return tuple(
                "attn" if (i % self.attn_period) == self.attn_offset else "mamba"
                for i in range(self.num_layers)
            )
        return tuple("attn" for _ in range(self.num_layers))

    def ffn_kinds(self) -> Tuple[str, ...]:
        """Per-layer FFN kind: 'dense' | 'moe'."""
        if not self.is_moe:
            return tuple("dense" for _ in range(self.num_layers))
        return tuple(
            "moe" if (i % self.moe_every) == self.moe_offset else "dense"
            for i in range(self.num_layers)
        )

    # ---- parameter counting (for roofline MODEL_FLOPS) ----------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts. Returns dict with total and active."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        dense_ffn = 3 * d * f if self.act == "silu" else 2 * d * f
        moe_ffn = self.num_experts * (3 * d * f) + d * self.num_experts  # + router
        moe_active = self.experts_per_token * (3 * d * f) + d * self.num_experts

        di, n = self.d_inner, self.ssm_d_state
        mamba_layer = (
            d * di * 2            # in_proj (x and z)
            + di * self.ssm_conv  # conv
            + di * (2 * n + 1)    # B, C, dt per-channel (selective proj, low-rank folded)
            + di * n              # A
            + di * d              # out_proj
        )
        rwkv_layer = (
            4 * d * d             # r,k,v,g time-mix projections
            + d * d               # output proj
            + 2 * d               # decay + bonus params
            + d * f + f * d       # channel-mix (k, v)
        )

        total = emb
        active = emb
        for kind, fk in zip(self.layer_kinds(), self.ffn_kinds()):
            if kind == "attn":
                total += per_layer_attn
                active += per_layer_attn
            elif kind == "mamba":
                total += mamba_layer
                active += mamba_layer
            else:  # rwkv: mixer + channel-mix counted together
                total += rwkv_layer
                active += rwkv_layer
                continue  # rwkv_layer already includes its FFN (channel mix)
            if fk == "moe":
                total += moe_ffn
                active += moe_active
            else:
                total += dense_ffn
                active += dense_ffn
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (per_layer_attn + dense_ffn)
            # decoder cross-attention adds one more attention block per layer
            total += self.num_layers * per_layer_attn
            active += self.num_layers * per_layer_attn
        total += enc
        active += enc
        return {"total": total, "active": active}

    # ---- reduced config for CPU smoke tests ---------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config: smoke tests instantiate this."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if self.family == "hybrid" else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_ff=128,
            head_dim=16,
            vocab_size=256,
            remat="none",
            scan_layers=True,
            chunk_q=16,
            chunk_kv=32,
            ssm_chunk=8,
        )
        if self.is_moe:
            kw.update(num_experts=4, experts_per_token=2)
        if self.family == "hybrid":
            kw.update(attn_period=2, attn_offset=1, moe_every=2, moe_offset=1,
                      num_experts=4, experts_per_token=2, ssm_expand=2, ssm_d_state=4)
        if self.family == "ssm":
            kw.update(rwkv_head_dim=16)
        if self.family == "encdec":
            kw.update(encoder_layers=2, encoder_seq=16)
        if self.family == "vlm":
            kw.update(num_patches=4)
        return replace(self, **kw)
