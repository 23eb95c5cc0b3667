"""kimi-k2-1t-a32b — Kimi K2, trillion-parameter MoE (paper-table config).

[moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048(per expert) vocab=163840,
MoE 384 experts top-8  [arXiv:2501.kimi2; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2; unverified",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,          # d_model / num_heads
    d_ff=2048,             # per-expert FFN width
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    moe_every=1,           # every layer MoE
    fsdp_params=True,      # 2.08 TB of expert weights: 16-way TP alone is
                           # 130 GB/chip; expert dims also shard over 'data'
                           # (ZeRO-3), all-gathered per layer inside the scan
    norm="rmsnorm",
    act="silu",
    rope_theta=50_000.0,
)
