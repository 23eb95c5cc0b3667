"""qwen3-moe-30b-a3b — Qwen3 30B-A3B: 128 experts, top-8.

[moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768(per expert) vocab=151936,
MoE 128e top-8  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,           # d_model / num_heads
    d_ff=768,              # per-expert FFN width
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_every=1,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
)
