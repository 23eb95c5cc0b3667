"""phi3-medium-14b — Phi-3 medium: RoPE + SwiGLU + GQA.

[dense] 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219; unverified",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    norm="rmsnorm",
    act="silu",
)
