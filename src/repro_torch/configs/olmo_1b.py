"""olmo-1b — OLMo 1B with non-parametric LayerNorm.

[dense] 16L d_model=2048 16H (kv=16, i.e. MHA) d_ff=8192 vocab=50304
[arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    source="arXiv:2402.00838; hf",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="np_layernorm",   # OLMo's non-parametric LN (no scale/bias)
    act="silu",
    tie_embeddings=True,
)
