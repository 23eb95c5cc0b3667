"""rwkv6-7b — Finch: attention-free RNN-LM with data-dependent decay.

[ssm] 32L d_model=4096 d_ff=14336 vocab=65536  [arXiv:2404.05892; hf]
Heads are d_model / rwkv_head_dim = 64 heads of 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892; hf",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    norm="layernorm",      # RWKV uses LayerNorm
    act="silu",            # channel-mix uses squared-relu in the paper; silu-class here
)
