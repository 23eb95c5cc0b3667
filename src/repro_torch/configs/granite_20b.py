"""granite-20b — IBM Granite 20B code model, llama-arch with MQA (kv=1).

[dense] 52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    source="arXiv:2405.04324; hf",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,        # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    norm="layernorm",      # granite-20b-code uses LN (gpt-bigcode lineage)
    act="gelu",
)
