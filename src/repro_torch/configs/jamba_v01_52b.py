"""jamba-v0.1-52b — hybrid Mamba + attention (1:7 interleave) with MoE.

[hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16e top-2  [arXiv:2403.19887; hf]

Jamba period-8 block: 1 attention layer + 7 Mamba layers; MoE FFN on every
second layer, dense MLP elsewhere (the published 52B layout). The whole
model is about 103 GB in bf16; on one 80 GB card it runs at a cut depth
(``dataclasses.replace(CONFIG, num_layers=8)``: one whole period).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887; hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,         # attention mid-block, as in the release
    ssm_d_state=16,
    ssm_expand=2,
    ssm_conv=4,
    norm="rmsnorm",
    act="silu",
)
