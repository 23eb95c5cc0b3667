"""pixtral-12b — Pixtral ViT + Mistral-NeMo backbone (frontend stubbed).

[vlm] 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]

Only the transformer backbone is modelled: patch embeddings, drawn from a
seed by ``data.pipeline.batch_for``, are prepended to the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,          # d_model / num_heads
    d_ff=14336,
    vocab_size=131072,
    num_patches=256,       # stub image: 256 patch embeddings
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
)
