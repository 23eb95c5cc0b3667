"""whisper-medium — encoder-decoder backbone; conv audio frontend stubbed.

[audio] 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]

Frame embeddings (B, 1500, d_model), drawn from a seed by
``data.pipeline.batch_for``, stand in for the mel-spectrogram conv
frontend. The decoder's context in serving is Whisper's 448 tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    source="arXiv:2212.04356; unverified",
    num_layers=24,          # decoder layers
    encoder_layers=24,
    encoder_seq=1500,       # frames after the (stubbed) conv frontend
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
)
