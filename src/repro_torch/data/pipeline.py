"""Batches with the family-specific stub inputs.

The port's own copy of ``repro/data/pipeline.py::batch_for``, numpy only:
the same seed gives the same tokens, labels, frame embeddings (encdec)
and patch embeddings (vlm) in both packages. The audio and image
frontends are stubbed, as in the reference: their outputs are drawn from
the seed. The training token streams of the reference's module belong to
the training slice (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


def batch_for(cfg: ModelConfig, batch: int, seq: int, seed: int = 0) -> dict:
    """A (batch, seq) batch of numpy arrays: ``tokens`` and ``labels``
    int32; for ``vlm`` the text is seq - num_patches tokens and
    ``patch_embeds`` (batch, num_patches, d_model) float32 makes up the
    rest; for ``encdec`` ``frame_embeds`` (batch, encoder_seq, d_model)
    float32."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        s_text = seq - cfg.num_patches
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (batch, s_text)).astype(np.int32)
        out["labels"] = rng.integers(0, cfg.vocab_size,
                                     (batch, s_text)).astype(np.int32)
        out["patch_embeds"] = rng.normal(
            0, 1, (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (batch, seq)).astype(np.int32)
        out["labels"] = rng.integers(0, cfg.vocab_size,
                                     (batch, seq)).astype(np.int32)
    if cfg.family == "encdec":
        out["frame_embeds"] = rng.normal(
            0, 1, (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out
