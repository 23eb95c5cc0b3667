"""Data: deterministic training streams and batches with the
family-specific stub inputs.

The port's own copy of ``repro/data/pipeline.py``, numpy only: the same
seed and step give the same batches byte for byte in both packages.
``SyntheticLM`` and ``ByteCorpus`` are the training streams, reproducible
from (seed, step) so that a restarted run replays the same batches;
``batch_for`` draws a batch's tokens, labels, frame embeddings (encdec)
and patch embeddings (vlm). The audio and image frontends are stubbed, as
in the reference: their outputs are drawn from the seed.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class SyntheticLM:
    """Affine-recurrence token streams: tok[t+1] = (a*tok[t] + c) % vocab
    with per-sequence (a, c) drawn from a small pool."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_rules: int = 8

    def batch(self, step: int) -> dict:
        digest = hashlib.sha256(f"{self.seed}:{step}".encode()).hexdigest()
        rng = np.random.default_rng(int(digest[:15], 16))
        V = self.vocab_size
        a_pool = rng.integers(2, 64, self.n_rules)
        c_pool = rng.integers(1, V - 1, self.n_rules)
        rule = rng.integers(0, self.n_rules, self.global_batch)
        tok = np.empty((self.global_batch, self.seq_len + 1), np.int32)
        tok[:, 0] = rng.integers(0, V, self.global_batch)
        for t in range(self.seq_len):
            tok[:, t + 1] = (a_pool[rule] * tok[:, t] + c_pool[rule]) % V
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclass
class ByteCorpus:
    """Concatenated UTF-8 bytes of every file under ``root`` (filtered by
    suffix, walked in sorted order), cut into (seq_len + 1) windows at
    starts drawn from (seed, step). vocab = 256."""
    root: str
    seq_len: int
    global_batch: int
    suffixes: tuple = (".py", ".md", ".txt")
    seed: int = 0
    _data: Optional[np.ndarray] = None

    def _load(self) -> np.ndarray:
        if self._data is None:
            bufs = []
            for dirpath, _dirs, files in sorted(os.walk(self.root)):
                for f in sorted(files):
                    if f.endswith(self.suffixes):
                        with open(os.path.join(dirpath, f), "rb") as fh:
                            bufs.append(np.frombuffer(fh.read(), np.uint8))
            if not bufs:
                raise FileNotFoundError(f"no corpus files under {self.root}")
            self._data = np.concatenate(bufs).astype(np.int32)
        return self._data

    def batch(self, step: int) -> dict:
        data = self._load()
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        n = len(data) - self.seq_len - 1
        starts = rng.integers(0, max(1, n), self.global_batch)
        tok = np.stack([data[s:s + self.seq_len + 1] for s in starts])
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


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
