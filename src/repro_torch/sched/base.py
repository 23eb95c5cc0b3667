"""Scheduler substrate: step composition over the serving engine.

The port's own copy of ``repro/sched/base.py``. A ``Scheduler`` decides
which queued requests are admitted when, and how one engine step is
composed out of the phase dispatches the engine exposes (``admit_wave`` /
``build_prefill_job`` / ``dispatch_prefill_chunk`` / ``finish_prefill`` /
``dispatch_decode`` / ``resolve_decode``). Scheduling never changes
numerics: prefill and greedy decode are slot-local, so only the dispatch
schedule differs between policies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class PrefillJob:
    """One admission wave's prompt tokens laid out for chunked dispatch;
    ``next_chunk`` advances one chunk per ``dispatch_prefill_chunk``."""
    wave: List[Tuple[int, object]]      # [(slot, Request), ...]
    tokens: np.ndarray                  # (B, n_chunks * chunk) int32
    valid: np.ndarray                   # (B, n_chunks * chunk) bool
    chunk: int
    n_chunks: int
    sub_batch: int                      # wave ordinal (trace sub-batch id)
    next_chunk: int = 0
    _wave_taken: bool = False

    @property
    def done(self) -> bool:
        return self.next_chunk >= self.n_chunks

    def next_valid_count(self) -> int:
        """Valid prompt tokens in the chunk the next dispatch would run:
        what a mapping-aware policy routes on."""
        if self.done:
            return 0
        c, C = self.next_chunk, self.chunk
        return int(self.valid[:, c * C:(c + 1) * C].sum())

    def take_completed(self) -> List[Tuple[int, object]]:
        """(slot, req) pairs whose prefill finished since the last call. The
        unpacked layout fills every slot's row in lockstep, so the whole
        wave completes with the final chunk (``PackedPrefillJob`` arms its
        slots per dispatch)."""
        if self.done and not self._wave_taken:
            self._wave_taken = True
            return list(self.wave)
        return []


class Scheduler:
    """Base policy. ``step(engine)`` composes one engine step and returns
    the decode tokens emitted (same contract as ``ServeEngine.step``)."""

    name = "base"

    def __init__(self):
        self.stats: Dict[str, int] = {
            "steps": 0, "overlapped": 0, "fused": 0, "superstep": 0,
            "serialized": 0, "prefill_only": 0, "decode_only": 0, "idle": 0,
        }

    def step(self, engine) -> List[Tuple[int, int]]:
        raise NotImplementedError

    def _tick(self, kind: str) -> None:
        self.stats["steps"] += 1
        self.stats[kind] += 1
