"""Step-composition policies of the port (``repro/sched/policies.py``).

The port serves the ``serial`` policy: each admission wave prefills to
completion inside its admission step, then the step's decode runs. The
interleaving policies (``interleaved``, ``pim_aware``) co-schedule prefill
chunks with decode steps and belong to a later slice (ROADMAP queue 1,
item 8); asking for one raises.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.sched.base import Scheduler

POLICY_NAMES = ("serial", "interleaved", "pim_aware")


def choose_superstep(engine) -> int:
    """Superstep length from queue state (``ServeConfig.superstep`` is the
    cap): 1 while any request waits, else clipped to the largest number of
    decode rounds a ready slot has left (generation budget, and cache
    headroom before the max_len-1 cap)."""
    k = engine.scfg.superstep
    if k <= 1 or engine.queue:
        return 1
    cap = engine.scfg.max_len - 1
    rem = [min(r.max_new_tokens - len(r.generated),
               cap - (len(r.prompt) - 1 + len(r.generated)))
           for i, r in enumerate(engine.slot_req)
           if r is not None and engine.slot_ready[i]]
    if not rem:
        return 1
    return max(1, min(k, max(rem)))


class SerialScheduler(Scheduler):
    """Admission wave prefills to completion before the step's decode
    dispatch."""

    name = "serial"

    def step(self, engine) -> List[Tuple[int, int]]:
        wave = engine.admit_wave()
        if wave:
            engine.prefill_wave(wave)
        pending = engine.dispatch_decode()
        if pending is None:
            self._tick("prefill_only" if wave else "idle")
            return []
        self._tick("serialized" if wave else "decode_only")
        return engine.resolve_decode(pending)


def make_scheduler(policy: str) -> Scheduler:
    """Policy factory (``ServeConfig.policy`` values)."""
    if policy == SerialScheduler.name:
        return SerialScheduler()
    if policy in POLICY_NAMES:
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet: the interleaving "
            f"policies come with fused steps and supersteps (ROADMAP "
            f"queue 1, item 8)")
    raise ValueError(
        f"unknown scheduling policy {policy!r} (have: {POLICY_NAMES})")
