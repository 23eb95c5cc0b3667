"""What a run leaves for the metric readers, and the arithmetic they share.

A ``Record`` holds the host clock's stamps (each request's due, submit
and token times, each step's start and end with its kind), the engine's
counters at the window's edges, the set-up time, and, in a traced run,
the parsed device trace (``devtrace.parse``). A reader's ``read(record)``
returns its number, or None where the run holds nothing for it to read.

Requests of the window are those the schedule sent inside it, each timed
from when it was due. Each tail is over every one of them; a request
still waiting at the window's close counts with what it has waited.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from perfbench import costs


@dataclasses.dataclass
class Record:
    cfg: object                     # the served ModelConfig
    t_open: float
    t_close: float
    requests: list                  # loop.RequestRecord, unsent ones too
    steps: list                     # loop.StepRecord
    counters: dict                  # {"before": {...}, "after": {...}}
    setup_s: float
    peak: dict                      # costs.peaks() of the card
    trace: Optional[dict] = None    # devtrace.parse()

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def window_requests(rec: Record) -> list:
    return [r for r in rec.requests if rec.t_open <= r.due < rec.t_close]


def ttft_s(rec: Record) -> List[float]:
    """First token less due time; still waiting: the close less it."""
    out = []
    for r in window_requests(rec):
        first = r.stamps[0] if r.stamps and r.stamps[0] <= rec.t_close \
            else rec.t_close
        out.append(first - r.due)
    return out


def tpot_s(rec: Record) -> List[float]:
    """Each window request's mean gap between its tokens: over its
    finished stream, or, unfinished at the close, counting the wait since
    its last token as the gap to the next ((close - first) / tokens)."""
    out = []
    for r in window_requests(rec):
        st = [t for t in r.stamps if t <= rec.t_close]
        if not st:
            continue
        if r.done is not None and r.done <= rec.t_close:
            if len(st) > 1:
                out.append((st[-1] - st[0]) / (len(st) - 1))
        else:
            out.append((rec.t_close - st[0]) / len(st))
    return out


def p90(values: List[float]) -> Optional[float]:
    return float(np.percentile(values, 90)) if values else None


def tokens_in_window(rec: Record) -> int:
    return sum(sum(1 for t in r.stamps if rec.t_open <= t <= rec.t_close)
               for r in rec.requests)


def prefilled_in_window(rec: Record) -> list:
    """Requests whose prefill finished in the window: their first token
    came back inside it."""
    return [r for r in rec.requests
            if r.stamps and rec.t_open <= r.stamps[0] <= rec.t_close]


def window_steps(rec: Record) -> list:
    return [s for s in rec.steps
            if s.start >= rec.t_open and s.end <= rec.t_close]


PREFILL_KINDS = ("prefill_only", "serialized", "overlapped", "fused")


def prefill_flops(rec: Record) -> int:
    """The frozen count of each prompt whose prefill finished in the
    window: all but its last token (the first decode round reads it),
    attending causally."""
    total = 0
    for r in prefilled_in_window(rec):
        n = r.prompt_len - 1
        total += costs.prefill_flops(rec.cfg, n, costs.prompt_pairs(n))
    return total


def model_flops(rec: Record) -> int:
    """The window's model flops by the frozen count: each token returned
    in it (its stack, head and attention over the keys it saw) and each
    prompt prefilled in it."""
    total = prefill_flops(rec)
    for r in rec.requests:
        P = r.prompt_len
        for j, t in enumerate(r.stamps):
            if rec.t_open <= t <= rec.t_close:
                total += costs.decode_round_flops(rec.cfg, [P + j])
    return total


def calls(rec: Record, op: str) -> Optional[list]:
    """The traced window's calls of ``ops.<op>``, each with its device
    seconds; None in an untraced run or where none ran."""
    if rec.trace is None:
        return None
    got = rec.trace["calls"].get(op) or []
    return got or None


def roofline_pct(rec: Record, op: str, cost_of) -> Optional[float]:
    """Sum over the window's calls of the bound time (``cost_of(call)``
    against the peaks) over their device time, in percent."""
    cs = calls(rec, op)
    if not cs:
        return None
    device = sum(c["device_s"] for c in cs)
    if device <= 0:
        return None
    bound = sum(costs.bound_s(cost_of(c), rec.peak) for c in cs)
    return 100.0 * bound / device


def idle_pct(rec: Record) -> Optional[float]:
    if rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    t = rec.trace
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
