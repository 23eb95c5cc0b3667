"""Synthetic arrival processes + the open-loop driver (the port's own copy
of ``repro/trace/arrivals.py``: the same generators give the same events
for the same seed, and ``drive`` catches the port engine's
``AdmissionRejected``).

Real serving traffic is not "enqueue everything, drain": requests arrive
over time, mix short and long prompts, and terminate early. These
generators produce that scenario diversity without real traffic, keyed to
the engine's step counter as the clock (one decode step = one time unit):

  poisson_arrivals — open-loop Poisson(rate) arrivals per step
  bursty_arrivals  — on/off-modulated Poisson (same mean load, bursty)

Lengths default to uniform over a range; passing ``lengths=`` (a
``LengthDistribution``, e.g. ``lengths_from_file(path)`` over a JSON
histogram sampled from a real chat corpus — one ships under
``benchmarks/data/chat_lengths.json``) draws prompt/output lengths from the
empirical distribution instead, clipped into the generator's bounds so
workloads stay servable under a given ``max_len``.

``drive`` feeds an arrival list into a ``ServeEngine`` step by step, so a
recorder attached to the engine captures the arrival process,
queueing, admission waves and early terminations exactly as served.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.engine import AdmissionRejected


@dataclass
class ArrivalEvent:
    step: int                 # engine step at which the request arrives
    prompt: np.ndarray        # (prompt_len,) int32
    max_new: int


@dataclass
class LengthDistribution:
    """Empirical prompt/output length histograms. Each side is a binned
    histogram: ``edges`` has n+1 ascending integers, ``counts`` n weights;
    a sample picks a bin by weight, then an integer uniformly in
    [edges[i], edges[i+1] - 1]."""
    prompt_edges: np.ndarray
    prompt_counts: np.ndarray
    output_edges: np.ndarray
    output_counts: np.ndarray
    source: str = ""

    @staticmethod
    def _check(edges: np.ndarray, counts: np.ndarray, name: str) -> None:
        if len(edges) != len(counts) + 1:
            raise ValueError(f"{name}: need len(edges) == len(counts) + 1, "
                             f"got {len(edges)} / {len(counts)}")
        if not (np.diff(edges) > 0).all():
            raise ValueError(f"{name}: edges must be strictly ascending")
        if counts.sum() <= 0 or (counts < 0).any():
            raise ValueError(f"{name}: counts must be non-negative with a "
                             f"positive total")

    def __post_init__(self):
        for side in ("prompt", "output"):
            edges = np.asarray(getattr(self, f"{side}_edges"), np.int64)
            counts = np.asarray(getattr(self, f"{side}_counts"), np.float64)
            self._check(edges, counts, side)
            setattr(self, f"{side}_edges", edges)
            setattr(self, f"{side}_counts", counts)

    def _sample(self, rng: np.random.Generator, edges, counts) -> int:
        i = rng.choice(len(counts), p=counts / counts.sum())
        return int(rng.integers(edges[i], edges[i + 1]))

    def sample_prompt(self, rng: np.random.Generator) -> int:
        return self._sample(rng, self.prompt_edges, self.prompt_counts)

    def sample_output(self, rng: np.random.Generator) -> int:
        return self._sample(rng, self.output_edges, self.output_counts)


def lengths_from_file(path) -> LengthDistribution:
    """Load a JSON length histogram:

        {"source": "...",
         "prompt": {"edges": [...n+1 ints...], "counts": [...n...]},
         "output": {"edges": [...], "counts": [...]}}

    so arrival generators draw realistic prompt/output lengths instead of
    synthesizing uniform ones."""
    with open(path) as f:
        d = json.load(f)
    try:
        return LengthDistribution(
            prompt_edges=np.asarray(d["prompt"]["edges"]),
            prompt_counts=np.asarray(d["prompt"]["counts"]),
            output_edges=np.asarray(d["output"]["edges"]),
            output_counts=np.asarray(d["output"]["counts"]),
            source=d.get("source", ""))
    except KeyError as e:
        raise ValueError(f"length histogram {path} missing key {e}") from e


def _make_requests(rng: np.random.Generator, steps: np.ndarray,
                   prompt_len: Tuple[int, int], max_new: Tuple[int, int],
                   vocab: int,
                   lengths: Optional[LengthDistribution] = None
                   ) -> List[ArrivalEvent]:
    out = []
    # draw order is plen, prompt, max_new — the historical rng stream, so
    # seeded workloads recorded before the `lengths` option stay
    # byte-identical
    for s in steps:
        if lengths is not None:
            # empirical draw, clipped into the generator's bounds so the
            # workload stays servable under the engine's max_len
            plen = int(np.clip(lengths.sample_prompt(rng),
                               prompt_len[0], prompt_len[1]))
        else:
            plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        prompt = rng.integers(0, vocab, plen).astype(np.int32)
        if lengths is not None:
            mnew = int(np.clip(lengths.sample_output(rng),
                               max_new[0], max_new[1]))
        else:
            mnew = int(rng.integers(max_new[0], max_new[1] + 1))
        out.append(ArrivalEvent(step=int(s), prompt=prompt, max_new=mnew))
    return out


def poisson_arrivals(rate: float, horizon: int, *, vocab: int,
                     prompt_len: Tuple[int, int] = (2, 32),
                     max_new: Tuple[int, int] = (4, 16),
                     lengths: Optional[LengthDistribution] = None,
                     seed: int = 0) -> List[ArrivalEvent]:
    """Open-loop load: per-step arrival counts ~ Poisson(rate), prompt
    lengths and generation budgets uniform over the given ranges — or
    drawn from ``lengths`` (an empirical distribution) clipped into
    them."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(rate, horizon)
    steps = np.repeat(np.arange(horizon), counts)
    return _make_requests(rng, steps, prompt_len, max_new, vocab, lengths)


def bursty_arrivals(rate: float, horizon: int, *, vocab: int,
                    burst: int = 8, idle: int = 24,
                    prompt_len: Tuple[int, int] = (2, 32),
                    max_new: Tuple[int, int] = (4, 16),
                    lengths: Optional[LengthDistribution] = None,
                    seed: int = 0) -> List[ArrivalEvent]:
    """On/off-modulated Poisson: arrivals only during `burst`-step windows
    separated by `idle` quiet steps, with the on-rate scaled so the mean
    load over the horizon matches ``rate`` — same offered load as the
    Poisson process, concentrated into bursts (queueing stress)."""
    rng = np.random.default_rng(seed)
    period = burst + idle
    on = (np.arange(horizon) % period) < burst
    rate_on = rate * period / burst
    counts = np.where(on, rng.poisson(rate_on, horizon), 0)
    steps = np.repeat(np.arange(horizon), counts)
    return _make_requests(rng, steps, prompt_len, max_new, vocab, lengths)


def drive(engine, arrivals: List[ArrivalEvent],
          max_steps: int = 100_000, *, backoff: int = 4,
          backoff_cap: int = 64, return_stats: bool = False):
    """Open-loop serve: inject each arrival once the engine clock reaches
    its step (idle engine steps advance the clock), run until every arrival
    has been served. Returns {rid: generated tokens}; with
    ``return_stats=True`` returns ``(results, stats)`` where stats counts
    admission rejections.

    A bounded admission queue (``ServeConfig.queue_cap``) can reject an
    arrival; the driver NEVER silently drops it — the arrival re-injects
    after ``backoff`` ticks (doubling per attempt, capacity pressure is
    not helped by hammering — clamped at ``backoff_cap`` so a long
    rejection streak cannot push a request's retry cadence past the
    point where a freed queue would go unnoticed), keeping its TRUE
    arrival step so the recorded ``arrival_offset`` carries the full
    admission wait into TTFT/queue-wait metrics. Every arrival is
    eventually served: the queue drains monotonically, so a finite
    workload always admits."""
    if backoff_cap < backoff:
        raise ValueError(
            f"backoff_cap ({backoff_cap}) must be >= backoff ({backoff})")
    pending = sorted(arrivals, key=lambda a: a.step)
    results: Dict[int, List[int]] = {}
    stats = {"rejected": 0}
    retry: List[Tuple[int, int, ArrivalEvent]] = []   # (due, order, ev)
    delay: Dict[int, int] = {}                        # order -> next delay
    i = 0
    for _ in range(max_steps):
        now = engine.step_idx
        due = sorted((r for r in retry if r[0] <= now),
                     key=lambda r: (r[0], r[1]))
        retry = [r for r in retry if r[0] > now]
        for _, order, ev in due:
            try:
                engine.add_request(ev.prompt, ev.max_new,
                                   arrival_step=ev.step)
            except AdmissionRejected:
                stats["rejected"] += 1
                d = delay[order]
                delay[order] = min(d * 2, backoff_cap)
                retry.append((now + d, order, ev))
        while i < len(pending) and pending[i].step <= now:
            # arrival_step records the TRUE arrival tick: when a superstep
            # advanced the clock past it, the injection is late and the
            # recorder keeps the sub-step offset (schema v5)
            try:
                engine.add_request(pending[i].prompt, pending[i].max_new,
                                   arrival_step=pending[i].step)
            except AdmissionRejected:
                stats["rejected"] += 1
                delay[i] = min(backoff * 2, backoff_cap)
                retry.append((now + min(backoff, backoff_cap), i,
                              pending[i]))
            i += 1
        if i >= len(pending) and not retry and not engine.queue \
                and all(r is None for r in engine.slot_req):
            return (results, stats) if return_stats else results
        for rid, tok in engine.step():
            results.setdefault(rid, []).append(tok)
    raise RuntimeError(f"workload did not drain in {max_steps} steps")
