"""The open loop on the wall clock.

Requests are sent when the schedule says (``traffic.due(i)`` seconds after
the loop's start), whether or not earlier ones have finished: before each
``engine.step()`` the loop submits every request due by then. A request is
timed from when it was due, so a long step's delay to later requests
counts, and the loop keeps how late it submitted each. Each token is
stamped with the host clock when ``step()`` returns it. Every step is
recorded with its kind (the scheduler's count that moved), its decode
rounds (engine ticks), the prompt tokens its prefill chunk carried and the
tokens it returned.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    i: int                      # its place in the schedule
    prompt: np.ndarray
    max_new: int
    due: float                  # when the schedule sent it
    submit: Optional[float] = None   # when the loop submitted it
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: Optional[float] = None
    handle: object = None       # the engine's request object

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclasses.dataclass
class StepRecord:
    start: float
    end: float
    kind: str
    rounds: int                 # decode rounds the step ran
    prefill_tokens: int         # valid prompt tokens its chunk carried
    tokens: int                 # tokens it returned


class OpenLoop:
    def __init__(self, engine, traffic, clock: Callable[[], float]
                 = time.perf_counter):
        self.engine = engine
        self.traffic = traffic
        self.clock = clock
        self.requests: List[RequestRecord] = []
        self.steps: List[StepRecord] = []
        self.start = clock()
        self._live: Dict[int, RequestRecord] = {}     # rid -> in flight

    def _submit_due(self, now: float) -> None:
        while True:
            i = len(self.requests)
            due = self.start + self.traffic.due(i)
            if due > now:
                return
            prompt, max_new = self.traffic.request(i)
            rec = RequestRecord(i=i, prompt=prompt, max_new=max_new, due=due,
                                submit=self.clock())
            rid = self.engine.add_request(prompt, max_new)
            rec.handle = self.engine.queue[-1]
            self.requests.append(rec)
            self._live[rid] = rec

    def tick(self) -> None:
        """Submit what is due, then run one engine step (or, with nothing
        to serve, wait for the next arrival)."""
        eng = self.engine
        self._submit_due(self.clock())
        if not self._live:
            nxt = self.start + self.traffic.due(len(self.requests))
            time.sleep(max(0.0, min(nxt - self.clock(), 0.01)))
            return
        stats = eng.scheduler.stats
        before, tick = dict(stats), eng.step_idx
        valid = eng.prefill_stats["valid_tokens"]
        t0 = self.clock()
        out = eng.step()
        t1 = self.clock()
        kind = next((k for k, v in stats.items()
                     if k != "steps" and v != before.get(k)), "idle")
        rounds = eng.step_idx - tick if kind == "superstep" \
            else int(kind not in ("prefill_only", "idle"))
        self.steps.append(StepRecord(
            start=t0, end=t1, kind=kind, rounds=rounds,
            prefill_tokens=eng.prefill_stats["valid_tokens"] - valid,
            tokens=len(out)))
        for rid, tok in out:
            rec = self._live[rid]
            rec.stamps.append(t1)
            rec.tokens.append(int(tok))
        for rid, rec in list(self._live.items()):
            if rec.handle.done:
                rec.done = t1
                del self._live[rid]

    def run_until(self, t_end: float) -> None:
        while self.clock() < t_end:
            self.tick()

    def run_for(self, seconds: float) -> None:
        self.run_until(self.clock() + seconds)

    def unsent(self, t: float) -> List[RequestRecord]:
        """Requests due by ``t`` that the loop has not submitted yet."""
        out, i = [], len(self.requests)
        while self.start + self.traffic.due(i) <= t:
            prompt, max_new = self.traffic.request(i)
            out.append(RequestRecord(i=i, prompt=prompt, max_new=max_new,
                                     due=self.start + self.traffic.due(i)))
            i += 1
        return out
