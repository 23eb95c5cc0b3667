"""Step-composition policies of the port (``repro/sched/policies.py``).

serial       — admit every free slot, run the wave's prefill to
               completion inside the admission step, then decode.
interleaved  — an admission wave becomes a ``PrefillJob`` that contributes
               ONE prefill chunk per engine step, co-scheduled with the
               resident batch's decode (the NPU-side prefill GEMMs beside
               the PIM-side decode GEMVs).
pim_aware    — interleaved, gated by the mapping: co-schedule only when
               the two phases' FFN FCs route to different engines
               (``route_fc_tpu`` on ``IANUS_HW``, Algorithm 1); otherwise
               the decode resolves first and the chunk follows.

With ``ServeConfig.fuse`` the interleaving policies issue a co-scheduled
step as ONE dispatch (``engine.dispatch_fused_step``); with
``ServeConfig.superstep`` > 1 every policy runs pure-decode steps as
supersteps of up to k decode rounds and one host sync
(``choose_superstep`` picks k from the queue so admission waits at most
one step).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.cost_model import IANUS_HW, HardwareModel
from repro_torch.core.pas import route_fc_tpu
from repro_torch.sched.base import PrefillJob, Scheduler


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


def _superstep(scheduler: Scheduler, engine):
    """A pure-decode step as a superstep, when ``choose_superstep`` gives
    k > 1 and a slot is ready; else None."""
    k = choose_superstep(engine)
    if k <= 1:
        return None
    pending = engine.dispatch_decode_superstep(k)
    if pending is None:
        return None
    scheduler._tick("superstep")
    return engine.resolve_decode_superstep(pending)


class SerialScheduler(Scheduler):
    """Admission wave prefills to completion before the step's decode
    dispatch. Pure-decode steps (no admission) may run as a superstep."""

    name = "serial"

    def step(self, engine) -> List[Tuple[int, int]]:
        wave = engine.admit_wave()
        if wave:
            engine.prefill_wave(wave)
        else:
            out = _superstep(self, engine)
            if out is not None:
                return out
        pending = engine.dispatch_decode()
        if pending is None:
            self._tick("prefill_only" if wave else "idle")
            return []
        self._tick("serialized" if wave else "decode_only")
        return engine.resolve_decode(pending)


class InterleavedScheduler(Scheduler):
    """Overlap prefill sub-batches with the resident batch's decode.

    A step with both phases dispatches the decode for every ready slot,
    then one in-flight job's next chunk while the decode's fetch copies,
    then resolves (or, with ``fuse``, issues both as one dispatch).
    ``sub_batch`` caps the slots one wave claims; ``max_jobs`` > 1 keeps
    several jobs in flight over disjoint slots, fed round-robin;
    ``decode_floor`` > 0 defers a decode of fewer ready slots than that by
    one step while there is a chunk to run (``engine.decode_deferrals``
    counts them). None of them changes a greedy token."""

    name = "interleaved"

    def __init__(self, sub_batch: int = 0, max_jobs: int = 1,
                 decode_floor: int = 0):
        super().__init__()
        self.sub_batch = sub_batch
        self.max_jobs = max(max_jobs, 1)
        self.decode_floor = decode_floor
        self.jobs: List[PrefillJob] = []
        self._rr = 0                    # round-robin cursor over self.jobs
        self._deferred_last = False     # the guard defers at most one step

    def allow_overlap(self, engine, job) -> bool:
        """Whether a step may co-schedule ``job``'s chunk with the decode;
        mapping-aware subclasses veto it."""
        return True

    def _start_jobs(self, engine) -> None:
        while (len(self.jobs) < self.max_jobs and engine.queue
               and engine.free_slot_ids()):
            # the engine's effective_policy degrades stacks without chunked
            # prefill to serial before this scheduler is built
            if engine.effective_prefill_mode != "batched":
                raise RuntimeError(
                    "interleaving policies need the batched prefill path")
            wave = engine.admit_wave(self.sub_batch or None)
            if not wave:
                return
            job = engine.build_prefill_job(wave)
            if job is None:                    # single-token prompts: no
                engine.finish_prefill(wave)    # chunk to run, ready at once
            else:
                self.jobs.append(job)

    def _current_job(self) -> Optional[PrefillJob]:
        if not self.jobs:
            return None
        return self.jobs[self._rr % len(self.jobs)]

    def _retire_chunk(self, engine, job) -> None:
        """After a chunk's dispatch (alone or fused): arm the slots it
        completed, drop a drained job, advance the round-robin cursor."""
        ready = job.take_completed()
        if ready:
            engine.finish_prefill(ready)
        if job.done:
            self.jobs.remove(job)
        else:
            self._rr += 1
        self._rr = self._rr % len(self.jobs) if self.jobs else 0

    def _advance_job(self, engine, job, overlap: bool) -> None:
        engine.dispatch_prefill_chunk(job, overlap=overlap)
        self._retire_chunk(engine, job)

    def step(self, engine) -> List[Tuple[int, int]]:
        self._start_jobs(engine)
        job = self._current_job()
        have_prefill = job is not None
        n_ready = len(engine.ready_slot_ids())
        if (have_prefill and self.decode_floor > 0
                and 0 < n_ready < self.decode_floor
                and not self._deferred_last):
            engine.decode_deferrals += 1
            self._deferred_last = True
            self._advance_job(engine, job, overlap=False)
            self._tick("prefill_only")
            return []
        self._deferred_last = False
        if not have_prefill:
            out = _superstep(self, engine)
            if out is not None:
                return out
        co = have_prefill and n_ready > 0 and self.allow_overlap(engine, job)
        if co and engine.scfg.fuse and job.next_valid_count() > 0:
            pending = engine.dispatch_fused_step(job)
            self._retire_chunk(engine, job)
            self._tick("fused")
            return engine.resolve_decode(pending)
        pending = engine.dispatch_decode(overlap=co)
        if co:
            # the chunk's dispatch rides inside the decode's fetch window
            self._advance_job(engine, job, overlap=True)
            self._tick("overlapped")
            return engine.resolve_decode(pending)
        out = engine.resolve_decode(pending) if pending is not None else []
        if have_prefill:
            self._advance_job(engine, job, overlap=False)
            self._tick("serialized" if pending is not None else "prefill_only")
        elif pending is not None:
            self._tick("decode_only")
        else:
            self._tick("idle")
        return out


class PimAwareScheduler(InterleavedScheduler):
    """Interleaved, but co-schedules only when Algorithm 1 maps the two
    phases' FFN FC to different engines: the prefill chunk by its valid
    tokens, the decode by its ready slots, on ``hw`` (the paper's machine
    by default) at ``map_dims`` (the served model's (d_model, d_ff) unless
    given). Same engine: the phases would contend for one unit (and on
    unified memory a PIM-mapped pair serializes on the rank), so the step
    runs them back to back. Every decision lands in ``decision_log``."""

    name = "pim_aware"

    def __init__(self, sub_batch: int = 0,
                 map_dims: Optional[Tuple[int, int]] = None,
                 hw: HardwareModel = IANUS_HW, max_jobs: int = 1,
                 decode_floor: int = 0):
        super().__init__(sub_batch, max_jobs, decode_floor)
        self.map_dims = map_dims
        self.hw = hw
        self.decision_log: List[dict] = []

    def allow_overlap(self, engine, job) -> bool:
        d_in, d_out = self.map_dims or (engine.cfg.d_model, engine.cfg.d_ff)
        n_prefill = job.next_valid_count()
        n_decode = len(engine.ready_slot_ids())
        prefill_route = route_fc_tpu(max(n_prefill, 1), d_in, d_out, self.hw)
        decode_route = route_fc_tpu(max(n_decode, 1), d_in, d_out, self.hw)
        ok = prefill_route != decode_route
        # "degraded" is the reference's PIM-degraded (chaos) node, which
        # maps both phases to the matrix engine; the port has none yet
        self.decision_log.append({
            "step": engine.step_idx, "n_prefill": n_prefill,
            "n_decode": n_decode, "prefill_route": prefill_route,
            "decode_route": decode_route, "overlap": ok, "degraded": False,
        })
        return ok


_POLICIES = {
    SerialScheduler.name: SerialScheduler,
    InterleavedScheduler.name: InterleavedScheduler,
    PimAwareScheduler.name: PimAwareScheduler,
}

POLICY_NAMES = tuple(_POLICIES)


def make_scheduler(policy: str, *, sub_batch: int = 0,
                   map_dims: Optional[Tuple[int, int]] = None,
                   hw: HardwareModel = IANUS_HW, max_jobs: int = 1,
                   decode_floor: int = 0) -> Scheduler:
    """Policy factory (``ServeConfig.policy`` values)."""
    if policy == SerialScheduler.name:
        return SerialScheduler()
    if policy == InterleavedScheduler.name:
        return InterleavedScheduler(sub_batch, max_jobs, decode_floor)
    if policy == PimAwareScheduler.name:
        return PimAwareScheduler(sub_batch, map_dims, hw, max_jobs,
                                 decode_floor)
    raise ValueError(
        f"unknown scheduling policy {policy!r} (have: {POLICY_NAMES})")
