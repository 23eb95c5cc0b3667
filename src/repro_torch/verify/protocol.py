"""Serving-protocol lint over schema-v4 workload traces.

``lint_trace`` replays a ``trace.Trace``'s event timeline through a host-
side model of the engine's slot protocol and reports violations of the
invariants the scheduler subsystem relies on, without executing
anything on device:

  decode_mid_prefill   a decode step touched a slot that is still mid-
                       prefill: the slot appears in a decode event's active
                       set, or — batched mode — its recorded write cursor
                       left the parked position (max_len-1) before its
                       prompt finished caching (the parked-cursor rule that
                       keeps fused decode dispatches from clobbering a
                       freshly written prompt cache)
  gather_before_scatter  a packed continuation dispatch attends a cache
                       prefix larger than what its job has scattered up to
                       and including this dispatch — the planner's
                       scatter-precedes-gather ordering was violated. The
                       attended prefix is the dispatch's recorded span,
                       except where the re-derived plan has a dispatch of
                       that span at this position: then it is the plan's
                       true extent (its lanes' largest ``prefix_len``).
                       The two differ only for a slot seeded from a KV
                       snapshot whose restored prefix is no chunk
                       multiple: the planner pads the span up to the next
                       chunk boundary and masks the gather past the true
                       extent, so the span alone over-reports (where the
                       reference's copy flags such a restore).
  superstep_refetch    the inner decode events of one superstep dispatch
                       are non-contiguous — the span's single (k, 3, B)
                       fetch would have had to happen more than once
  superstep_span       a superstep span is longer than its k / the
                       header cap, or its inner events disagree on the
                       route decided once at dispatch
  fused_unpaired       a ``fused`` prefill/decode event without its twin
                       at the same step — fused pairs share one issue root
  dispatch_accounting  the summary's dispatch/host-sync counters disagree
                       with what the event timeline implies
  packed_plan          a packed job's event count disagrees with the
                       deterministic packing plan re-derived from the
                       admitted wave (warning)
  lifecycle            bookkeeping anomalies (unknown rids, admits into
                       occupied slots) — warnings

Packed per-slot readiness is reconstructed by re-running the deterministic
planner (``sched.packing.plan_packed_job`` depends only on prompt lengths,
slots and order — all recorded in the admit event), so short prompts that
arm mid-job are modeled exactly. Readiness tracking is deliberately an
upper bound on the engine's (slots never arm *later* than the model
believes), so every reported violation is a certain one.

The port's own copy of ``repro/verify/protocol.py``; it differs in the
attended extent of ``gather_before_scatter`` alone (above).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.sched.packing import plan_packed_job
from repro_torch.trace.schema import Trace
from repro_torch.verify.hazards import Finding


class _DummyReq:
    """Prompt-length stand-in for plan reconstruction (the planner only
    reads ``req.prompt`` and ``req.prefill_start``)."""
    __slots__ = ("prompt", "prefill_start")

    def __init__(self, plen: int, prefill_start: int = 0):
        self.prompt = np.zeros(plen, np.int32)
        self.prefill_start = prefill_start


class _Slot:
    __slots__ = ("rid", "need", "covered", "ready")

    def __init__(self, rid: int, need: int):
        self.rid = rid
        self.need = need
        self.covered = 0
        self.ready = need == 0


class _PackedJob:
    __slots__ = ("completes", "spans", "extents", "n_dispatches",
                 "events_seen", "cum_valid")

    def __init__(self, plan):
        self.completes = [[int(s) for s, _ in d.completes]
                          for d in plan.dispatches]
        # each dispatch's padded prefix span and the true extent it reads
        # unmasked (equal unless a restored prefix is unaligned)
        self.spans = [int(d.prefix_span) for d in plan.dispatches]
        self.extents = [int(d.prefix_len.max(initial=0))
                        for d in plan.dispatches]
        self.n_dispatches = len(plan.dispatches)
        self.events_seen = 0
        self.cum_valid = 0


def lint_trace(trace: Trace) -> List[Finding]:
    serve = trace.header.get("serve", {})
    max_len = int(serve.get("max_len", 0))
    parked = max_len - 1
    batched = serve.get("prefill_mode", "batched") == "batched"
    pack = bool(serve.get("pack", False))
    chunk = int(serve.get("prefill_chunk", 1))
    max_slots = int(serve.get("max_slots", 0))
    cap_k = int(serve.get("superstep", 1))

    findings: List[Finding] = []
    slots: Dict[int, _Slot] = {}
    rid_slot: Dict[int, int] = {}
    jobs: Dict[int, _PackedJob] = {}
    admit_ordinal = -1
    pending_fused: Dict[int, int] = {}      # step -> unmatched fused prefills
    prev_sid: Optional[int] = None
    sid_len: Dict[int, int] = {}
    sid_k: Dict[int, int] = {}
    sid_route: Dict[int, dict] = {}
    # accounting tallies
    n_prefill_unfused = 0
    n_prefill_fused = 0
    seq_valid = 0
    n_decode_plain = 0                      # unfused, sid == -1
    n_decode_fused = 0
    n_decode_events_nosid = 0               # any decode event with sid == -1

    for ei, ev in enumerate(trace.events):
        loc = f"event#{ei}@step{ev.get('step', '?')}"
        t = ev["type"]
        if t == "admit":
            admit_ordinal += 1
            wave = [(int(s), int(r), int(p)) for s, r, p in ev["wave"]]
            # schema v8: slots seeded from a KV snapshot start with their
            # restored prefix already covered — only the suffix prefills
            restored = {int(s): int(p) for s, _r, p
                        in ev.get("restores", [])}
            for s, rid, plen in wave:
                if s in slots:
                    findings.append(Finding(
                        "warning", "lifecycle",
                        f"slot {s} admitted while occupied by rid "
                        f"{slots[s].rid}", location=loc))
                st = _Slot(rid, max(plen - 1, 0))
                st.covered = min(restored.get(s, 0), st.need)
                st.ready = st.ready or st.covered >= st.need
                slots[s] = st
                rid_slot[rid] = s
            if pack and batched and any(
                    p - 1 > restored.get(s, 0) for s, _, p in wave):
                plan = plan_packed_job(
                    [(s, _DummyReq(p, restored.get(s, 0)))
                     for s, _, p in wave],
                    max_slots=max_slots, chunk=chunk,
                    sub_batch=admit_ordinal)
                if plan is not None:
                    jobs[admit_ordinal] = _PackedJob(plan)
                    # restored rows were scattered at admission, before
                    # the job's first dispatch gathers over them
                    jobs[admit_ordinal].cum_valid = \
                        sum(restored.values())
        elif t == "prefill":
            fused = bool(ev.get("fused", False))
            if fused:
                pending_fused[ev["step"]] = \
                    pending_fused.get(ev["step"], 0) + 1
                n_prefill_fused += 1
            else:
                n_prefill_unfused += 1
            seq_valid += int(ev["valid"])
            if ev.get("packed", False):
                job = jobs.get(int(ev.get("sub_batch", -1)))
                prefix_span = int(ev["kv"]) - int(ev["chunk"])
                if job is None:
                    findings.append(Finding(
                        "warning", "packed_plan",
                        f"packed prefill event for unknown sub_batch "
                        f"{ev.get('sub_batch')}", location=loc))
                else:
                    # in-dispatch scatter precedes the gather, so the
                    # prefix a dispatch attends must already be covered by
                    # the job's cumulative scattered tokens INCLUDING its
                    # own
                    scattered = job.cum_valid + int(ev["valid"])
                    j = job.events_seen
                    if j < job.n_dispatches \
                            and job.spans[j] == prefix_span:
                        prefix_span = job.extents[j]
                    if prefix_span > 0 and prefix_span > scattered:
                        findings.append(Finding(
                            "error", "gather_before_scatter",
                            f"packed dispatch attends a {prefix_span}-token "
                            f"cache prefix but its job has only scattered "
                            f"{scattered} tokens up to this dispatch",
                            location=loc))
                    job.cum_valid = scattered
                    job.events_seen += 1
                    if j < job.n_dispatches:
                        for s in job.completes[j]:
                            if s in slots:
                                slots[s].ready = True
                    else:
                        findings.append(Finding(
                            "warning", "packed_plan",
                            f"packed job {ev.get('sub_batch')} ran "
                            f"{job.events_seen} dispatches; the plan has "
                            f"{job.n_dispatches}", location=loc))
            else:
                # unpacked rows are contiguous prompt spans: coverage
                # advances to offset+chunk (sequential events record one
                # whole-prompt span: offset=0, chunk=valid)
                hi = int(ev["offset"]) + int(ev["chunk"])
                for s in ev["slots"]:
                    st = slots.get(int(s))
                    if st is None:
                        findings.append(Finding(
                            "warning", "lifecycle",
                            f"prefill event names unadmitted slot {s}",
                            location=loc))
                        continue
                    st.covered = max(st.covered, min(hi, st.need))
                    if st.covered >= st.need:
                        st.ready = True
        elif t == "decode":
            sid = int(ev.get("superstep_id", -1))
            k = int(ev.get("superstep", 1))
            fused = bool(ev.get("fused", False))
            # (a) active set must be decode-ready
            for s in ev["slots"]:
                st = slots.get(int(s))
                if st is None:
                    findings.append(Finding(
                        "warning", "lifecycle",
                        f"decode event activates unoccupied slot {s}",
                        location=loc))
                elif not st.ready:
                    findings.append(Finding(
                        "error", "decode_mid_prefill",
                        f"decode step activates slot {s} while rid "
                        f"{st.rid} is still mid-prefill", location=loc))
            # (b) parked write cursor: a mid-prefill slot's recorded length
            # must sit at max_len-1 in batched mode — anything else means
            # the decode dispatch moved its cursor into the prompt cache
            if batched and max_len > 0:
                lens = ev["slot_lens"]
                for s, st in slots.items():
                    if not st.ready and s < len(lens) \
                            and int(lens[s]) != parked:
                        findings.append(Finding(
                            "error", "decode_mid_prefill",
                            f"mid-prefill slot {s} (rid {st.rid}) has "
                            f"write cursor {lens[s]}, expected parked "
                            f"{parked} — decode is clobbering its prompt "
                            f"cache", location=loc))
            # (c) fused pairing: the decode half must find its prefill
            # twin recorded at the same step (one shared issue root)
            if fused:
                n_decode_fused += 1
                if pending_fused.get(ev["step"], 0) > 0:
                    pending_fused[ev["step"]] -= 1
                else:
                    findings.append(Finding(
                        "error", "fused_unpaired",
                        f"fused decode event has no fused prefill twin "
                        f"at step {ev['step']}", location=loc))
            # (d) superstep span structure
            if sid < 0:
                n_decode_events_nosid += 1
                if not fused:
                    n_decode_plain += 1
            else:
                if sid != prev_sid and sid in sid_len:
                    findings.append(Finding(
                        "error", "superstep_refetch",
                        f"superstep {sid} events are non-contiguous — "
                        f"its single fetch would have resolved twice",
                        location=loc))
                sid_len[sid] = sid_len.get(sid, 0) + 1
                if sid_len[sid] > k:
                    findings.append(Finding(
                        "error", "superstep_span",
                        f"superstep {sid} expanded into {sid_len[sid]} "
                        f"inner steps, more than its k={k}", location=loc))
                if cap_k and k > cap_k:
                    findings.append(Finding(
                        "error", "superstep_span",
                        f"superstep {sid} ran k={k} above the configured "
                        f"cap {cap_k}", location=loc))
                if sid in sid_k and sid_k[sid] != k:
                    findings.append(Finding(
                        "error", "superstep_span",
                        f"superstep {sid} events disagree on k "
                        f"({sid_k[sid]} vs {k})", location=loc))
                sid_k[sid] = k
                route = dict(ev.get("route", {}))
                if sid in sid_route and sid_route[sid] != route:
                    findings.append(Finding(
                        "error", "superstep_span",
                        f"superstep {sid} events disagree on the route "
                        f"decided at dispatch", location=loc))
                sid_route.setdefault(sid, route)
            prev_sid = sid
        elif t == "complete":
            rid = int(ev["rid"])
            s = rid_slot.pop(rid, None)
            if s is None or s not in slots or slots[s].rid != rid:
                findings.append(Finding(
                    "warning", "lifecycle",
                    f"complete event for unknown rid {rid}", location=loc))
            else:
                del slots[s]

    for step, n in pending_fused.items():
        if n:
            findings.append(Finding(
                "error", "fused_unpaired",
                f"{n} fused prefill event(s) at step {step} never met a "
                f"fused decode twin", location=f"step{step}"))

    findings.extend(_check_accounting(
        trace, sequential=not batched, seq_valid=seq_valid,
        n_prefill_unfused=n_prefill_unfused,
        n_prefill_fused=n_prefill_fused,
        n_decode_plain=n_decode_plain, n_decode_fused=n_decode_fused,
        n_decode_events_nosid=n_decode_events_nosid,
        n_supersteps=len(sid_len)))
    return findings


def _check_accounting(trace: Trace, *, sequential: bool, seq_valid: int,
                      n_prefill_unfused: int, n_prefill_fused: int,
                      n_decode_plain: int, n_decode_fused: int,
                      n_decode_events_nosid: int,
                      n_supersteps: int) -> List[Finding]:
    """Dispatch-count bookkeeping: the summary's counters must equal what
    the event timeline implies. Sequential prefill records ONE event per
    slot but one dispatch per token (valid), batched one event per
    dispatch; a superstep's k inner events are one dispatch and one fetch;
    a fused pair is one 'fused' dispatch, neither prefill nor decode."""
    out: List[Finding] = []
    summary = trace.summary
    if summary is None:
        return out
    counts = summary.get("dispatch_counts", {})
    expect = {
        "prefill": seq_valid if sequential else n_prefill_unfused,
        "decode": n_decode_plain + n_supersteps,
        "fused": n_decode_fused,
    }
    for key, want in expect.items():
        got = int(counts.get(key, 0))
        if got != want:
            out.append(Finding(
                "error", "dispatch_accounting",
                f"summary counts {got} {key} dispatches; the event "
                f"timeline implies {want}", location="summary"))
    if n_prefill_fused != n_decode_fused:
        out.append(Finding(
            "error", "dispatch_accounting",
            f"{n_prefill_fused} fused prefill events vs "
            f"{n_decode_fused} fused decode events", location="summary"))
    want_syncs = n_decode_events_nosid + n_supersteps
    got_syncs = int(summary.get("host_syncs", 0))
    if got_syncs != want_syncs:
        out.append(Finding(
            "error", "dispatch_accounting",
            f"summary counts {got_syncs} host syncs; the event timeline "
            f"implies {want_syncs} (one per plain decode resolve, one per "
            f"superstep fetch)", location="summary"))
    return out


__all__ = ["lint_trace"]
