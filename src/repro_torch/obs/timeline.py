"""Chrome/Perfetto trace-event export for served workloads and replays.

The port's own copy of ``repro/obs/timeline.py``.

Renders a recorded serving trace (``trace.Trace``) — and optionally its
simulator replay — into the Trace Event Format JSON that chrome://tracing
and https://ui.perfetto.dev load directly (``write_chrome_trace``).

Engine timeline (pid "serving engine", timebase: 1 engine-clock tick =
``TICK_US`` trace microseconds; several dispatches issued within one tick
subdivide it in issue order):

  NPU prefill   one slice per standalone prefill chunk dispatch
  PIM decode    one slice per plain decode dispatch; a decode SUPERSTEP is
                one outer slice spanning its k ticks (the dispatch) with k
                nested 1-tick round slices (the superstep's rounds)
  fused step    a fused prefill+decode pair renders as ONE slice — it was
                one device program, so the timeline shows one span, not two
  host fetch    one "resolve" slice per blocking device->host fetch, tied
                to its dispatch slice by a flow arrow (the double-buffered
                fetch window; a superstep's k rounds share one resolve —
                the amortization is visible as k slices feeding one flow)
  slots         per-slot lanes: one slice per resident request, admit ->
                completion
  counters      queue_depth / slots_busy counter tracks stepped at every
                arrival, admission and completion

Every slice that stands for a host dispatch carries ``cat="dispatch"`` —
the test suite (and the ``launch.stats`` coverage check) counts them
against the trace summary's dispatch totals, so the timeline provably
covers every recorded dispatch. Superstep inner rounds are ``cat="round"``
(k rounds, one dispatch), host resolves ``cat="fetch"``.

Simulator timeline (``sim_events``, pid "simulator"): every
``SimResult.trace`` span (start, end, unit, name, tag) — per-core MU/VU/DMA
engines and the PIM array — becomes a slice on its unit's track, so a
``TraceReplayer`` replay of the same trace (merged fused groups and
pipelined superstep spans included) drops into the SAME trace.json beside
the engine timeline.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

TICK_US = 1_000.0      # one engine-clock tick, in trace microseconds
PID_ENGINE = 1
PID_SLOTS = 2
PID_SIM = 3

# fleet export (``fleet_events``): one process GROUP per node, pids strided
# so Perfetto sorts node 0's engine/slots/sim tracks together, node 1's
# next, ... with the fleet-level counter process on top
PID_FLEET = 9
NODE_PID_STRIDE = 10

_TID_PREFILL = 1
_TID_DECODE = 2
_TID_FUSED = 3
_TID_FETCH = 4


def fleet_node_pids(node: int) -> tuple:
    """(engine, slots, sim) pids for one fleet node's track group."""
    base = NODE_PID_STRIDE * (int(node) + 1)
    return base, base + 1, base + 2


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None, sort: Optional[int] = None) -> List[dict]:
    out = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": tname}})
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": sort if sort is not None else tid}})
    return out


def _slice(name: str, ts: float, dur: float, tid: int, *, pid: int = PID_ENGINE,
           cat: str = "dispatch", args: Optional[dict] = None) -> dict:
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
          "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


class _TickLayout:
    """Sequential layout of the dispatches issued within one engine tick:
    the n-th dispatch of a tick occupies the n-th equal sub-window, in
    event order (the order the host issued them)."""

    def __init__(self):
        self._counts: Dict[int, int] = {}     # step -> dispatches recorded

    def place(self, step: int) -> int:
        i = self._counts.get(step, 0)
        self._counts[step] = i + 1
        return i

    def window(self, step: int, i: int) -> tuple:
        n = max(self._counts.get(step, 1), 1)
        width = TICK_US / n
        return step * TICK_US + i * width, width


def engine_events(trace, *, pid_engine: int = PID_ENGINE,
                  pid_slots: int = PID_SLOTS,
                  label: str = "serving engine",
                  slots_label: str = "slots") -> List[dict]:
    """Trace-event list for one recorded serving trace. ``pid_engine`` /
    ``pid_slots`` relocate the track group so ``fleet_events`` can lay N
    replicas' timelines side by side in one trace.json."""
    events: List[dict] = []
    events += _meta(pid_engine, label, _TID_PREFILL, "NPU prefill")
    events += _meta(pid_engine, label, _TID_DECODE, "PIM decode")
    events += _meta(pid_engine, label, _TID_FUSED,
                    "fused step (NPU+PIM)")
    events += _meta(pid_engine, label, _TID_FETCH, "host fetch")
    events += _meta(pid_slots, slots_label)

    # pass 1: count dispatch slices per (step, track) so co-issued work
    # subdivides its tick; fused pairs place ONE slice, superstep rounds
    # place on their own ticks
    layouts = {t: _TickLayout() for t in (_TID_PREFILL, _TID_DECODE,
                                          _TID_FUSED)}
    placed: List[tuple] = []      # (event, tid, step, slot_index)
    fused_decode_seen = set()     # steps whose fused pair is already placed
    superstep_rounds: Dict[int, List[dict]] = {}   # sid -> inner events
    for ev in trace.events:
        t = ev["type"]
        if t == "prefill":
            if ev.get("fused", False):
                continue          # the decode twin places the fused slice
            tid = _TID_PREFILL
        elif t == "decode":
            sid = int(ev.get("superstep_id", -1))
            if sid >= 0:
                superstep_rounds.setdefault(sid, []).append(ev)
                continue          # placed after the span is known
            tid = _TID_FUSED if ev.get("fused", False) else _TID_DECODE
        else:
            continue
        step = int(ev["step"])
        placed.append((ev, tid, step, layouts[tid].place(step)))
    for sid, rounds in superstep_rounds.items():
        # the superstep dispatch slice claims the first inner round's tick
        step = int(rounds[0]["step"])
        placed.append((rounds, _TID_DECODE, step,
                       layouts[_TID_DECODE].place(step)))

    flow_id = 0
    for ev, tid, step, i in placed:
        if isinstance(ev, list):          # a superstep span
            rounds = ev
            ts, width = layouts[tid].window(step, i)
            k = int(rounds[0].get("superstep", len(rounds)))
            end = (int(rounds[-1]["step"]) + 1) * TICK_US
            events.append(_slice(
                f"superstep x{k}", ts, end - ts, tid, pid=pid_engine,
                args={"step": step, "k": k, "rounds": len(rounds),
                      "superstep_id": int(rounds[0]["superstep_id"])}))
            for r in rounds:
                rts = int(r["step"]) * TICK_US
                events.append(_slice(
                    "decode round", max(rts, ts), TICK_US - max(ts - rts, 0),
                    tid, pid=pid_engine, cat="round",
                    args={"step": int(r["step"]),
                          "occupancy": int(r["occupancy"]),
                          "tokens": len(r["tokens"])}))
            flow_id += 1
            events += _fetch(flow_id, ts, end, tid,
                             {"kind": "superstep", "rounds": len(rounds)},
                             pid=pid_engine)
            continue
        ts, width = layouts[tid].window(step, i)
        if ev["type"] == "prefill":
            name = "prefill (packed)" if ev.get("packed") else "prefill"
            events.append(_slice(
                name, ts, width, tid, pid=pid_engine,
                args={"step": step, "offset": int(ev["offset"]),
                      "chunk": int(ev["chunk"]), "valid": int(ev["valid"]),
                      "kv": int(ev["kv"]), "rows": int(ev.get("rows", 0)),
                      "slots": list(ev["slots"]),
                      "overlap": bool(ev.get("overlap", False))}))
            continue
        if tid == _TID_FUSED:
            if step in fused_decode_seen:
                continue
            fused_decode_seen.add(step)
            name, kind = "fused prefill+decode", "fused"
        else:
            name, kind = "decode", "decode"
        events.append(_slice(
            name, ts, width, tid, pid=pid_engine,
            args={"step": step, "occupancy": int(ev["occupancy"]),
                  "tokens": len(ev["tokens"]),
                  "overlap": bool(ev.get("overlap", False))}))
        flow_id += 1
        events += _fetch(flow_id, ts, ts + width, tid, {"kind": kind},
                         pid=pid_engine)

    events += _lifecycle_events(trace, pid_engine=pid_engine,
                                pid_slots=pid_slots, slots_label=slots_label)
    return events


def _fetch(flow_id: int, dispatch_ts: float, resolve_end: float,
           dispatch_tid: int, args: dict,
           pid: int = PID_ENGINE) -> List[dict]:
    """The async-fetch flow: a flow arrow from the dispatch slice to the
    blocking resolve slice on the host-fetch track (one per host sync)."""
    rdur = TICK_US / 8
    rts = resolve_end - rdur
    return [
        {"ph": "s", "name": "fetch", "cat": "fetch", "id": flow_id,
         "pid": pid, "tid": dispatch_tid, "ts": dispatch_ts},
        _slice("resolve", rts, rdur, _TID_FETCH, pid=pid, cat="fetch",
               args=args),
        {"ph": "f", "name": "fetch", "cat": "fetch", "id": flow_id,
         "bp": "e", "pid": pid, "tid": _TID_FETCH, "ts": rts},
    ]


def _lifecycle_events(trace, *, pid_engine: int = PID_ENGINE,
                      pid_slots: int = PID_SLOTS,
                      slots_label: str = "slots") -> List[dict]:
    """Per-slot residency slices + queue/occupancy counter tracks."""
    events: List[dict] = []
    admit_step: Dict[int, tuple] = {}     # rid -> (slot, step, plen)
    arrival: Dict[int, int] = {}
    queue_depth, slots_busy = 0, 0
    horizon = 0

    def counters(step: int) -> None:
        events.append({"ph": "C", "name": "queue_depth", "pid": pid_engine,
                       "tid": 0, "ts": step * TICK_US,
                       "args": {"queued": queue_depth}})
        events.append({"ph": "C", "name": "slots_busy", "pid": pid_engine,
                       "tid": 0, "ts": step * TICK_US,
                       "args": {"busy": slots_busy}})

    for ev in trace.events:
        t = ev["type"]
        step = int(ev["step"])
        horizon = max(horizon, step)
        if t == "request":
            arrival[ev["rid"]] = step - int(ev.get("arrival_offset", 0))
            queue_depth += 1
            counters(step)
        elif t == "admit":
            for slot, rid, plen in ev["wave"]:
                admit_step[rid] = (int(slot), step, int(plen))
                queue_depth -= 1
                slots_busy += 1
            counters(step)
        elif t == "complete":
            rid = int(ev["rid"])
            slots_busy -= 1
            counters(step)
            if rid in admit_step:
                slot, s0, plen = admit_step.pop(rid)
                events.append(_slice(
                    f"rid {rid}", s0 * TICK_US, (step + 1 - s0) * TICK_US,
                    slot, pid=pid_slots, cat="request",
                    args={"rid": rid, "prompt_len": plen,
                          "queue_wait": s0 - arrival.get(rid, s0),
                          "reason": ev["reason"],
                          "n_generated": int(ev["n_generated"])}))
    # requests still resident at end-of-trace close at the horizon
    for rid, (slot, s0, plen) in admit_step.items():
        events.append(_slice(
            f"rid {rid}", s0 * TICK_US, (horizon + 1 - s0) * TICK_US, slot,
            pid=pid_slots, cat="request",
            args={"rid": rid, "prompt_len": plen, "reason": "open"}))
    for slot in sorted({e["tid"] for e in events
                        if e.get("pid") == pid_slots and e["ph"] == "X"}):
        events += _meta(pid_slots, slots_label, slot, f"slot {slot}")
    return events


def sim_events(result, *, scale: float = 1e6,
               pid: int = PID_SIM, name: str = "simulator") -> List[dict]:
    """Trace-event list for a ``SimResult`` recorded with
    ``SimConfig(trace=True)`` — one slice per command span on its execution
    unit's track (per-core MU/VU/DMA engines, the PIM array). ``scale``
    converts simulator seconds to trace microseconds."""
    if not result.trace:
        raise ValueError("SimResult has no event trace; run the simulator "
                         "with SimConfig(trace=True)")
    events: List[dict] = _meta(pid, name)
    units = sorted({u for _s, _e, u, _n, _t in result.trace})
    tids = {u: i + 1 for i, u in enumerate(units)}
    for u in units:
        events += _meta(pid, name, tids[u], u)
    for s, e, u, cname, tag in result.trace:
        events.append(_slice(cname, s * scale, max(e - s, 0.0) * scale,
                             tids[u], pid=pid, cat="sim",
                             args={"unit": u, "tag": tag}))
    return events


def dispatch_slices(events: List[dict], pid: int = PID_ENGINE) -> List[dict]:
    """The slices standing for host dispatches (the coverage contract:
    exactly one per dispatch the trace summary counts). ``pid`` selects
    which node's engine track to count in a fleet export."""
    return [e for e in events if e["ph"] == "X" and e.get("cat") == "dispatch"
            and e.get("pid") == pid]


def fleet_events(traces: Dict[int, object],
                 replays: Optional[Dict[int, object]] = None) -> List[dict]:
    """One trace.json for a whole fleet: a process group per node (engine
    dispatch/fetch lanes, slot lanes, and — when ``replays`` carries that
    node's ``SimResult`` — its simulator tracks), topped by a fleet-level
    queue-depth counter summed over all replicas. Idle replicas show up as
    empty tracks next to busy ones — routing pathologies at a glance.

    ``traces`` maps node_id -> ``trace.Trace``; every node shares the fleet
    global tick, so slices line up across track groups without shifting."""
    from repro_torch.obs.metrics import Gauge

    events: List[dict] = []
    events += _meta(PID_FLEET, "fleet")
    fleet_queue = Gauge("fleet_queue_depth")
    for node in sorted(traces):
        trace = traces[node]
        pid_engine, pid_slots, pid_sim = fleet_node_pids(node)
        events += engine_events(trace, pid_engine=pid_engine,
                                pid_slots=pid_slots,
                                label=f"node {node} · serving engine",
                                slots_label=f"node {node} · slots")
        if replays and node in replays and replays[node] is not None:
            events += sim_events(replays[node], pid=pid_sim,
                                 name=f"node {node} · simulator")
        # per-node queue-depth step function off the same lifecycle events
        # the per-node counter tracks render; merging sums over the fleet
        # clock (exactly Gauge.merge semantics)
        g = Gauge(f"node{node}")
        depth = 0
        for ev in trace.events:
            if ev["type"] == "request":
                depth += 1
            elif ev["type"] == "admit":
                depth -= len(ev["wave"])
            else:
                continue
            g.set(int(ev["step"]), depth)
        fleet_queue.merge(g)
    for t, v in fleet_queue.series:
        events.append({"ph": "C", "name": "fleet_queue_depth",
                       "pid": PID_FLEET, "tid": 0, "ts": t * TICK_US,
                       "args": {"queued": v}})
    return events


def write_chrome_trace(path, events: List[dict]) -> None:
    """Write a Perfetto/chrome://tracing-loadable trace.json."""
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


__all__ = ["TICK_US", "PID_ENGINE", "PID_SLOTS", "PID_SIM", "PID_FLEET",
           "NODE_PID_STRIDE", "fleet_node_pids", "engine_events",
           "sim_events", "fleet_events", "dispatch_slices",
           "write_chrome_trace"]
