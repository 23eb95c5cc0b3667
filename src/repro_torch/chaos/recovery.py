"""Failover recovery: re-prefill crashed work on surviving replicas (the
port's own copy of ``repro/chaos/recovery.py``).

``serve_fleet_chaos`` is ``fleet.replayer.serve_fleet`` under a
``FaultPlan``: the same global fleet clock, the same routing, the same
engines — plus deterministic fault transitions and an exactly-once
recovery loop. With an empty plan it reproduces ``serve_fleet``
tick-for-tick (same routing decisions, same dispatches, same tokens).

Recovery protocol (per crashed node, at the crash tick):

1. The node's in-flight requests — queued AND resident, completed ones
   excluded — are captured. Generated-so-far prefixes are reconstructed
   from the node's RECORDED EVENT STREAM (decode events carry
   ``[rid, tok]`` pairs; complete events retire rids) and cross-checked
   against the engine's host state: the trace alone must be enough to
   recover from, or replaying a recorded crash couldn't work.
2. Each captured request re-enters the router (health-aware: the dead
   node has left the ring) after a clamped exponential backoff —
   ``min(backoff * 2**(retry-1), backoff_cap)`` ticks — and is recovered
   on its new node with the remaining budget. With snapshots enabled
   (``snapshot_interval > 0``) the newest durable ``SnapshotStore``
   record seeds the survivor's slot with the checkpointed KV prefix and
   only the UNCHECKPOINTED suffix re-prefills; without one (crash before
   the first snapshot, or a non-durable record) the full
   prompt + generated-prefix re-prefills from zero. Greedy decode is
   prefix-deterministic and KV rows are a pure function of the token
   sequence, so either path continues bit-identical to the fault-free
   run; the fleet pays only the suffix FLOPs (``reprefill_tokens``; the
   checkpointed part is ``restored_tokens``), never wrong tokens.
3. Every request completes on EXACTLY ONE node or is recorded as
   terminal ``failed``/``reject`` — nothing is silently dropped. The
   retry budget bounds the loop; prompt+prefix overflowing the KV cache
   is a terminal ``failed`` too (re-prefill cannot represent it).

``verify.check_exactly_once`` audits all three guarantees from
the recorded traces alone.

The engines share one ``params`` object and each owns its cache;
``device`` goes to every ``ServeEngine`` (the card unless the caller asks
for ``device="cpu"``). Greedy decode is prefix-deterministic in exact
arithmetic; on the card in bf16 a survivor's re-prefill (flash and a
matmul) rounds otherwise than the crashed node's decode steps did (the
GEMV and decode attention), so token identity after failover holds in
float32 and may part in bf16.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.chaos.faults import FaultPlan, FleetHealth
from repro_torch.chaos.snapshots import SnapshotStore
from repro_torch.fleet.router import make_router
from repro_torch.obs.metrics import MetricsHub
from repro_torch.serve.engine import AdmissionRejected, ServeEngine
from repro_torch.trace.arrivals import ArrivalEvent
from repro_torch.trace.recorder import TraceRecorder
from repro_torch.trace.schema import Trace


def inflight_from_events(events: List[dict]) -> Dict[int, List[int]]:
    """Generated-so-far tokens per rid for every request still in flight,
    reconstructed purely from a recorder's event stream: request events
    open a rid, decode events append its sampled tokens, complete events
    retire it. This is the recovery source of truth — a crashed node's
    streamed trace is sufficient to fail its work over."""
    gen: Dict[int, List[int]] = {}
    for ev in events:
        t = ev.get("type")
        if t == "request":
            gen.setdefault(ev["rid"], [])
        elif t == "decode":
            for rid, tok in ev["tokens"]:
                if rid in gen:
                    gen[rid].append(tok)
        elif t == "complete":
            gen.pop(ev["rid"], None)
    return gen


@dataclass
class RecoveryItem:
    """One request awaiting (re)placement: either failover work from a
    crash (``from_node``/``crash_step`` set, possibly with a generated
    prefix) or a backoff-retrying rejected arrival."""
    gid: int
    prompt: np.ndarray          # ORIGINAL prompt, prefix kept separate
    max_new: int
    arrival_step: int
    generated: List[int] = field(default_factory=list)
    retry: int = 0              # placement attempts so far
    from_node: Optional[int] = None
    crash_step: Optional[int] = None

    @property
    def crash_origin(self) -> bool:
        return self.from_node is not None


@dataclass
class ChaosResult:
    """One chaos replay: everything ``FleetResult`` carries, plus the
    fault plan, terminal failures/rejections, and recovery bookkeeping."""
    replicas: int
    routing: str
    plan: FaultPlan
    engines: Dict[int, ServeEngine]
    hubs: Dict[int, MetricsHub]
    traces: Dict[int, Trace]
    # every successful placement, in order: (gid, node, rid) — a recovered
    # gid appears once per node that ever held it
    assignments: List[Tuple[int, int, int]] = field(default_factory=list)
    # node -> {rid: tokens generated ON that node}
    results: Dict[int, Dict[int, List[int]]] = field(default_factory=dict)
    # gid -> (node, rid, prefix carried into the final placement)
    placements: Dict[int, Tuple[int, int, List[int]]] = \
        field(default_factory=dict)
    failed: Dict[int, str] = field(default_factory=dict)    # gid -> reason
    rejected: Dict[int, str] = field(default_factory=dict)  # gid -> reason
    recoveries: List[dict] = field(default_factory=list)
    # SnapshotStore.summary() when snapshots were enabled, else None
    snapshots: Optional[dict] = None

    @property
    def served(self) -> int:
        return sum(len(r) for r in self.results.values())

    def tokens_by_gid(self) -> Dict[int, List[int]]:
        """End-to-end generated tokens per completed-or-served arrival:
        carried prefix + the final node's continuation. This is the view
        the token-identity guarantee is stated over — equal, gid by gid,
        to the fault-free run's for every request that completed."""
        out = {}
        for gid, (node, rid, prefix) in self.placements.items():
            out[gid] = list(prefix) + self.results[node].get(rid, [])
        return out


def serve_fleet_chaos(cfg, params, scfg, arrivals: List[ArrivalEvent],
                      plan: FaultPlan, *, replicas: int = 2,
                      routing: str = "round_robin", prefix_len: int = 8,
                      retry_budget: int = 3, backoff: int = 1,
                      backoff_cap: int = 64, snapshot_interval: int = 0,
                      snapshot_mirror: bool = False, snapshot_dir=None,
                      stream_dir=None, max_steps: int = 100_000,
                      device=None) -> ChaosResult:
    """Serve one open-loop arrival stream through ``replicas`` engines
    under ``plan``. Deterministic end to end: same (workload seed, plan,
    routing) ⇒ identical fault schedule, routing decisions, recovery
    placements and greedy tokens. ``stream_dir`` turns on crash-safe
    per-node JSONL streaming (``node<N>.jsonl``). ``snapshot_interval``
    > 0 turns on incremental KV snapshots every that many fleet ticks —
    mirrored to a ring peer with ``snapshot_mirror``, disk-backed under
    ``snapshot_dir`` — so failover re-prefills only the suffix past the
    newest durable snapshot."""
    if retry_budget < 1:
        raise ValueError(f"retry_budget must be >= 1, got {retry_budget}")
    if backoff < 1:
        raise ValueError(f"backoff must be >= 1, got {backoff}")
    if backoff_cap < backoff:
        raise ValueError(
            f"backoff_cap ({backoff_cap}) must be >= backoff ({backoff})")
    plan.validate(replicas)
    router = make_router(routing, replicas, prefix_len=prefix_len)
    health = FleetHealth(replicas)
    store = SnapshotStore(root=snapshot_dir) if snapshot_interval > 0 \
        else None
    fleet_desc = {"replicas": replicas, "routing": routing}
    chaos_desc = {"plan": plan.to_dict(), "retry_budget": retry_budget,
                  "backoff": backoff, "backoff_cap": backoff_cap,
                  "snapshot_interval": snapshot_interval,
                  "snapshot_mirror": bool(snapshot_mirror)}
    engines: Dict[int, ServeEngine] = {}
    hubs: Dict[int, MetricsHub] = {}
    recs: Dict[int, TraceRecorder] = {}
    for node in range(replicas):
        hub = MetricsHub()
        path = None if stream_dir is None \
            else f"{stream_dir}/node{node}.jsonl"
        rec = TraceRecorder(sinks=[hub], node_id=node, fleet=fleet_desc,
                            chaos=chaos_desc, stream_path=path)
        engines[node] = ServeEngine(cfg, params, scfg, recorder=rec,
                                    device=device)
        hubs[node], recs[node] = hub, rec

    res = ChaosResult(replicas=replicas, routing=router.name, plan=plan,
                      engines=engines, hubs=hubs, traces={},
                      results={n: {} for n in engines})
    ordered = [engines[n] for n in range(replicas)]
    # retry queue: (due_tick, gid, item) — processed in (due, gid) order
    waiting: List[Tuple[int, int, RecoveryItem]] = []
    begins = list(plan.events)                # sorted (step, node, kind)
    ends = sorted((e for e in plan.events if e.until is not None),
                  key=lambda e: (e.until, e.node, e.kind))
    bi = ei = 0

    def reporter():
        """Recorder that books fleet-level terminal events: the lowest-id
        alive node's — the fleet's view has to live somewhere durable."""
        node = min(n for n in engines if health.alive(n))
        return recs[node]

    def terminal(t: int, item: RecoveryItem, reason: str) -> None:
        if item.crash_origin:
            res.failed[item.gid] = reason
            reporter().on_failed(t, item.gid, reason, item.retry)
        else:
            res.rejected[item.gid] = reason
            reporter().on_reject(t, item.gid, reason, item.retry)

    def place(t: int, item: RecoveryItem) -> None:
        """Route + admit one item; on rejection, back off exponentially
        until the retry budget runs out."""
        full = np.concatenate([np.asarray(item.prompt, np.int32),
                               np.asarray(item.generated, np.int32)]) \
            if item.generated else np.asarray(item.prompt, np.int32)
        if len(full) > scfg.max_len - 1:
            # prompt+prefix no longer fits the KV cache: re-prefill cannot
            # represent this request — terminal, recorded, not dropped
            terminal(t, item, "prompt_overflow")
            return
        item.retry += 1
        node = router.route(full, ordered, health=health)
        eng = engines[node]
        # newest durable snapshot covering this request: seed the
        # survivor's slot with its [0, prefix_len) KV rows and re-prefill
        # only the suffix; fall back to from-zero when none covers it
        restore = None
        if (store is not None and item.crash_origin
                and eng.snapshot_supported):
            rec = store.lookup(item.gid)
            if (rec is not None and rec["cache"] is not None
                    and 0 < rec["prefix_len"] <= len(full) - 1):
                restore = {"prefix_len": rec["prefix_len"],
                           "cache": rec["cache"], "bytes": rec["bytes"],
                           "snapshot_step": rec["tick"]}
        try:
            cap = health.reject_cap(node)
            if cap is not None and len(eng.queue) >= cap:
                raise AdmissionRejected(
                    f"queue_reject fault window (cap={cap})")
            rid = eng.add_request(full, item.max_new - len(item.generated),
                                  arrival_step=item.arrival_step,
                                  gid=item.gid, restore=restore)
        except AdmissionRejected:
            if item.retry >= retry_budget:
                terminal(t, item, "retry_budget")
            else:
                due = t + min(backoff * 2 ** (item.retry - 1), backoff_cap)
                waiting.append((due, item.gid, item))
            return
        res.assignments.append((item.gid, node, rid))
        res.placements[item.gid] = (node, rid, list(item.generated))
        if item.crash_origin:
            restored = restore["prefix_len"] if restore is not None else 0
            if store is not None:
                if restore is not None:
                    # the new owner extends this record's deltas
                    store.reassign(item.gid, node)
                else:
                    # from-zero fallback: any stale record is void
                    store.drop(item.gid)
            recs[node].on_recover(t, item.gid, rid, item.from_node,
                                  item.crash_step, len(item.generated),
                                  int(len(full)) - restored, item.retry,
                                  restored_tokens=restored)
            res.recoveries.append({
                "step": t, "gid": item.gid, "rid": rid, "node": node,
                "from_node": item.from_node, "crash_step": item.crash_step,
                "prefix_tokens": len(item.generated),
                "reprefill_tokens": int(len(full)) - restored,
                "restored_tokens": restored,
                "snapshot_step": restore["snapshot_step"]
                if restore is not None else None,
                "retry": item.retry})

    def crash(t: int, node: int) -> None:
        eng, rec = engines[node], recs[node]
        # the event stream is the recovery source of truth; the engine's
        # host state must agree or the recorded trace couldn't replay
        from_events = inflight_from_events(rec.events)
        state = eng.export_recovery_state()
        ev_view = {d["rid"]: from_events.get(d["rid"], []) for d in state}
        host_view = {d["rid"]: list(d["generated"]) for d in state}
        assert ev_view == host_view, \
            f"node {node} event stream disagrees with engine state"
        gid_of = {e["rid"]: e.get("gid", e["rid"]) for e in rec.events
                  if e.get("type") == "request"}
        eng.halt()
        rec.on_fault(t, "node_crash", "begin", inflight=len(state))
        if store is not None:
            # apply the crash to snapshot durability: disk-backed records
            # go lazy-reload, mirrored ones survive, the rest are gone
            store.drop_node(node, alive=health.alive)
        for d in state:
            gid = gid_of[d["rid"]]
            item = RecoveryItem(gid=gid, prompt=d["prompt"],
                                max_new=d["max_new"],
                                arrival_step=t,
                                generated=list(d["generated"]),
                                from_node=node, crash_step=t)
            # prior placement is void: the request is in flight again
            res.placements.pop(gid, None)
            waiting.append((t + min(backoff, backoff_cap), gid, item))

    pending = sorted(range(len(arrivals)), key=lambda g: arrivals[g].step)
    i = 0
    next_ok = [0] * replicas        # slow_node: earliest tick of next step
    for t in range(max_steps):
        # 1. fault transitions due this tick (ends before begins so a
        #    window ending at t frees the node before a new one starts)
        while ei < len(ends) and ends[ei].until <= t:
            ev = ends[ei]
            health.end(ev)
            if health.alive(ev.node):
                if ev.kind == "pim_degraded":
                    engines[ev.node].set_degraded(False)
                recs[ev.node].on_fault(t, ev.kind, "end", since=ev.step)
            ei += 1
        while bi < len(begins) and begins[bi].step <= t:
            ev = begins[bi]
            bi += 1
            if not health.alive(ev.node):
                continue            # faults on a dead node are moot
            if ev.kind == "node_crash":
                health.begin(ev)
                crash(t, ev.node)
                continue
            health.begin(ev)
            recs[ev.node].on_fault(t, ev.kind, "begin", until=ev.until)
            if ev.kind == "pim_degraded":
                engines[ev.node].set_degraded(True)
        # 2. due retries/failovers, deterministic (due, gid) order
        due_now = sorted(w for w in waiting if w[0] <= t)
        waiting[:] = [w for w in waiting if w[0] > t]
        for _, _, item in due_now:
            place(t, item)
        # 3. new arrivals whose step has been reached
        while i < len(pending) and arrivals[pending[i]].step <= t:
            gid = pending[i]
            a = arrivals[gid]
            place(t, RecoveryItem(gid=gid, prompt=a.prompt,
                                  max_new=a.max_new, arrival_step=a.step))
            i += 1
        # 4. drain check: nothing pending anywhere on the alive fleet,
        #    and every scheduled fault window has opened AND closed (the
        #    schedule is part of the run — end events must be recorded)
        if (i >= len(pending) and not waiting
                and bi >= len(begins) and ei >= len(ends) and all(
                    not e.queue and all(r is None for r in e.slot_req)
                    for n, e in engines.items() if health.alive(n))):
            break
        # 5. step every alive engine the fleet clock has caught up with;
        #    a slow_node window makes each step cost `factor` ticks
        for node, eng in engines.items():
            if not health.alive(node):
                continue
            if eng.step_idx <= t and t >= next_ok[node]:
                for rid, tok in eng.step():
                    res.results[node].setdefault(rid, []).append(tok)
                next_ok[node] = t + health.step_cost(node)
        # 6. snapshot tick: every alive node exports the KV delta of its
        #    ready slots since its last snapshot. A node that crashed at
        #    this tick halted in phase 1, so every record it owns has
        #    tick < its crash tick — snapshots strictly happen-before the
        #    crashes they recover.
        if store is not None and t > 0 and t % snapshot_interval == 0:
            for node, eng in engines.items():
                if not health.alive(node) or not eng.snapshot_supported:
                    continue
                entries = eng.export_kv_snapshot(since=store.since(node))
                if not entries:
                    continue
                mirror = None
                if snapshot_mirror:
                    for k in range(1, replicas):
                        peer = (node + k) % replicas
                        if health.alive(peer):
                            mirror = peer
                            break
                store.put(node, entries, tick=t, mirror_node=mirror)
                for e in entries:
                    recs[node].on_snapshot(
                        t, gid=e["gid"], rid=e["rid"], slot=e["slot"],
                        base=e["base"], prefix_len=e["prefix_len"],
                        nbytes=e["bytes"], durable=store.disk_backed,
                        mirror_node=mirror)
    else:
        raise RuntimeError(
            f"chaos workload did not drain in {max_steps} ticks")
    if store is not None:
        res.snapshots = store.summary()
    res.traces = {n: recs[n].to_trace() for n in engines}
    for n in engines:
        recs[n].close()
    return res


__all__ = ["ChaosResult", "RecoveryItem", "inflight_from_events",
           "serve_fleet_chaos"]
