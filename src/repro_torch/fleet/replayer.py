"""The fleet replayer: one arrival stream, N replicas, one fleet clock
(the port's own copy of ``repro/fleet/replayer.py``).

``serve_fleet`` is the multi-replica twin of ``trace.arrivals.drive``: a
global fleet clock ``t`` advances one tick per iteration; every arrival
whose step has been reached is routed (``fleet.router``) and injected
into its replica; every replica whose own engine clock has not run ahead of
the fleet clock steps once. A replica inside a decode superstep jumps its
engine clock k ticks in one dispatch and then sits out fleet ticks until
``t`` catches up — exactly how a solo open-loop serve experiences a
superstep.

That construction gives the dispatch-parity invariant the routing tests
pin: at every engine step, a replica's queue and slot state are identical
to serving its routed subset alone under ``drive`` (arrivals become
visible at the same engine-clock moments, with the same recorded
``arrival_offset``), so per-replica dispatch counts, host syncs and greedy
tokens match single-node serving exactly. The fleet adds routing, never
work.

All replicas share one ``params`` object; each engine owns its cache.
``device`` goes to every ``ServeEngine``: the card unless the caller asks
for ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.fleet.router import make_router
from repro_torch.obs.metrics import MetricsHub
from repro_torch.serve.engine import ServeEngine
from repro_torch.trace.arrivals import ArrivalEvent
from repro_torch.trace.recorder import TraceRecorder
from repro_torch.trace.schema import Trace


@dataclass
class FleetResult:
    """One fleet replay: per-node engines, recorders, hubs and traces,
    plus the routing assignment (gid = index into the arrival stream)."""
    replicas: int
    routing: str
    engines: Dict[int, ServeEngine]
    hubs: Dict[int, MetricsHub]
    traces: Dict[int, Trace]
    # gid -> (node, local rid): rids are PER-ENGINE (each replica numbers
    # its own requests from 0), so the fleet keys results by assignment
    assignments: List[Tuple[int, int, int]] = field(default_factory=list)
    # node -> {rid: generated tokens}, same shape drive() returns per node
    results: Dict[int, Dict[int, List[int]]] = field(default_factory=dict)

    @property
    def served(self) -> int:
        return sum(len(r) for r in self.results.values())

    def tokens_by_gid(self) -> Dict[int, List[int]]:
        """Generated tokens keyed by global arrival index — the
        routing-invariant view (same tokens whatever the policy)."""
        return {gid: self.results[node].get(rid, [])
                for gid, node, rid in self.assignments}


def serve_fleet(cfg, params, scfg, arrivals: List[ArrivalEvent], *,
                replicas: int = 2, routing: str = "round_robin",
                prefix_len: int = 8, max_steps: int = 100_000,
                device=None) -> FleetResult:
    """Serve one open-loop arrival stream through ``replicas`` engines
    behind the ``routing`` policy; returns per-node traces (schema v6,
    each passing the protocol lint on its own), live MetricsHubs, and the
    full routing assignment."""
    router = make_router(routing, replicas, prefix_len=prefix_len)
    fleet_desc = {"replicas": replicas, "routing": routing}
    engines: Dict[int, ServeEngine] = {}
    hubs: Dict[int, MetricsHub] = {}
    recs: Dict[int, TraceRecorder] = {}
    for node in range(replicas):
        hub = MetricsHub()
        rec = TraceRecorder(sinks=[hub], node_id=node, fleet=fleet_desc)
        engines[node] = ServeEngine(cfg, params, scfg, recorder=rec,
                                    device=device)
        hubs[node], recs[node] = hub, rec

    pending = sorted(range(len(arrivals)), key=lambda g: arrivals[g].step)
    assignments: List[Tuple[int, int, int]] = []
    results: Dict[int, Dict[int, List[int]]] = {n: {} for n in engines}
    ordered = [engines[n] for n in range(replicas)]
    i = 0
    for t in range(max_steps):
        while i < len(pending) and arrivals[pending[i]].step <= t:
            gid = pending[i]
            a = arrivals[gid]
            node = router.route(a.prompt, ordered)
            rid = engines[node].add_request(a.prompt, a.max_new,
                                            arrival_step=a.step, gid=gid)
            assignments.append((gid, node, rid))
            i += 1
        if i >= len(pending) and all(
                not e.queue and all(r is None for r in e.slot_req)
                for e in engines.values()):
            traces = {n: recs[n].to_trace() for n in engines}
            return FleetResult(replicas=replicas, routing=router.name,
                               engines=engines, hubs=hubs, traces=traces,
                               assignments=assignments, results=results)
        for node, eng in engines.items():
            # an engine whose superstep ran its clock past the fleet clock
            # sits this tick out — its dispatch already covered it
            if eng.step_idx <= t:
                for rid, tok in eng.step():
                    results[node].setdefault(rid, []).append(tok)
    raise RuntimeError(f"fleet workload did not drain in {max_steps} ticks")


__all__ = ["FleetResult", "serve_fleet"]
