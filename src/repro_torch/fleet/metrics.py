"""FleetMetrics: lossless aggregation of per-replica MetricsHubs (the
port's own copy of ``repro/fleet/metrics.py``).

Keeps one ``MetricsHub`` per node (rids are per-engine, so request
lifecycles stay node-local) and merges the metric REGISTRIES on demand via
``MetricsHub.merge``: counters add, histogram samples concatenate (fleet
percentiles are EXACTLY ``np.percentile`` over all replicas' raw samples —
no bucketing error), and gauges sum as step functions over the shared
fleet clock (queue depth / slot occupancy across replicas is the sum of
their per-tick step functions, not an average of their change samples).

On top of the merged registry:

  imbalance      per-node request share plus max/min queue-depth spread —
                 the numbers that separate a balanced fleet from one hot
                 replica and N-1 idle ones
  utilization    per-node simulator replays (``add_replay``: anything
                 with ``makespan`` and ``result.group_utilization``)
                 rolled up into per-node and fleet NPU (MU) / PIM
                 utilization, weighted by each node's simulated makespan;
                 None until a replay is added

Feeding is symmetric with single-node observability: ``add`` takes a live
hub straight from a ``serve_fleet`` run; ``from_traces`` ingests recorded
JSONL traces offline through the exact same MetricsHub code path, so
live and offline fleet reports cannot diverge.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsHub


class FleetMetrics:
    def __init__(self):
        self.hubs: Dict[int, MetricsHub] = {}
        self.replays: Dict[int, object] = {}     # node -> ReplayResult

    # ---- feeding ----------------------------------------------------------- #
    def add(self, node_id: int, hub: MetricsHub) -> "FleetMetrics":
        if node_id in self.hubs:
            raise ValueError(f"node {node_id} already added")
        self.hubs[int(node_id)] = hub
        return self

    def add_replay(self, node_id: int, replay) -> "FleetMetrics":
        """Attach a node's ``TraceReplayer`` result for the NPU/PIM
        utilization rollup."""
        if node_id not in self.hubs:
            raise ValueError(f"no hub for node {node_id}")
        self.replays[int(node_id)] = replay
        return self

    @classmethod
    def from_traces(cls, traces) -> "FleetMetrics":
        """Offline path: ``traces`` maps node_id -> loaded ``Trace`` (or is
        an iterable of traces, keyed by their v6 header node_id)."""
        fm = cls()
        items = traces.items() if isinstance(traces, dict) else \
            ((tr.header.get("node_id", 0), tr) for tr in traces)
        for node, tr in items:
            fm.add(int(node), MetricsHub().ingest(tr))
        return fm

    # ---- aggregation ------------------------------------------------------- #
    def merged(self) -> MetricsHub:
        """A fresh hub holding the fleet-wide registry rollup. Sources are
        left untouched (merge copies into the new hub's metrics)."""
        out = MetricsHub()
        for node in sorted(self.hubs):
            out.merge(self.hubs[node])
        return out

    def imbalance(self) -> dict:
        requests = {n: self.hubs[n].counter("requests_arrived").value
                    for n in sorted(self.hubs)}
        total = sum(requests.values())
        qmax = {n: self.hubs[n].gauge("queue_depth").max()
                for n in sorted(self.hubs)}
        return {
            "requests": requests,
            "request_share": {n: (v / total if total else 0.0)
                              for n, v in requests.items()},
            "queue_depth_max": qmax,
            "queue_depth_spread": (max(qmax.values()) - min(qmax.values())
                                   if qmax else 0.0),
        }

    def utilization(self) -> Optional[dict]:
        if not self.replays:
            return None
        per_node = {}
        for node in sorted(self.replays):
            rep = self.replays[node]
            per_node[node] = {
                "makespan": rep.makespan,
                "mu": rep.result.group_utilization("MU"),
                "pim": rep.result.group_utilization("PIM"),
            }
        total = sum(u["makespan"] for u in per_node.values())
        # fleet utilization = busy time over span time, i.e. each node's
        # utilization weighted by how long its replay actually ran
        fleet = {
            "mu": (sum(u["mu"] * u["makespan"] for u in per_node.values())
                   / total if total else 0.0),
            "pim": (sum(u["pim"] * u["makespan"] for u in per_node.values())
                    / total if total else 0.0),
        }
        return {"per_node": per_node, "fleet": fleet,
                "makespan_total": total,
                "makespan_max": max(u["makespan"]
                                    for u in per_node.values())}

    def chaos_summary(self) -> Optional[dict]:
        """Fleet-wide chaos rollup (None for a fault-free fleet):

        goodput          unique COMPLETED gids over unique OFFERED gids
                         (offered = every arrival that ever entered the
                         fleet: placed, failed or rejected) — completions
                         deduplicate across nodes, so a request that
                         failed over counts once, on its final node.
        mttr_ticks       per fault class: node_crash uses the recovery
                         downtime (crash tick -> re-prefill re-entering
                         service on the new node); window faults use
                         their recorded [begin, end) durations.
        reprefill_tokens total re-prefilled prompt+prefix tokens — the
                         FLOP overhead failover paid for exactly-once.
        """
        if all(h.chaos_summary() is None for h in self.hubs.values()):
            return None
        m = self.merged()
        completed: set = set()
        arrived: set = set()
        failed: set = set()
        rejected: set = set()
        for h in self.hubs.values():
            completed |= h.completed_gids()
            arrived |= h.arrived_gids()
            failed |= h.failed_gids
            rejected |= h.rejected_gids
        offered = arrived | failed | rejected
        dup = sorted(g for g in completed if sum(
            g in h.completed_gids() for h in self.hubs.values()) > 1)
        mttr = {"node_crash":
                m.histogram("recovery_downtime_ticks").summary()}
        for name in sorted(m._metrics):
            if name.startswith("fault_window_"):
                mttr[name[len("fault_window_"):]] = \
                    m._metrics[name].summary()
        return {
            "offered": len(offered),
            "completed": len(completed),
            "failed": sorted(failed),
            "rejected": sorted(rejected),
            "goodput": (len(completed) / len(offered) if offered else 1.0),
            "duplicate_completions": dup,
            "recovered": m.counter("requests_recovered").value,
            "crash_inflight": m.counter("crash_inflight").value,
            "reprefill_tokens":
                m.counter("recovery_reprefill_tokens").value,
            "restored_tokens":
                m.counter("recovery_restored_tokens").value,
            # fleet-wide KV-snapshot rollup: merged counters, exact
            # restore-hit-rate over all recoveries (all-zero when off)
            "snapshots": m.snapshot_summary(),
            "mttr_ticks": mttr,
            "faults": {n[len("faults_"):]: m._metrics[n].value
                       for n in sorted(m._metrics)
                       if n.startswith("faults_")},
        }

    # ---- reports ----------------------------------------------------------- #
    def summary(self) -> dict:
        m = self.merged()
        hdr = next((h.header for h in self.hubs.values()
                    if h.header is not None), None)
        return {
            "replicas": len(self.hubs),
            "nodes": sorted(self.hubs),
            "fleet": dict(hdr["fleet"]) if hdr and hdr.get("fleet") else None,
            "requests": {
                "arrived": m.counter("requests_arrived").value,
                "completed": m.counter("requests_completed").value,
                "tokens_generated": m.counter("tokens_generated").value,
            },
            "ttft_ticks": m.histogram("ttft_ticks").summary(),
            "tpot_ticks": m.histogram("tpot_ticks").summary(),
            "queue_wait_ticks": m.histogram("queue_wait_ticks").summary(),
            # fleet-summed step functions over the shared clock
            "queue_depth": m.gauge("queue_depth").to_dict(),
            "slots_busy": m.gauge("slots_busy").to_dict(),
            "imbalance": self.imbalance(),
            "utilization": self.utilization(),
            "chaos": self.chaos_summary(),
        }

    def to_dict(self) -> dict:
        """The fleet metrics JSON: the fleet summary plus every node's
        full per-replica report (raw lifecycles included, so merged
        percentiles remain checkable against raw samples)."""
        return {
            "fleet": self.summary(),
            "nodes": {n: self.hubs[n].to_dict()
                      for n in sorted(self.hubs)},
        }


__all__ = ["FleetMetrics"]
