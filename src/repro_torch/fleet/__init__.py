"""fleet — multi-replica serving behind a load balancer (the port's own
copy of ``repro/fleet``).

``serve_fleet`` replays ONE open-loop arrival stream through N
``ServeEngine`` replicas on a shared fleet clock, with the
arrival->replica assignment decided by a routing policy:

  round_robin      gid mod N — the baseline balancer
  least_loaded     argmin over replicas of queue depth + busy slots (the
                   ``ServeEngine.load_stats`` router hook), ties to the
                   fewest routed, then the lowest node id
  prefix_affinity  crc32 of the prompt's first k tokens mod N — requests
                   sharing a prefix land on the same node

Every replica records through its own ``TraceRecorder`` (schema v6 headers
carry ``node_id`` + the fleet shape) with a ``MetricsHub`` sink.
``FleetMetrics`` merges the per-replica hubs losslessly into fleet
p50/p95/p99 TTFT/TPOT/queue-wait plus load-imbalance stats.

The replicas share one ``params`` object; each owns its cache. Like the
engine, ``serve_fleet`` runs on the card unless given ``device="cpu"``.

CLI: ``python -m repro_torch.launch.fleet --replicas N --routing P``.
"""
from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.fleet.replayer import FleetResult, serve_fleet
from repro_torch.fleet.router import (ROUTING_POLICIES, LeastLoaded,
                                      PrefixAffinity, RoundRobin,
                                      make_router)

__all__ = [
    "FleetMetrics", "FleetResult", "serve_fleet",
    "ROUTING_POLICIES", "LeastLoaded", "PrefixAffinity", "RoundRobin",
    "make_router",
]
