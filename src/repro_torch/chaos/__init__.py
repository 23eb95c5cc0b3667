"""Chaos-tolerant fleet serving (the port's own copy of ``repro/chaos``):
deterministic fault injection (``chaos.faults``), incremental KV
snapshots (``chaos.snapshots``) and failover re-prefill recovery
(``chaos.recovery``) over the fleet replayer.

The contract: a seeded ``FaultPlan`` replayed through
``serve_fleet_chaos`` is bit-deterministic — identical fault schedule,
routing decisions, recovery placements and greedy tokens every run — and
exactly-once: every arrival ends ``completed`` (on exactly one node,
with tokens identical to the fault-free run), ``failed`` or
``rejected``, never silently dropped. The reference's
``verify.exactly_once`` audits the port's recorded traces for all of it.
"""
from repro_torch.chaos.faults import (DEGRADED_PENALTY, FAULT_KINDS,
                                      FaultEvent, FaultPlan, FleetHealth)
from repro_torch.chaos.recovery import (ChaosResult, RecoveryItem,
                                        inflight_from_events,
                                        serve_fleet_chaos)
from repro_torch.chaos.snapshots import SnapshotStore

__all__ = [
    "DEGRADED_PENALTY", "FAULT_KINDS", "FaultEvent", "FaultPlan",
    "FleetHealth", "ChaosResult", "RecoveryItem", "inflight_from_events",
    "serve_fleet_chaos", "SnapshotStore",
]
