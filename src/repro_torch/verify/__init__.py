"""repro_torch.verify — static hazard analysis for PAS command DAGs and the
serving protocol (the correctness gate CI runs over every shipped trace).

Six passes, none of which execute anything:

  footprints  per-Command read/write resource sets, derived from command
              kind/unit/shape metadata and naming conventions — never from
              the dep edges being checked
  hazards     happens-before over any lowered/merged DAG; RAW/WAR/WAW and
              the IANUS-specific PIM-compute-vs-normal-access class; plus
              a reference-DAG diff that catches ANY dropped dependency
              edge (lowering is deterministic in the step shape)
  protocol    trace-level lint of the scheduler-era invariants: parked
              write cursors, scatter-before-gather packing, single-fetch
              supersteps, fused-pair issue roots, dispatch accounting
  lint        AST scan of repro_torch.{serve,sched,obs,fleet,chaos} for
              host-sync calls outside an explicit allowlist
  exactly_once  chaos-recovery audit over a fleet's traces: no activity
              after a crash, no duplicate completions across replicas,
              every arrival accounted completed / failed / rejected
  snapshot_provenance  KV-snapshot recovery audit: every restored prefix
              is covered by a tiling chain of durable snapshot exports
              that happened strictly before the crash, carried prefixes
              match the crashed node's stream, and saved + paid re-prefill
              tokens add up to the re-placed prompt

CLI: ``python -m repro_torch.launch.verify --traces benchmarks/data``
(``--src`` defaults to ``src/repro_torch``).

The port's own copy of ``repro/verify/__init__.py``.
"""
from repro_torch.verify.exactly_once import check_exactly_once
from repro_torch.verify.snapshot_provenance import check_snapshot_provenance
from repro_torch.verify.footprints import (Footprint, Resource, bank_set,
                                           command_footprints)
from repro_torch.verify.hazards import (Finding, SEVERITIES, analyze_commands,
                                        analyze_lowered, diff_commands,
                                        reference_commands,
                                        verify_lowered_step)
from repro_torch.verify.lint import (SYNC_ATTRS, SYNC_NAMES, lint_host_syncs,
                                     load_allowlist)
from repro_torch.verify.protocol import lint_trace

__all__ = [
    "Footprint", "Resource", "bank_set", "command_footprints",
    "Finding", "SEVERITIES", "analyze_commands", "analyze_lowered",
    "diff_commands", "reference_commands", "verify_lowered_step",
    "SYNC_ATTRS", "SYNC_NAMES", "lint_host_syncs", "load_allowlist",
    "lint_trace", "check_exactly_once", "check_snapshot_provenance",
]
