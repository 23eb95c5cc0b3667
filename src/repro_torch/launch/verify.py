"""Static verification gate: hazard-analyze traces + lint scheduler code.

  PYTHONPATH=src python -m repro_torch.launch.verify \\
      --traces benchmarks/data --src src/repro_torch

Three passes per ``*.jsonl`` trace under ``--traces`` (none execute device
code): the serving-protocol lint (``verify.protocol``), the per-dispatch-
span hazard analysis over the lowered command DAGs (``verify.hazards``),
and the reference-DAG diff of every lowered step. Traces are then grouped
by fleet (identical ``fleet`` header on schema-v6+ traces; solo traces
form singleton groups) and each group is audited by the exactly-once pass
(``verify.exactly_once``): no activity after a recorded crash, no
duplicate completions across replicas, every arrival accounted — and by
the snapshot-provenance pass (``verify.snapshot_provenance``): every
restored KV prefix covered by durable snapshot exports that happened
strictly before the crash, with the saved-vs-paid re-prefill split
adding up. Plus one
AST pass over ``<src>/serve``, ``<src>/sched``, ``<src>/obs``,
``<src>/fleet`` and ``<src>/chaos`` for host-sync calls outside the
allowlist (default: ``<src>/verify/sync_allowlist.txt`` when present) —
observability, fleet routing and chaos recovery all ride the recorder's
event stream / host bookkeeping and must stay sync-free by construction.

Exit status 1 when any error-severity finding survives; ``--out`` dumps
the full finding list as JSON (the format ``benchmarks/hazard_guard.py``
baselines against).

The port's own copy of ``repro/launch/verify.py``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List

from repro_torch.trace.lower import trace_to_commands
from repro_torch.trace.schema import Trace, TraceSchemaError
from repro_torch.verify import (Finding, analyze_lowered,
                                check_exactly_once,
                                check_snapshot_provenance, lint_host_syncs,
                                lint_trace, load_allowlist,
                                verify_lowered_step)
from repro_torch.trace.schema import model_config_from_header


def verify_trace_file(path: str, *, max_steps: int = 0) -> List[Finding]:
    """All findings for one trace file: protocol lint + DAG hazard pass +
    reference diff. ``max_steps`` bounds the (slower) DAG passes (0 = all
    steps)."""
    try:
        trace = Trace.load(path)
    except TraceSchemaError as e:
        return [Finding("error", "schema", f"{path}: {e}",
                        location=path)]
    findings = list(lint_trace(trace))
    lowered = trace_to_commands(trace)
    if max_steps:
        lowered = lowered[:max_steps]
    findings.extend(analyze_lowered(lowered))
    cfg = model_config_from_header(trace.header)
    for ls in lowered:
        findings.extend(verify_lowered_step(ls, cfg))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", default=None,
                    help="directory of *.jsonl workload traces to verify")
    ap.add_argument("--src", default="src/repro_torch",
                    help="package root for the host-sync lint")
    ap.add_argument("--allowlist", default=None,
                    help="host-sync allowlist file (default: "
                         "<src>/verify/sync_allowlist.txt when present)")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="bound the per-trace DAG passes to the first N "
                         "lowered steps (0 = all)")
    ap.add_argument("--out", default=None,
                    help="write all findings as JSON")
    args = ap.parse_args(argv)

    findings: List[Finding] = []
    scanned = []
    if args.traces:
        loaded = []
        for path in sorted(glob.glob(os.path.join(args.traces, "*.jsonl"))):
            fs = verify_trace_file(path, max_steps=args.max_steps)
            for f in fs:
                print(f"[verify] {path}: {f.severity} {f.klass} "
                      f"[{f.location}] {f.message}")
            scanned.append((path, len(fs)))
            findings.extend(fs)
            try:
                loaded.append((path, Trace.load(path)))
            except TraceSchemaError:
                pass        # already reported by verify_trace_file
        # exactly-once runs per FLEET: traces sharing a fleet header are
        # one run's replicas; solo/fleetless traces audit on their own
        groups = {}
        for path, tr in loaded:
            if tr.header.get("fleet") is None:
                key = f"solo:{path}"
            else:
                key = json.dumps([tr.header["fleet"],
                                  tr.header.get("chaos")], sort_keys=True)
            groups.setdefault(key, []).append((path, tr))
        for key, members in sorted(groups.items()):
            names = ", ".join(p for p, _ in members)
            for pass_name, check in (
                    ("exactly_once", check_exactly_once),
                    ("snapshot_provenance", check_snapshot_provenance)):
                fs = check([tr for _, tr in members])
                for f in fs:
                    print(f"[verify] {pass_name}[{names}]: {f.severity} "
                          f"{f.klass} [{f.location}] {f.message}")
                print(f"[verify] {pass_name} over {len(members)} trace(s) "
                      f"[{names}]: {len(fs)} finding(s)")
                findings.extend(fs)
    allowlist = []
    allow_path = args.allowlist or os.path.join(args.src, "verify",
                                                "sync_allowlist.txt")
    if os.path.exists(allow_path):
        allowlist = load_allowlist(allow_path)
    lint_dirs = [d for d in (os.path.join(args.src, "serve"),
                             os.path.join(args.src, "sched"),
                             os.path.join(args.src, "obs"),
                             os.path.join(args.src, "fleet"),
                             os.path.join(args.src, "chaos"))
                 if os.path.isdir(d)]
    sync = lint_host_syncs(lint_dirs, allowlist, root=args.src)
    for f in sync:
        print(f"[verify] {f.severity} {f.klass} [{f.location}] {f.message}")
    findings.extend(sync)

    for path, n in scanned:
        print(f"[verify] {path}: {n} finding(s)")
    print(f"[verify] host-sync lint over {lint_dirs}: "
          f"{len(sync)} finding(s)")
    n_err = sum(f.severity == "error" for f in findings)
    n_warn = sum(f.severity == "warning" for f in findings)
    print(f"[verify] total: {len(findings)} finding(s) "
          f"({n_err} errors, {n_warn} warnings)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([x.to_dict() for x in findings], f, indent=2)
        print(f"[verify] wrote {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
