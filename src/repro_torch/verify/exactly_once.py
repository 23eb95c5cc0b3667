"""Exactly-once audit over a fleet's recorded chaos traces.

``check_exactly_once`` takes every per-node trace of ONE fleet run
(grouped by identical ``fleet`` header — ``launch.verify`` does the
grouping) and audits the chaos recovery contract from the recorded
events alone, executing nothing:

  post_crash_activity   a crashed node recorded ANY event after its
                        ``node_crash`` fault event — a halted replica
                        must never dispatch, admit or complete again
  duplicate_completion  one global request id completed on more than one
                        node: failover re-placed work that also finished
                        at its origin (the exactly-once guarantee broken
                        in the at-least-once direction)
  conflicting_outcome   a gid both completed somewhere and was recorded
                        terminal ``failed``/``reject``
  unaccounted_request   a gid entered the fleet (request / failed /
                        reject event) but reached NO terminal state —
                        the silent-drop class chaos serving exists to
                        kill
  recover_unmoored      a ``recover`` event references a from_node whose
                        trace (present in the group) records no crash,
                        or a crash at a different step

The pass runs over every committed trace in CI, not just chaos ones: a
fault-free drained trace passes because every request completes exactly
once on its own node, so the audit is a no-op strengthening.

The port's own copy of ``repro/verify/exactly_once.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from repro_torch.trace.schema import Trace
from repro_torch.verify.hazards import Finding


def _crash_index(events: Sequence[dict]) -> Optional[int]:
    """Index of the node_crash fault event, if this node crashed."""
    for i, ev in enumerate(events):
        if ev.get("type") == "fault" and ev.get("kind") == "node_crash" \
                and ev.get("phase") == "begin":
            return i
    return None


def check_exactly_once(traces: Sequence[Trace]) -> List[Finding]:
    findings: List[Finding] = []
    completed_on: Dict[int, List[int]] = {}     # gid -> nodes completing it
    arrived: Set[int] = set()
    failed: Set[int] = set()
    rejected: Set[int] = set()
    crash_step: Dict[int, int] = {}             # node -> crash tick
    nodes_present: Set[int] = set()

    for tr in traces:
        node = int(tr.header.get("node_id", 0))
        nodes_present.add(node)
        events = tr.events
        ci = _crash_index(events)
        if ci is not None:
            crash_step[node] = int(events[ci]["step"])
            after = [ev for ev in events[ci + 1:]]
            if after:
                kinds = sorted({ev["type"] for ev in after})
                findings.append(Finding(
                    "error", "post_crash_activity",
                    f"node {node} recorded {len(after)} event(s) "
                    f"({', '.join(kinds)}) after its node_crash at step "
                    f"{crash_step[node]} — a halted replica must never "
                    f"serve again",
                    location=f"node {node} event {ci + 1}"))
        rid_gid = {}
        for i, ev in enumerate(events):
            t = ev.get("type")
            if t == "request":
                gid = int(ev.get("gid", ev["rid"]))
                rid_gid[ev["rid"]] = gid
                arrived.add(gid)
            elif t == "complete":
                gid = rid_gid.get(ev["rid"], ev["rid"])
                completed_on.setdefault(int(gid), []).append(node)
            elif t == "failed":
                failed.add(int(ev["gid"]))
            elif t == "reject":
                rejected.add(int(ev["gid"]))

    # a recover event must point back at a real, matching crash
    for tr in traces:
        node = int(tr.header.get("node_id", 0))
        for i, ev in enumerate(tr.events):
            if ev.get("type") != "recover":
                continue
            src = int(ev["from_node"])
            if src in nodes_present and crash_step.get(src) != \
                    int(ev["crash_step"]):
                findings.append(Finding(
                    "error", "recover_unmoored",
                    f"node {node} recovered gid {ev['gid']} from node "
                    f"{src} crash_step {ev['crash_step']}, but node "
                    f"{src}'s trace records "
                    f"{'no crash' if src not in crash_step else f'a crash at step {crash_step[src]}'}",
                    location=f"node {node} event {i}"))

    for gid, nodes in sorted(completed_on.items()):
        if len(nodes) > 1:
            findings.append(Finding(
                "error", "duplicate_completion",
                f"gid {gid} completed on {len(nodes)} nodes "
                f"({sorted(nodes)}) — exactly-once violated",
                location=f"gid {gid}"))
        if gid in failed or gid in rejected:
            state = "failed" if gid in failed else "rejected"
            findings.append(Finding(
                "error", "conflicting_outcome",
                f"gid {gid} completed on node {nodes[0]} but is also "
                f"recorded terminal {state}", location=f"gid {gid}"))

    for gid in sorted((arrived | failed | rejected)
                      - set(completed_on) - failed - rejected):
        findings.append(Finding(
            "error", "unaccounted_request",
            f"gid {gid} entered the fleet but never completed, failed or "
            f"was rejected — silently dropped", location=f"gid {gid}"))
    return findings


__all__ = ["check_exactly_once"]
