"""Snapshot-provenance audit over a fleet's recorded chaos traces.

``check_snapshot_provenance`` takes every per-node trace of ONE fleet
run (grouped by identical ``fleet``/``chaos`` headers — ``launch.verify``
does the grouping) and audits the incremental-KV-snapshot recovery
contract from the recorded events alone, executing nothing:

  restore_missing       a recover event claims ``restored_tokens`` > 0
                        but its node recorded no matching restore event
                        (same gid, same prefix length) — the saved
                        re-prefill was never paid for by an actual KV
                        scatter
  snapshot_after_crash  a restore consumed a snapshot whose recorded
                        ``snapshot_step`` is not strictly before the
                        crash it recovers from — snapshots must
                        happen-before the crashes they cover
  snapshot_chain_gap    a gid's snapshot deltas do not tile: an export's
                        ``base`` is neither the previous chain prefix nor
                        0 (a legitimate chain restart after a from-zero
                        fallback dropped the record)
  uncovered_restore     the snapshot chain up to the restore's
                        ``snapshot_step`` does not reach the restored
                        prefix length — rows were restored that no
                        recorded export ever covered
  nondurable_snapshot   the restored record was owned by the crashed
                        node and its newest export was neither
                        disk-backed nor mirrored to a replica still
                        alive at restore time — it could not have
                        survived the crash it is claimed to have survived
  prefix_mismatch       a recover's carried ``prefix_tokens`` disagrees
                        with the crashed node's event stream (tokens it
                        generated for that gid, plus any prefix it had
                        itself recovered with) — the token streams the
                        byte-identity guarantee splices would diverge
  reprefill_accounting  restored + re-prefilled tokens disagree with the
                        re-placed request's recorded prompt length — the
                        saved-vs-paid split books the wrong cost
  restore_unmoored      a restore event matched no recover — KV rows
                        were scattered into a slot no failover asked for

Like ``exactly_once``, the pass runs over every committed trace in CI:
snapshot-free traces (no snapshot/restore events, ``restored_tokens``
all zero) pass vacuously, with the reprefill-accounting check still
strengthening plain from-zero recoveries.

The port's own copy of ``repro/verify/snapshot_provenance.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.trace.schema import Trace
from repro_torch.verify.hazards import Finding


def check_snapshot_provenance(traces: Sequence[Trace]) -> List[Finding]:
    findings: List[Finding] = []
    crash_step: Dict[int, int] = {}             # node -> crash tick
    # gid -> [(event-order index, node, snapshot event)]
    snaps: Dict[int, List[Tuple[int, int, dict]]] = {}
    restores: List[Tuple[int, dict, int]] = []  # (node, event, index)
    recovers: List[Tuple[int, dict, int]] = []
    # node -> [(step, gid, prompt_len)] in event order
    requests: Dict[int, List[Tuple[int, int, int]]] = {}
    # node -> gid -> tokens generated ON that node, still in flight at the
    # end of its stream (== at its crash: a halted node records nothing)
    inflight_gen: Dict[int, Dict[int, int]] = {}
    # (node, gid) -> prefix carried INTO that node's placement of gid
    carried: Dict[Tuple[int, int], int] = {}

    for tr in traces:
        node = int(tr.header.get("node_id", 0))
        rid_gid: Dict[int, int] = {}
        gen: Dict[int, int] = {}
        for i, ev in enumerate(tr.events):
            t = ev.get("type")
            if t == "fault" and ev.get("kind") == "node_crash" \
                    and ev.get("phase") == "begin":
                crash_step[node] = int(ev["step"])
            elif t == "request":
                gid = int(ev.get("gid", ev["rid"]))
                rid_gid[int(ev["rid"])] = gid
                requests.setdefault(node, []).append(
                    (int(ev["step"]), gid, int(ev["prompt_len"])))
            elif t == "decode":
                for rid, _tok in ev["tokens"]:
                    if rid in rid_gid:
                        gen[int(rid)] = gen.get(int(rid), 0) + 1
            elif t == "complete":
                gen.pop(int(ev["rid"]), None)
            elif t == "snapshot":
                snaps.setdefault(int(ev["gid"]), []).append((i, node, ev))
            elif t == "restore":
                restores.append((node, ev, i))
            elif t == "recover":
                recovers.append((node, ev, i))
                carried[(node, int(ev["gid"]))] = int(ev["prefix_tokens"])
        inflight_gen[node] = {rid_gid[r]: n for r, n in gen.items()
                              if r in rid_gid}

    matched: set = set()                        # (node, restore index)
    for node, ev, i in recovers:
        gid = int(ev["gid"])
        src = int(ev["from_node"])
        cstep = int(ev["crash_step"])
        restored = int(ev.get("restored_tokens", 0))
        loc = f"node {node} event {i}"

        # carried-prefix cross-check against the crashed node's stream:
        # what it generated for gid plus what it had itself recovered with
        if src in inflight_gen and gid in inflight_gen[src]:
            want = inflight_gen[src][gid] + carried.get((src, gid), 0)
            if int(ev["prefix_tokens"]) != want:
                findings.append(Finding(
                    "error", "prefix_mismatch",
                    f"recover of gid {gid} carries prefix "
                    f"{ev['prefix_tokens']} but node {src}'s event stream "
                    f"implies {want}", location=loc))

        # saved + paid must equal the re-placed request's prompt length
        replaced = [p for s, g, p in requests.get(node, [])
                    if g == gid and s >= int(ev["step"])]
        if replaced and restored + int(ev["reprefill_tokens"]) \
                != replaced[0]:
            findings.append(Finding(
                "error", "reprefill_accounting",
                f"recover of gid {gid} books {restored} restored + "
                f"{ev['reprefill_tokens']} re-prefilled tokens, but the "
                f"re-placed request's prompt is {replaced[0]} tokens",
                location=loc))

        if restored <= 0:
            continue
        # the saved prefix must be backed by an actual restore event here
        # NB: no step-order constraint — the restore is stamped with the
        # ENGINE clock at admit time, the recover with the FLEET tick, and
        # a superstep lets either clock lead the other by a few ticks
        cands = [(n2, e2, j) for n2, e2, j in restores
                 if n2 == node and int(e2["gid"]) == gid
                 and int(e2["prefix_len"]) == restored
                 and (n2, j) not in matched]
        if not cands:
            findings.append(Finding(
                "error", "restore_missing",
                f"recover of gid {gid} claims {restored} restored tokens "
                f"but node {node} recorded no matching restore event",
                location=loc))
            continue
        n2, rst, j = cands[-1]
        matched.add((n2, j))
        sstep = int(rst["snapshot_step"])
        if sstep >= cstep:
            findings.append(Finding(
                "error", "snapshot_after_crash",
                f"gid {gid} restored from a snapshot at step {sstep}, not "
                f"strictly before the crash at step {cstep} it recovers "
                f"from", location=loc))

        # replay the gid's export chain up to the restore's snapshot step:
        # deltas must tile [0, restored) — base 0 restarts a chain (a
        # from-zero fallback dropped the record), anything else is a gap
        chain = sorted(((int(e["step"]), k, n3, e) for k, n3, e
                        in snaps.get(gid, []) if int(e["step"]) <= sstep))
        cur, last = 0, None
        for _step, _k, n3, e in chain:
            base = int(e.get("base", 0))
            if base == cur or base == 0:
                cur = int(e["prefix_len"])
                last = (n3, e)
            else:
                findings.append(Finding(
                    "error", "snapshot_chain_gap",
                    f"gid {gid} snapshot delta at step {e['step']} starts "
                    f"at {base} but the chain holds [0, {cur})",
                    location=f"node {n3} step {e['step']}"))
        if cur != restored:
            findings.append(Finding(
                "error", "uncovered_restore",
                f"gid {gid} restored {restored} tokens but its snapshot "
                f"chain up to step {sstep} covers [0, {cur})",
                location=loc))
        elif last is not None:
            # durability: when the newest export of the record came from
            # the crashed node, it must have had a survival path — disk,
            # or a mirror replica still alive at restore time
            n3, e = last
            mirror = e.get("mirror_node")
            mirror_ok = mirror is not None and (
                int(mirror) not in crash_step
                or crash_step[int(mirror)] > int(rst["step"]))
            if n3 == src and not (bool(e.get("durable", False))
                                  or mirror_ok):
                findings.append(Finding(
                    "error", "nondurable_snapshot",
                    f"gid {gid} restored a record last exported by the "
                    f"crashed node {src} at step {e['step']}, with no disk "
                    f"backing and no surviving mirror — it could not have "
                    f"outlived the crash", location=loc))

    for n2, e2, j in restores:
        if (n2, j) not in matched:
            findings.append(Finding(
                "error", "restore_unmoored",
                f"node {n2} restore of gid {e2['gid']} "
                f"({e2['prefix_len']} tokens) matches no recover event",
                location=f"node {n2} event {j}"))
    return findings


__all__ = ["check_snapshot_provenance"]
