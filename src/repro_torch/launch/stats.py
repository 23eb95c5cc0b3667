"""Offline observability CLI: metrics report + Perfetto timeline for
recorded serving traces.

  PYTHONPATH=src python -m repro_torch.launch.stats \\
      benchmarks/data/smoke_trace.jsonl \\
      --out metrics.json --timeline trace.json --replay

Ingests a workload-trace JSONL (any supported schema version — older
traces upgrade in place), feeds it through ``obs.MetricsHub`` (the
same code path live serving uses, so benchmark and engine report identical
metric definitions), and writes:

  --out       the full metrics JSON: SLO summary (p50/p95/p99 TTFT & TPOT
              in engine-clock ticks, queue depth, slot occupancy,
              valid-token fraction, dispatch mix), every registered
              metric, and per-request lifecycle timelines
  --timeline  a Chrome/Perfetto-loadable trace.json: one slice per
              recorded dispatch (fused pairs as one slice, supersteps as
              nested round slices), async-fetch flows, per-slot request
              lanes, queue-depth counters — plus, with ``--replay``, the
              simulator replay's per-unit NPU/PIM stream spans (merged
              fused groups and pipelined superstep spans included) as a
              second process in the same file

The timeline is checked against the trace summary before it is written:
dispatch-slice count must equal the engine's recorded dispatch total and
resolve-slice count its host-sync total, so "covers every dispatch span"
is enforced, not assumed.

Several trace files (or a shell/``--glob``-expanded pattern) aggregate
through ``fleet.FleetMetrics`` — the SAME path the live fleet router
reports through — into a fleet report: merged-exact p50/p99 TTFT/TPOT,
load imbalance, per-node coverage-checked track groups in one timeline,
and (with ``--replay``) per-node + fleet NPU/PIM utilization.

The port's own copy of ``repro/launch/stats.py``. A trace the port
records on the card reports here like one the reference records; the
replay's spans and utilizations are the simulated IANUS machine's, not
the card's.
"""
from __future__ import annotations

import argparse
import glob as globlib
import json
import sys
from typing import List, Optional

from repro_torch.obs import (MetricsHub, dispatch_slices, engine_events,
                             fleet_events, fleet_node_pids, sim_events,
                             write_chrome_trace)
from repro_torch.trace.lower import trace_to_commands
from repro_torch.trace.replay import TraceReplayer
from repro_torch.trace.schema import Trace


def build_report(trace: Trace) -> MetricsHub:
    return MetricsHub().ingest(trace)


def check_coverage(trace: Trace, events: List[dict],
                   pid: Optional[int] = None) -> List[str]:
    """The timeline's coverage contract vs the trace's own summary: one
    dispatch slice a dispatch, one resolve slice a host sync. ``pid``
    selects one node's engine track group in a fleet export (and scopes
    the resolve-slice count to it); default is the single-engine
    layout."""
    problems = []
    if trace.summary is not None:
        want = sum(trace.summary["dispatch_counts"].values())
        got = len(dispatch_slices(events) if pid is None
                  else dispatch_slices(events, pid=pid))
        if got != want:
            problems.append(f"timeline has {got} dispatch slices; the "
                            f"trace summary counts {want} dispatches")
        want_syncs = trace.summary["host_syncs"]
        got_syncs = sum(1 for e in events if e["ph"] == "X"
                        and e.get("cat") == "fetch"
                        and (pid is None or e.get("pid") == pid))
        if got_syncs != want_syncs:
            problems.append(f"timeline has {got_syncs} resolve slices; the "
                            f"trace summary counts {want_syncs} host syncs")
    return problems


def _print_summary(s: dict) -> None:
    print(f"[stats] policy={s['policy']} arch={s['arch']}: "
          f"{s['requests']['arrived']} arrived, "
          f"{s['requests']['completed']} completed, "
          f"{s['requests']['tokens_generated']} tokens")
    for name in ("ttft_ticks", "tpot_ticks", "queue_wait_ticks"):
        h = s[name]
        print(f"[stats] {name:>16}: n={h['count']:>4} mean={h['mean']:.2f} "
              f"p50={h['p50']:.1f} p95={h['p95']:.1f} p99={h['p99']:.1f} "
              f"max={h['max']:.0f}")
    print(f"[stats] queue depth mean/max: {s['queue_depth']['mean']:.2f}/"
          f"{s['queue_depth']['max']:.0f}; slots busy mean/max: "
          f"{s['slots_busy']['mean']:.2f}/{s['slots_busy']['max']:.0f}")
    mix = s["dispatch_mix"]
    print(f"[stats] dispatch mix: {mix['prefill']} prefill + "
          f"{mix['decode']} decode + {mix['fused']} fused = {mix['total']} "
          f"({mix['superstep_spans']} supersteps covering "
          f"{mix['superstep_rounds']} rounds); {mix['host_syncs']} host "
          f"syncs; valid-token fraction {s['valid_token_fraction']:.3f}")


def _expand(patterns: List[str]) -> List[str]:
    """Shell-unexpanded globs (quoted, or from CI YAML) expand here; plain
    paths pass through. A glob matching NOTHING is a hard error — a typo'd
    pattern must not silently shrink the fleet being reported on."""
    paths: List[str] = []
    for p in patterns:
        if any(ch in p for ch in "*?["):
            hits = sorted(globlib.glob(p))
            if not hits:
                raise FileNotFoundError(f"glob {p!r} matched no trace files")
            paths += hits
        else:
            paths.append(p)
    return paths


def _load_trace(path: str) -> Trace:
    """Load one trace with CLI-grade errors (one line, no traceback).
    Loads tolerantly (``strict=False``): corrupt interior lines are
    skipped with a warning and surfaced as a count, so one flipped bit in
    a long recording does not make the whole report unreachable."""
    from repro_torch.trace.schema import TraceSchemaError
    try:
        trace = Trace.load(path, strict=False)
        if trace.skipped_lines:
            print(f"[stats] WARNING: {path}: skipped "
                  f"{trace.skipped_lines} corrupt line(s)")
        return trace
    except FileNotFoundError:
        raise SystemExit(f"[stats] error: trace file not found: {path}")
    except IsADirectoryError:
        raise SystemExit(f"[stats] error: {path} is a directory, not a "
                         f"trace file")
    except (TraceSchemaError, json.JSONDecodeError, OSError,
            UnicodeDecodeError) as e:
        raise SystemExit(f"[stats] error: unreadable trace {path}: {e}")


def _fleet_report(paths: List[str], args) -> int:
    """Several traces = one fleet: aggregate through ``FleetMetrics`` and
    emit one multi-node timeline (per-node coverage enforced)."""
    from repro_torch.fleet import FleetMetrics

    loaded = [_load_trace(p) for p in paths]
    node_ids = [int(tr.header.get("node_id", 0)) for tr in loaded]
    if len(set(node_ids)) != len(node_ids):
        # standalone traces (all node 0) or mixed sets: position in the
        # argument list becomes the node id
        node_ids = list(range(len(loaded)))
    traces = dict(zip(node_ids, loaded))
    fm = FleetMetrics.from_traces(traces)

    replays = None
    if args.replay:
        cfg = None
        if args.arch:
            from repro_torch.configs import get_arch
            cfg = get_arch(args.arch)
        replays = {}
        for node, tr in traces.items():
            rep = TraceReplayer().replay(trace_to_commands(tr, cfg=cfg))
            replays[node] = rep
            fm.add_replay(node, rep)

    s = fm.summary()
    print(f"[stats] fleet of {s['replicas']}: "
          f"{s['requests']['arrived']} arrived, "
          f"{s['requests']['completed']} completed, "
          f"{s['requests']['tokens_generated']} tokens")
    for name in ("ttft_ticks", "tpot_ticks", "queue_wait_ticks"):
        h = s[name]
        print(f"[stats] {name:>16}: n={h['count']:>4} mean={h['mean']:.2f} "
              f"p50={h['p50']:.1f} p95={h['p95']:.1f} p99={h['p99']:.1f} "
              f"max={h['max']:.0f}")
    if s.get("chaos"):
        c = s["chaos"]
        print(f"[stats] chaos: goodput {c['goodput']:.2f} "
              f"({c['completed']}/{c['offered']} offered), "
              f"{c['recovered']} recovered, {len(c['failed'])} failed, "
              f"{len(c['rejected'])} rejected, "
              f"{c['reprefill_tokens']} re-prefill tokens")
    share = s["imbalance"]["request_share"]
    print(f"[stats] request share: "
          + "  ".join(f"node{n}={share[n]:.2f}" for n in sorted(share))
          + f"; queue-depth spread {s['imbalance']['queue_depth_spread']:g}")
    if s["utilization"]:
        u = s["utilization"]
        print("[stats] utilization: "
              + "  ".join(f"node{n}: MU {v['mu']:.1%}/PIM {v['pim']:.1%}"
                          for n, v in sorted(u["per_node"].items()))
              + f"; fleet MU {u['fleet']['mu']:.1%}/"
                f"PIM {u['fleet']['pim']:.1%}")

    events = fleet_events(traces,
                          replays={n: r.result for n, r in replays.items()}
                          if replays else None)
    problems = []
    for node, tr in traces.items():
        pid_engine, _pid_slots, _pid_sim = fleet_node_pids(node)
        problems += [f"node {node}: {p}"
                     for p in check_coverage(tr, events, pid=pid_engine)]
    for p in problems:
        print(f"[stats] COVERAGE FAIL: {p}")

    if args.out:
        report = fm.to_dict()
        if replays:
            report["replay"] = {n: r.to_dict() for n, r in replays.items()}
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[stats] wrote fleet metrics report -> {args.out}")
    if args.timeline:
        write_chrome_trace(args.timeline, events)
        print(f"[stats] wrote {len(events)} trace events -> {args.timeline} "
              f"(load in https://ui.perfetto.dev)")
    return 1 if problems else 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="metrics report + Perfetto timeline for recorded "
                    "serving traces (several = a fleet)")
    ap.add_argument("trace", nargs="+",
                    help="workload trace JSONL path(s) or glob(s) "
                         "(e.g. benchmarks/data/smoke_trace.jsonl, "
                         "'out/node*.jsonl'); several files aggregate as "
                         "one fleet")
    ap.add_argument("--out", default=None,
                    help="write the metrics report JSON here")
    ap.add_argument("--timeline", default=None,
                    help="write a Perfetto-loadable trace.json here")
    ap.add_argument("--replay", action="store_true",
                    help="lower + replay the trace through the simulator "
                         "and add its NPU/PIM stream spans to the timeline")
    ap.add_argument("--arch", default=None,
                    help="lower the replay at this named arch's dims "
                         "instead of the dims recorded in the header")
    args = ap.parse_args(argv)

    try:
        paths = _expand(args.trace)
    except FileNotFoundError as e:
        print(f"[stats] error: {e}")
        return 1
    if len(paths) > 1:
        return _fleet_report(paths, args)

    trace = _load_trace(paths[0])
    hub = build_report(trace)
    summary = hub.summary()
    _print_summary(summary)

    report = hub.to_dict()
    events = engine_events(trace)
    problems = check_coverage(trace, events)
    for p in problems:
        print(f"[stats] COVERAGE FAIL: {p}")

    if args.replay:
        cfg = None
        if args.arch:
            from repro_torch.configs import get_arch
            cfg = get_arch(args.arch)
        lowered = trace_to_commands(trace, cfg=cfg)
        rep = TraceReplayer().replay(lowered)
        report["replay"] = rep.to_dict()
        events += sim_events(rep.result)
        print(f"[stats] replay: makespan {rep.makespan * 1e3:.3f} ms, "
              f"MU {rep.result.group_utilization('MU'):.1%} / "
              f"PIM {rep.result.group_utilization('PIM'):.1%}, "
              f"{rep.overlap_stats['groups']} overlapped groups "
              f"({rep.overlap_stats['fused_groups']} fused), "
              f"{rep.superstep_stats['spans']} superstep spans")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[stats] wrote metrics report -> {args.out}")
    if args.timeline:
        write_chrome_trace(args.timeline, events)
        print(f"[stats] wrote {len(events)} trace events -> {args.timeline} "
              f"(load in https://ui.perfetto.dev)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
