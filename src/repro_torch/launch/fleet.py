"""Fleet launcher of the port: N ServeEngine replicas behind a routing
policy (the counterpart of ``repro/launch/fleet.py``).

  python -m repro_torch.launch.fleet --replicas 2 --routing least_loaded \\
      --metrics-out fleet_metrics.json --timeline-out fleet_trace.json \\
      --replay
  python -m repro_torch.launch.fleet --device cpu --replicas 3 \\
      --fault-plan "node_crash,node=1,step=10" --snapshot-interval 4

Serves a bursty open-loop smoke workload (one arrival stream, the shared
fleet clock) through N replicas — optionally under a chaos fault plan
(``--fault-plan`` takes a JSON file or an inline spec like
``node_crash,node=1,step=12;pim_degraded,node=0,step=8,until=20``; the
fleet then runs ``chaos.serve_fleet_chaos`` with failover
re-prefill recovery and reports goodput / recovery overhead) — then
reports:

  --metrics-out   the fleet metrics JSON: ``FleetMetrics`` summary (merged
                  p50/p95/p99 TTFT/TPOT/queue-wait — lossless sample
                  concatenation, so fleet percentiles are exact), load
                  imbalance, and every node's full per-replica report
  --timeline-out  ONE Perfetto trace.json with a process group per node
                  (dispatch/fetch/slot lanes side by side) under a
                  fleet-level queue-depth counter; with ``--replay``, each
                  node's simulator NPU/PIM tracks join its group
  --traces-out    directory for the per-node trace JSONL files (each
                  passes ``verify.lint_trace`` on its own)

The per-node timelines are coverage-checked before writing: each node's
dispatch-slice count must equal its trace summary's dispatch total
(``launch.stats.check_coverage``).

Runs on the card unless ``--device cpu`` is given; weights are random,
from seed 0 (``init_params``). ``--replay`` runs each node's trace
through the IANUS simulator: its utilizations are the simulated
machine's, not the card's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.chaos import FaultPlan, serve_fleet_chaos
from repro_torch.configs import get_arch
from repro_torch.fleet import ROUTING_POLICIES, FleetMetrics, serve_fleet
from repro_torch.launch.stats import check_coverage
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, resolve_device
from repro_torch.obs import fleet_events, fleet_node_pids, write_chrome_trace
from repro_torch.serve import ServeConfig
from repro_torch.trace.arrivals import bursty_arrivals
from repro_torch.trace.lower import trace_to_commands
from repro_torch.trace.replay import TraceReplayer


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-replica fleet replay behind a routing policy")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true",
                    help="serve at full model dims (default: reduced smoke "
                         "dims)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--routing", default="least_loaded",
                    help=f"one of {', '.join(ROUTING_POLICIES)}")
    ap.add_argument("--prefix-len", type=int, default=8,
                    help="prompt-prefix tokens hashed by prefix_affinity")
    # the bursty open-loop workload (one stream for the whole fleet)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="mean arrivals per fleet tick")
    ap.add_argument("--horizon", type=int, default=48,
                    help="arrival horizon in fleet ticks")
    ap.add_argument("--burst", type=int, default=8)
    ap.add_argument("--idle", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    # per-replica serve shape (dispatch_guard's smoke SERVE defaults)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--policy", default="interleaved",
                    choices=["serial", "interleaved", "pim_aware"])
    ap.add_argument("--superstep", type=int, default=4)
    ap.add_argument("--metrics-out", default=None,
                    help="write the fleet metrics JSON here")
    ap.add_argument("--timeline-out", default=None,
                    help="write the multi-node Perfetto trace.json here")
    ap.add_argument("--traces-out", default=None,
                    help="directory for per-node trace JSONL files")
    ap.add_argument("--replay", action="store_true",
                    help="replay each node's trace through the simulator "
                         "for per-node + fleet NPU/PIM utilization")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    # chaos serving (chaos)
    ap.add_argument("--fault-plan", default=None,
                    help="chaos fault plan: a JSON file path or an inline "
                         "spec (kind,node=N,step=T[,until=U][,factor=F]"
                         "[,cap=C];...)")
    ap.add_argument("--retry-budget", type=int, default=3,
                    help="placement attempts per request before terminal "
                         "failed/reject")
    ap.add_argument("--backoff", type=int, default=1,
                    help="base re-placement backoff in fleet ticks "
                         "(doubles per retry)")
    ap.add_argument("--backoff-cap", type=int, default=64,
                    help="clamp on the exponential re-placement backoff "
                         "(fleet ticks)")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bounded admission queue per replica (0 = "
                         "unbounded)")
    # incremental KV snapshots (chaos.snapshots)
    ap.add_argument("--snapshot-interval", type=int, default=0,
                    help="export incremental KV snapshots every N fleet "
                         "ticks so failover re-prefills only the suffix "
                         "(0 = off)")
    ap.add_argument("--snapshot-mirror", action="store_true",
                    help="mirror each snapshot to the next alive replica "
                         "in the ring")
    ap.add_argument("--snapshot-dir", default=None,
                    help="disk-back snapshots here with the atomic-write "
                         "discipline (survives any crash)")
    args = ap.parse_args(argv)

    if args.routing not in ROUTING_POLICIES:
        print(f"[fleet] error: unknown routing policy {args.routing!r} "
              f"(choose from {', '.join(ROUTING_POLICIES)})")
        return 1
    plan = None
    if args.fault_plan is not None:
        try:
            if os.path.exists(args.fault_plan) or \
                    args.fault_plan.endswith(".json"):
                plan = FaultPlan.load(args.fault_plan)
            else:
                plan = FaultPlan.from_spec(args.fault_plan)
            plan.validate(args.replicas)
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            print(f"[fleet] error: bad fault plan {args.fault_plan!r}: {e}")
            return 1

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = init_params(T.param_defs(cfg), device=dev, seed=0)
    scfg = ServeConfig(max_slots=args.slots, max_len=args.max_len,
                       prefill_chunk=args.prefill_chunk, policy=args.policy,
                       pack=True, fuse=True, superstep=args.superstep,
                       queue_cap=args.queue_cap)
    arrivals = bursty_arrivals(args.rate, args.horizon,
                               vocab=cfg.vocab_size,
                               burst=args.burst, idle=args.idle,
                               prompt_len=(2, args.max_len - 24),
                               max_new=(3, 10), seed=args.seed)
    if plan is not None:
        if args.traces_out:
            # chaos serving streams crash-safe JSONL as it runs — the
            # directory must exist before the recorders bind
            os.makedirs(args.traces_out, exist_ok=True)
        fleet = serve_fleet_chaos(cfg, params, scfg, arrivals, plan,
                                  replicas=args.replicas,
                                  routing=args.routing,
                                  prefix_len=args.prefix_len,
                                  retry_budget=args.retry_budget,
                                  backoff=args.backoff,
                                  backoff_cap=args.backoff_cap,
                                  snapshot_interval=args.snapshot_interval,
                                  snapshot_mirror=args.snapshot_mirror,
                                  snapshot_dir=args.snapshot_dir,
                                  stream_dir=args.traces_out, device=dev)
    else:
        fleet = serve_fleet(cfg, params, scfg, arrivals,
                            replicas=args.replicas, routing=args.routing,
                            prefix_len=args.prefix_len, device=dev)
    print(f"[fleet] {args.replicas} replicas, routing={fleet.routing}: "
          f"{len(arrivals)} arrivals, {fleet.served} served"
          + (f", {len(plan.events)} scheduled fault(s)" if plan else ""))

    fm = FleetMetrics()
    for node, hub in fleet.hubs.items():
        fm.add(node, hub)

    replays = None
    if args.replay:
        replays = {}
        for node, trace in fleet.traces.items():
            rep = TraceReplayer().replay(trace_to_commands(trace))
            replays[node] = rep
            fm.add_replay(node, rep)

    problems = []
    for node in fleet.traces:
        s = fleet.hubs[node].summary()
        mix = s["dispatch_mix"]
        line = (f"[fleet] node {node}: "
                f"{s['requests']['arrived']} requests, "
                f"{s['requests']['tokens_generated']} tokens, "
                f"{mix['total']} dispatches, {mix['host_syncs']} syncs, "
                f"ttft p50/p99 = {s['ttft_ticks']['p50']:.1f}/"
                f"{s['ttft_ticks']['p99']:.1f} ticks")
        if replays is not None:
            r = replays[node]
            line += (f", simulated IANUS MU "
                     f"{r.result.group_utilization('MU'):.1%} / "
                     f"PIM {r.result.group_utilization('PIM'):.1%}")
        print(line)
    events = fleet_events(fleet.traces,
                          replays={n: r.result for n, r in replays.items()}
                          if replays else None)
    for node, trace in fleet.traces.items():
        pid_engine, _slots, _sim = fleet_node_pids(node)
        for p in check_coverage(trace, events, pid=pid_engine):
            problems.append(f"node {node}: {p}")
    for p in problems:
        print(f"[fleet] COVERAGE FAIL: {p}")

    fs = fm.summary()
    print(f"[fleet] fleet ttft p50/p99 = {fs['ttft_ticks']['p50']:.1f}/"
          f"{fs['ttft_ticks']['p99']:.1f} ticks, tpot p50/p99 = "
          f"{fs['tpot_ticks']['p50']:.1f}/{fs['tpot_ticks']['p99']:.1f}; "
          f"request share "
          + "/".join(f"{fs['imbalance']['request_share'][n]:.2f}"
                     for n in fs["imbalance"]["request_share"])
          + f", queue-depth spread {fs['imbalance']['queue_depth_spread']:g}")
    if fs["utilization"]:
        u = fs["utilization"]["fleet"]
        print(f"[fleet] simulated IANUS fleet utilization: MU {u['mu']:.1%} "
              f"/ PIM {u['pim']:.1%}")
    if fs.get("chaos"):
        c = fs["chaos"]
        print(f"[fleet] chaos: goodput {c['goodput']:.2f} "
              f"({c['completed']}/{c['offered']}), "
              f"{c['recovered']} recovered "
              f"({c['reprefill_tokens']} re-prefill tokens), "
              f"{len(c['failed'])} failed, {len(c['rejected'])} rejected")
        sn = c.get("snapshots") or {}
        if sn.get("events"):
            print(f"[fleet] snapshots: {sn['events']} exports "
                  f"({sn['bytes']} bytes, {sn['rows']} KV rows), "
                  f"{sn['restores']} restores "
                  f"(hit rate {sn['restore_hit_rate']:.2f}), re-prefill "
                  f"saved/paid = {sn['saved_tokens']}/{sn['paid_tokens']} "
                  f"tokens")

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(fm.to_dict(), f, indent=2)
        print(f"[fleet] wrote fleet metrics -> {args.metrics_out}")
    if args.timeline_out:
        write_chrome_trace(args.timeline_out, events)
        print(f"[fleet] wrote {len(events)} trace events -> "
              f"{args.timeline_out} (load in https://ui.perfetto.dev)")
    if args.traces_out:
        os.makedirs(args.traces_out, exist_ok=True)
        for node, trace in fleet.traces.items():
            path = os.path.join(args.traces_out, f"node{node}.jsonl")
            trace.save(path)
            print(f"[fleet] wrote node {node} trace -> {path}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
