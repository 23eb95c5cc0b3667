"""Replay a lowered workload trace through the discrete-event simulator.

``TraceReplayer`` runs every lowered step's command stream through
``sim.Simulator`` and composes the per-step results (served steps execute
back-to-back), producing a Fig. 10-style per-tag breakdown, per-phase
latency split, and NPU/PIM utilization for the *served* workload — plus the
live-vs-offline FC routing divergence report.

Two scheduler-era extensions:

  * **Overlapped steps** (schema v2, interleaved / pim_aware policies): a
    prefill chunk co-scheduled with a decode dispatch replays as ONE merged
    command DAG (``core.pas.merge_streams`` parallel mode), so the
    simulator scores the NPU/PIM overlap under the machine's real resource
    constraints (per-core units, the PIM array, the shared unified-memory
    device). ``overlap_stats`` reports the gain vs running the same
    streams back-to-back.
  * **Cross-step pipelining** (``replay(..., cross_step=True)``): the whole
    served sequence is additionally chained into one pipelined DAG in which
    step k+1's FC *weight* loads may prefetch during step k's tail (their
    operands are static; everything else stays chained). This is the
    ROADMAP "trace-driven sim scenarios" item: ``pipeline`` reports the
    chained makespan and its gain over back-to-back composition, and the
    breakdown/utilization switch to the pipelined timeline.
  * **Fused / superstep dispatches** (schema v4): an overlapped step whose
    events carry ``fused`` ran as ONE device program — it scores with a
    single shared issue root, while an unfused overlapped pair pays chained
    per-dispatch issue slots (the host launched them back-to-back). The k
    per-step decode events of one SUPERSTEP dispatch replay as one
    pipelined DAG (``merge_streams(mode="pipelined")``): inside a single
    program the next round's FC weight streams genuinely start during the
    current round's tail. ``superstep_stats`` reports the span count and
    the pipelining gain.
  * **Windowed pipelining** (``replay(..., cross_step=True, window=N)``):
    one whole-trace DAG is O((steps * commands)^2)-ish to schedule — fine
    at smoke dims, hostile at paper-scale dims over long traces. A window
    bounds the DAG: consecutive steps are chained N at a time and the
    windows compose back-to-back, so sim cost is O(steps/N) problems of
    bounded size while prefetch still crosses every intra-window boundary
    (only one in N boundaries loses its prefetch opportunity).

The port's own copy of ``repro/trace/replay.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pas import merge_streams
from repro_torch.sim import baselines
from repro_torch.sim.engine import (SimConfig, SimResult, Simulator,
                                    merge_results)
from repro_torch.trace.lower import (LoweredStep, divergence_report,
                                     group_dispatch_spans)


@dataclass
class ReplayResult:
    """Aggregated replay of one trace on one simulator configuration."""
    result: SimResult                   # merged over all steps
    phase_time: Dict[str, float]        # summarization / generation /
    phase_steps: Dict[str, int]         #   overlapped makespan + step counts
    exposed_tags: Dict[str, float]      # Fig. 10 attribution (exposed DMA)
    divergence: List[dict] = field(default_factory=list)
    # overlapped-step scoring: groups = co-scheduled steps merged into one
    # DAG; gain = back-to-back time of their streams minus merged time;
    # fused_groups = groups that ran as ONE dispatch (schema v4) and were
    # scored with a single shared issue root instead of chained issues
    overlap_stats: Dict[str, float] = field(default_factory=dict)
    # superstep scoring (schema v4): spans = multi-step decode dispatches,
    # steps = decode rounds they covered, gain = back-to-back time of the
    # inner steps minus the pipelined single-program time
    superstep_stats: Dict[str, float] = field(default_factory=dict)
    # cross-step pipelining (cross_step=True): chained-DAG makespan + gain
    pipeline: Optional[Dict[str, float]] = None

    @property
    def makespan(self) -> float:
        return self.result.makespan

    def to_dict(self) -> dict:
        return {
            "breakdown": self.result.to_dict(),
            "phase_time": dict(self.phase_time),
            "phase_steps": dict(self.phase_steps),
            "exposed_tags": dict(self.exposed_tags),
            "divergence": [dict(r) for r in self.divergence],
            "overlap_stats": dict(self.overlap_stats),
            "superstep_stats": dict(self.superstep_stats),
            "pipeline": dict(self.pipeline) if self.pipeline else None,
        }


class TraceReplayer:
    """Drive the simulator over a lowered trace.

    The simulator must run with ``trace=True`` so the exposed-DMA tag
    attribution (how the paper measures Fig. 10) is available; the default
    configuration is the IANUS machine with the benchmark issue overhead."""

    def __init__(self, sim: Optional[Simulator] = None):
        if sim is None:
            sim = Simulator(SimConfig(trace=True, issue_overhead=0.1e-6))
        if not sim.cfg.trace:
            raise ValueError("TraceReplayer needs SimConfig(trace=True) "
                             "for exposed-tag attribution")
        self.sim = sim

    def replay(self, lowered: List[LoweredStep], *,
               cross_step: bool = False,
               window: Optional[int] = None) -> ReplayResult:
        phase_time = {"summarization": 0.0, "generation": 0.0,
                      "overlapped": 0.0}
        phase_steps = {"summarization": 0, "generation": 0, "overlapped": 0}
        results: List[SimResult] = []
        streams: List[List] = []        # command stream charged per group
        overlapped_groups = 0
        fused_groups = 0
        serialized_time = 0.0           # back-to-back time of merged streams
        merged_time = 0.0
        ss_spans, ss_steps = 0, 0
        ss_serial_time, ss_chained_time = 0.0, 0.0
        for group in group_dispatch_spans(lowered):
            if len(group) == 1:
                ls = group[0]
                r = self.sim.run(ls.commands)
                phase_time[ls.phase] += r.makespan
                phase_steps[ls.phase] += 1
                results.append(r)
                streams.append(ls.commands)
            elif group[0].overlap:
                # one overlapped serving step: fused pairs (schema v4) ran
                # as ONE dispatch and score a single shared issue root; the
                # unfused pair was two back-to-back host launches, so its
                # per-stream issue slots chain
                fused = all(ls.fused for ls in group)
                cmds = merge_streams(
                    [ls.commands for ls in group], mode="parallel",
                    issue_mode="shared" if fused else "chained")
                r = self.sim.run(cmds)
                solo = sum(self.sim.run(ls.commands).makespan
                           for ls in group)
                overlapped_groups += 1
                fused_groups += fused
                serialized_time += solo
                merged_time += r.makespan
                phase_time["overlapped"] += r.makespan
                phase_steps["overlapped"] += 1
                results.append(r)
                streams.append(cmds)
            else:
                # a decode superstep's inner steps: one device program whose
                # consecutive rounds genuinely pipeline (the next round's FC
                # weight streams start during the current round's tail)
                cmds = merge_streams([ls.commands for ls in group],
                                     mode="pipelined")
                r = self.sim.run(cmds)
                solo = sum(self.sim.run(ls.commands).makespan
                           for ls in group)
                ss_spans += 1
                ss_steps += len(group)
                ss_serial_time += solo
                ss_chained_time += r.makespan
                phase_time["generation"] += r.makespan
                phase_steps["generation"] += len(group)
                results.append(r)
                streams.append(cmds)
        merged = merge_results(results)
        overlap_stats = {
            "groups": overlapped_groups,
            "fused_groups": fused_groups,
            "serialized_time": serialized_time,
            "overlapped_time": merged_time,
            "gain": serialized_time - merged_time,
        }
        superstep_stats = {
            "spans": ss_spans,
            "steps": ss_steps,
            "serialized_time": ss_serial_time,
            "chained_time": ss_chained_time,
            "gain": ss_serial_time - ss_chained_time,
        }
        pipeline = None
        if cross_step and len(streams) > 1:
            if window and window < len(streams):
                # bounded-DAG mode: chain N consecutive steps at a time,
                # compose the windows back-to-back
                parts = []
                for i in range(0, len(streams), window):
                    span = streams[i:i + window]
                    if len(span) == 1:
                        parts.append(self.sim.run(span[0]))
                    else:
                        parts.append(self.sim.run(
                            merge_streams(span, mode="pipelined")))
                chained = merge_results(parts)
                n_windows = len(parts)
            else:
                chained = self.sim.run(merge_streams(streams,
                                                     mode="pipelined"))
                n_windows = 1
            pipeline = {"makespan": chained.makespan,
                        "gain": merged.makespan - chained.makespan,
                        "windows": n_windows,
                        "window": window or len(streams)}
            # the chained run is one coherent timeline: report its breakdown
            # (phase_time keeps the unpipelined per-step attribution)
            merged = chained
        exposed = merged.exposed_tag_time() if merged.trace else {}
        return ReplayResult(result=merged, phase_time=phase_time,
                            phase_steps=phase_steps, exposed_tags=exposed,
                            divergence=divergence_report(lowered),
                            overlap_stats=overlap_stats,
                            superstep_stats=superstep_stats,
                            pipeline=pipeline)


def baseline_comparison(lowered: List[LoweredStep],
                        cfg: ModelConfig) -> Dict[str, dict]:
    """Replay the same served step sequence through the calibrated A100/DFX
    analytic models (per-dispatch roofline) for a served-workload analogue
    of the paper's cross-device comparison."""
    steps = [(ls.phase, ls.n_tokens, ls.kv_len) for ls in lowered]
    return {
        "a100": baselines.trace_latency(baselines.A100, cfg, steps),
        "dfx": baselines.trace_latency(baselines.DFX, cfg, steps),
    }
