"""Lower a recorded workload trace to PAS command streams.

Every schedulable trace event (one batched-prefill dispatch, one decode
step) becomes the command DAG the paper's compiler would emit for exactly
that batch state — ``sim.graphs.build_stage`` with the recorded token count
and attended context, then Algorithm 1 (``adaptive_map``) over the stream.
The per-FC mapping decisions are kept so the replay can diff them against
the live ``route_fc_tpu`` choices the serving engine actually took.

The port's own copy of ``repro/trace/lower.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import HardwareModel, IANUS_HW
from repro_torch.core.pas import (
    Command, MappingDecision, PASPolicy, PIM,
    command_to_dict, decision_to_dict, lower_commands,
)
from repro_torch.sim import graphs
from repro_torch.trace.schema import Trace, model_config_from_header


@dataclass
class LoweredStep:
    """One schedulable trace event, lowered."""
    index: int                 # position among the trace's schedulable events
    step: int                  # engine step the event belongs to
    phase: str                 # "summarization" | "generation"
    n_tokens: int              # tokens in the dispatch
    kv_len: int                # attended context
    commands: List[Command]
    decisions: List[MappingDecision]   # Algorithm-1 log (offline mapping)
    live_route: dict           # the engine's phase_log_entry for this event
    overlap: bool = False      # co-scheduled with the same step's other phase
    sub_batch: int = -1        # prefill sub-batch (admission wave) ordinal
    packed: bool = False       # packed prefill dispatch (schema v3)
    fused: bool = False        # overlapped step ran as ONE dispatch (v4)
    superstep: int = 1         # k of the multi-step decode dispatch (v4)
    superstep_id: int = -1     # superstep dispatch ordinal (-1 = plain)

    def to_dict(self) -> dict:
        return {
            "index": self.index, "step": self.step, "phase": self.phase,
            "n_tokens": self.n_tokens, "kv_len": self.kv_len,
            "commands": [command_to_dict(c) for c in self.commands],
            "decisions": [decision_to_dict(d) for d in self.decisions],
            "live_route": dict(self.live_route),
            "overlap": self.overlap, "sub_batch": self.sub_batch,
            "packed": self.packed, "fused": self.fused,
            "superstep": self.superstep, "superstep_id": self.superstep_id,
        }


def _event_shape(ev: dict) -> tuple:
    """(phase, n_tokens, kv_len, lm_head) for a schedulable event."""
    if ev["type"] == "prefill":
        # a prefill dispatch computes `valid` real tokens attending a
        # context that extends to the end of its chunk window; no logits
        return "summarization", max(ev["valid"], 1), max(ev["kv"], 1), False
    assert ev["type"] == "decode", ev
    active = ev["slots"]
    kv = max((ev["slot_lens"][s] for s in active), default=1)
    return "generation", max(ev["occupancy"], 1), max(kv, 1), True


def trace_to_commands(trace: Trace, cfg: Optional[ModelConfig] = None,
                      policy: PASPolicy = PASPolicy.paper(),
                      hw: HardwareModel = IANUS_HW) -> List[LoweredStep]:
    """Deterministically lower every prefill/decode event in the trace.

    ``cfg`` defaults to the shape recorded in the trace header, so a saved
    JSONL file is self-contained; pass the original config to lower against
    different execution knobs."""
    if cfg is None:
        cfg = model_config_from_header(trace.header)
    base_policy = dataclasses.replace(policy, adaptive_fc=False)
    out: List[LoweredStep] = []
    for idx, ev in enumerate(trace.schedulable):
        phase, n, kv, lm_head = _event_shape(ev)
        cmds = graphs.build_stage(cfg, n, kv, phase, base_policy,
                                  lm_head=lm_head, hw=hw)
        cmds, decisions = lower_commands(cmds, n, hw,
                                         adaptive=policy.adaptive_fc)
        out.append(LoweredStep(index=idx, step=ev["step"], phase=phase,
                               n_tokens=n, kv_len=kv, commands=cmds,
                               decisions=decisions,
                               live_route=dict(ev["route"]),
                               overlap=bool(ev.get("overlap", False)),
                               sub_batch=int(ev.get("sub_batch", -1)),
                               packed=bool(ev.get("packed", False)),
                               fused=bool(ev.get("fused", False)),
                               superstep=int(ev.get("superstep", 1)),
                               superstep_id=int(ev.get("superstep_id",
                                                       -1))))
    return out


def group_overlapped(lowered: List[LoweredStep]) -> List[List[LoweredStep]]:
    """Partition a lowered trace into co-scheduled stream groups.

    Events flagged ``overlap`` that share an engine step were dispatched as
    one overlapped serving step (an interleaved prefill chunk riding the
    resident batch's decode) and form one group — the replay merges their
    command streams into a single DAG (``core.pas.merge_streams``) and
    scores them as one scheduling problem. Everything else (serial traces,
    pim_aware-serialized steps) stays a singleton group, preserving the
    sequential replay semantics byte-for-byte."""
    groups: List[List[LoweredStep]] = []
    for ls in lowered:
        if (ls.overlap and groups and groups[-1][0].overlap
                and groups[-1][0].step == ls.step):
            groups[-1].append(ls)
        else:
            groups.append([ls])
    return groups


def group_dispatch_spans(lowered: List[LoweredStep]
                         ) -> List[List[LoweredStep]]:
    """Partition a lowered trace into the spans that shared a DISPATCH (or
    a co-scheduled step): overlapped same-step events group exactly as
    ``group_overlapped`` (fused or not), and the k per-step decode events a
    SUPERSTEP dispatch expanded into (consecutive, same ``superstep_id``)
    form one span — the replay chains them as the single pipelined device
    program they actually were. Everything else stays a singleton."""
    groups: List[List[LoweredStep]] = []
    for ls in lowered:
        if groups:
            head = groups[-1][0]
            if (ls.overlap and head.overlap and head.step == ls.step):
                groups[-1].append(ls)
                continue
            if (ls.superstep_id >= 0 and ls.phase == "generation"
                    and head.superstep_id == ls.superstep_id):
                groups[-1].append(ls)
                continue
        groups.append([ls])
    return groups


# --------------------------------------------------------------------------- #
# live-vs-offline FC routing divergence
# --------------------------------------------------------------------------- #
def _fc_base(name: str) -> str:
    """"ffn1.2" -> "ffn1" (strip the column-partition core suffix)."""
    head, _, tail = name.rpartition(".")
    return head if head and tail.isdigit() else name


def _live_route_for(fc: str, live: dict) -> str:
    """The engine's decision granularity is per phase, not per command: the
    FFN gets its own ``route_fc_tpu`` call; every other FC follows the
    phase-level GEMV/GEMM path choice."""
    if fc.startswith("ffn"):
        return live["ffn_route"]
    return "gemv" if live["gemv_path"] else "gemm"


def divergence_report(lowered: List[LoweredStep]) -> List[dict]:
    """Per (phase, FC) agreement between what the serving engine routed live
    (TPU twin: gemv = streaming/PIM-analogue path) and what Algorithm 1
    chose offline for the same batch state (PIM = gemv-analogue). One count
    per FC command instance (column-partitioned FCs contribute one per
    core); rows sorted by phase then FC name; `agreement` in [0, 1]."""
    acc: dict = {}
    for ls in lowered:
        for d in ls.decisions:
            fc = _fc_base(d.name)
            live = _live_route_for(fc, ls.live_route)
            offline = "gemv" if d.chosen == PIM else "gemm"
            key = (ls.phase, fc)
            row = acc.setdefault(key, {"phase": ls.phase, "fc": fc,
                                       "n": 0, "live_gemv": 0,
                                       "offline_gemv": 0, "agree": 0})
            row["n"] += 1
            row["live_gemv"] += live == "gemv"
            row["offline_gemv"] += offline == "gemv"
            row["agree"] += live == offline
    rows = []
    for key in sorted(acc):
        row = acc[key]
        row["agreement"] = row["agree"] / row["n"] if row["n"] else 1.0
        rows.append(row)
    return rows
