"""PIM Access Scheduling (PAS), the paper's §5 (the port's own copy of
``repro/core/pas.py``).

Four pieces:
  1. A command IR (``Command``) shared with the discrete-event simulator:
     every LLM operation is a command bound to an execution unit
     (MU / VU / PIM / DMA) with explicit dependencies.
  2. ``adaptive_map``: Algorithm 1 verbatim, an analytical-model-driven
     rewrite of FC commands between the MU and the PIM, with VU-prefetch
     credit and pipelined weight-loading, applied at compile time.
  3. Mapping decisions for multi-head attention (§5.3): QK^T / SV unit
     choice (PIM row-utilization argument) and schedule mode flags that the
     simulator turns into the Fig. 7 overlap structures.
  4. The engine's routing record: each serving dispatch logs its phase and
     the FC route that Algorithm 1's decision procedure picks for it,
     ``gemm`` (matrix-engine path) or ``gemv`` (the streaming matvec path,
     the PIM analogue). Generation steps land on the GEMV side of the
     crossover; the port's decode step runs its FCs through the
     ``pim_matvec`` kernel accordingly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import (
    FCConfig,
    HardwareModel,
    IANUS_HW,
    TPU_V5E,
    attention_gemv_efficiency,
    dma_weight_time,
    mu_fc_time,
    pim_fc_time,
    pipelined_mu_time,
    vu_time,
)

# units
MU, VU, PIM, DMA = "MU", "VU", "PIM", "DMA"
VALID_UNITS = (MU, VU, PIM, DMA)


@dataclass
class Command:
    """One scheduled operation. ``deps`` are indices into the command list."""
    name: str
    unit: str
    kind: str                      # fc | gemv | vec | dma_load | dma_store | noop
    n_tokens: int = 1
    fc: Optional[FCConfig] = None
    dim: int = 0                   # elementwise width for VU ops
    vu_passes: float = 1.0
    bytes: int = 0                 # DMA payload
    deps: Tuple[int, ...] = ()
    tag: str = ""                  # breakdown group (fc_qkv, self_attn, ffn, ...)
    core: int = 0                  # NPU core (attention-head parallelism)
    fused_act: bool = False        # PIM executes GELU after FC (paper §5.2)
    weights_resident: bool = True  # False for QK^T/SV-style dynamic operands:
                                   # Algorithm 1 only maps FCs whose weights
                                   # live in (PIM) memory; attention mapping
                                   # is the MHA schedule's decision (§5.3)

    def __post_init__(self):
        if self.unit not in VALID_UNITS:
            raise ValueError(f"unknown execution unit {self.unit!r} "
                             f"(have: {VALID_UNITS})")

    def retarget(self, unit: str) -> "Command":
        if unit not in VALID_UNITS:
            raise ValueError(f"cannot retarget {self.name!r} to unknown "
                             f"unit {unit!r} (have: {VALID_UNITS})")
        return dataclasses.replace(self, unit=unit)


# --------------------------------------------------------------------------- #
# Algorithm 1 — adaptive mapping for FC layers
# --------------------------------------------------------------------------- #
@dataclass
class MappingDecision:
    index: int
    name: str
    mu_time: float
    pim_time: float
    chosen: str


def estimate_fc_mu_time(hw: HardwareModel, n_tokens: int, fc: FCConfig,
                        prefetch_credit: float = 0.0) -> float:
    """Lines 7-11: pipelined weight-load + MU compute, minus the prefetch
    overlap earned while a preceding VU op runs."""
    return max(0.0, pipelined_mu_time(hw, n_tokens, fc) - prefetch_credit)


def adaptive_map(cmds: Sequence[Command], n_tokens: int,
                 hw: HardwareModel = IANUS_HW,
                 ) -> Tuple[List[Command], List[MappingDecision]]:
    """Algorithm 1. Input: command sequence with FCs mapped to the MU.
    Output: commands with each FC on its faster unit + the decision log.

    Retargeting an FC to the PIM also *voids its weight-load DMA*: the
    weights are computed on in place — the defining benefit of PIM — so the
    normal-memory traffic for them disappears from the schedule."""
    out = list(cmds)
    decisions: List[MappingDecision] = []
    for i, cmd in enumerate(out):
        if cmd.unit != MU or cmd.kind != "fc" or cmd.fc is None \
                or not cmd.weights_resident:
            continue
        # check prefetching (lines 4-6)
        t_prefetch = 0.0
        if i > 0 and out[i - 1].unit == VU:
            t_prefetch = vu_time(hw, n_tokens, out[i - 1].dim,
                                 out[i - 1].vu_passes)
        mu_t = estimate_fc_mu_time(hw, n_tokens, cmd.fc, t_prefetch)
        pim_t = pim_fc_time(hw, n_tokens, cmd.fc)
        chosen = MU
        if pim_t < mu_t:
            chosen = PIM
            out[i] = cmd.retarget(PIM)
            base = cmd.name.rsplit(".", 1)[0]
            for j in cmd.deps:
                dj = out[j]
                if dj.kind == "dma_load" and dj.name.startswith(base + ".w"):
                    out[j] = dataclasses.replace(dj, bytes=0, kind="noop_load")
            # "If the first FC of FFN is mapped to the PIM, the GELU will also
            # be allocated to the PIM" (§5.2): fold the next activation in.
            if i + 1 < len(out) and out[i + 1].unit == VU \
                    and out[i + 1].kind == "vec" and "act" in out[i + 1].name:
                out[i + 1] = dataclasses.replace(
                    out[i + 1], unit=PIM, fused_act=True)
        decisions.append(MappingDecision(i, cmd.name, mu_t, pim_t, chosen))
    return out, decisions


# --------------------------------------------------------------------------- #
# Serialization (trace subsystem: lowered command streams + decisions travel
# through JSONL alongside the recorded workload)
# --------------------------------------------------------------------------- #
def command_to_dict(c: Command) -> dict:
    """JSON-safe form of a Command (FCConfig flattened, deps as a list)."""
    return {
        "name": c.name, "unit": c.unit, "kind": c.kind,
        "n_tokens": c.n_tokens,
        "fc": [c.fc.d_in, c.fc.d_out] if c.fc is not None else None,
        "dim": c.dim, "vu_passes": c.vu_passes, "bytes": c.bytes,
        "deps": list(c.deps), "tag": c.tag, "core": c.core,
        "fused_act": c.fused_act, "weights_resident": c.weights_resident,
    }


def command_from_dict(d: dict, *, index: Optional[int] = None) -> Command:
    """Rebuild a Command from its JSON form. Unknown units are rejected by
    the constructor; with ``index`` (this command's position in its stream)
    dependency references are range-checked, so a truncated or hand-edited
    trace fails loudly instead of deserializing a dangling-dep DAG."""
    fc = FCConfig(*d["fc"]) if d.get("fc") is not None else None
    deps = tuple(d.get("deps", ()))
    if index is not None:
        bad = [dep for dep in deps if not 0 <= int(dep) < index]
        if bad:
            raise ValueError(
                f"command {d.get('name')!r} (index {index}) references "
                f"absent command ids {bad} (deps must point backward)")
    return Command(
        name=d["name"], unit=d["unit"], kind=d["kind"],
        n_tokens=d.get("n_tokens", 1), fc=fc, dim=d.get("dim", 0),
        vu_passes=d.get("vu_passes", 1.0), bytes=d.get("bytes", 0),
        deps=deps, tag=d.get("tag", ""),
        core=d.get("core", 0), fused_act=d.get("fused_act", False),
        weights_resident=d.get("weights_resident", True),
    )


def commands_from_dicts(ds: Sequence[dict]) -> List[Command]:
    """Deserialize a whole command stream with dep-range validation."""
    return [command_from_dict(d, index=i) for i, d in enumerate(ds)]


def decision_to_dict(d: MappingDecision) -> dict:
    return {"index": d.index, "name": d.name, "mu_time": d.mu_time,
            "pim_time": d.pim_time, "chosen": d.chosen}


def decision_from_dict(d: dict) -> MappingDecision:
    return MappingDecision(index=d["index"], name=d["name"],
                           mu_time=d["mu_time"], pim_time=d["pim_time"],
                           chosen=d["chosen"])


def lower_commands(cmds: Sequence[Command], n_tokens: int,
                   hw: HardwareModel = IANUS_HW, adaptive: bool = True,
                   ) -> Tuple[List[Command], List[MappingDecision]]:
    """Trace-lowering entry point: run Algorithm 1 over an MU-mapped stream
    and keep the decision log (``build_stage`` discards it). With
    ``adaptive=False`` the stream passes through untouched — the NPU-MEM /
    naive-mapping replay configurations."""
    if not adaptive:
        return list(cmds), []
    out, decisions = adaptive_map(cmds, n_tokens, hw)
    return out, decisions


# --------------------------------------------------------------------------- #
# Stream composition: overlapped phase streams / cross-step pipelining
# --------------------------------------------------------------------------- #
def _is_weight_load(c: Command) -> bool:
    """FC weight-load DMAs (``<fc>.w<core>``; ``noop_load`` once Algorithm 1
    voids them) — the only loads whose operands are static, and therefore
    the only ones cross-step prefetch may hoist."""
    return c.kind in ("dma_load", "noop_load") and ".w" in c.name


def merge_streams(streams: Sequence[Sequence[Command]],
                  mode: str = "parallel",
                  issue_mode: str = "shared") -> List[Command]:
    """Compose several per-dispatch command streams into ONE command DAG
    with cross-stream dependencies, so the simulator can score them as a
    single scheduling problem instead of back-to-back runs.

    mode="parallel" — co-scheduled phase streams of one overlapped serving
      step (interleaved prefill chunk + resident-batch decode): an issue
      root models the host issuing the step's dispatches; beyond that the
      streams only interact through the machine resources (per-core MU/VU,
      the PIM array, the shared unified-memory device) inside the
      simulator — which is exactly the constraint set the overlap must
      respect. ``issue_mode`` picks the root structure:
        "shared"  — ONE ``step_issue`` root for every stream: the step is a
                    single fused dispatch (``ServeConfig.fuse``; schema-v4
                    ``fused`` events), one program carrying both phases.
        "chained" — one ``step_issue<i>`` root per stream, chained in
                    program order: the host launches the dispatches
                    back-to-back (the unfused overlapped step — device work
                    may still overlap, but each launch waits for the
                    previous issue slot).

    mode="pipelined" — consecutive serving steps with cross-step weight
      prefetch (ROADMAP "trace-driven sim scenarios"): stream k+1's compute
      is chained behind stream k's sinks (its input token / batch state
      exists only once step k finishes), but its FC *weight* loads — whose
      operands are static — are freed to start as soon as step k has
      started, modeling next-step weight prefetch during the current step's
      tail. Dynamic-operand loads (embeddings, KV prefetch) stay chained:
      their contents depend on the previous step's output. (Also how a
      decode SUPERSTEP's inner steps compose: one device program genuinely
      pipelines the next inner step's weight streams.)

    Commands are rebased and renamed ``s<i>.<name>``; Algorithm 1 must run
    per stream *before* merging (its dep-indexed weight-void rewrite and
    prefetch-credit scan assume a single stream in program order)."""
    if mode not in ("parallel", "pipelined"):
        raise ValueError(f"unknown merge mode {mode!r}")
    if issue_mode not in ("shared", "chained"):
        raise ValueError(f"unknown issue mode {issue_mode!r}")
    streams = [list(s) for s in streams]
    if len(streams) == 1:
        return list(streams[0])
    out: List[Command] = []
    issue: Optional[int] = None
    if mode == "parallel" and issue_mode == "shared":
        # one fused dispatch: one issue slot on a DMA queue, no
        # memory-device occupancy (kind dma_onchip, 0 bytes)
        out.append(Command("step_issue", DMA, "dma_onchip", tag="issue"))
        issue = 0
    prev_sources: Tuple[int, ...] = ()
    prev_sinks: Tuple[int, ...] = ()
    for si, stream in enumerate(streams):
        if mode == "parallel" and issue_mode == "chained":
            # separate host dispatches: each stream's issue slot is chained
            # behind the previous stream's (launch order is serial even
            # when the launched device work overlaps)
            deps_i = (issue,) if issue is not None else ()
            out.append(Command(f"step_issue{si}", DMA, "dma_onchip",
                               tag="issue", deps=deps_i))
            issue = len(out) - 1
        off = len(out)
        has_child = [False] * len(stream)
        for c in stream:
            for d in c.deps:
                has_child[d] = True
        src_local = {i for i, c in enumerate(stream) if not c.deps}
        for i, c in enumerate(stream):
            deps = tuple(d + off for d in c.deps)
            if mode == "parallel":
                if not deps:
                    deps = (issue,)
            elif si > 0:
                if _is_weight_load(c) and c.deps \
                        and all(d in src_local for d in c.deps):
                    # static weight tiles: prefetch window opens with the
                    # previous step's start, not its completion
                    deps = prev_sources
                elif not c.deps:
                    # the stream's root (token/embedding load): the next
                    # step's input exists only after the previous step
                    deps = prev_sinks
            out.append(dataclasses.replace(c, name=f"s{si}.{c.name}",
                                           deps=deps))
        if mode == "pipelined":
            prev_sources = tuple(off + i for i in sorted(src_local)) \
                or prev_sources
            prev_sinks = tuple(off + i for i, hc in enumerate(has_child)
                               if not hc)
    return out


# --------------------------------------------------------------------------- #
# Multi-head attention mapping (§5.3)
# --------------------------------------------------------------------------- #
def decide_qk_sv_unit(hw: HardwareModel, head_dim: int, kv_len: int,
                      n_heads: int) -> Dict[str, object]:
    """Generation-stage QK^T / SV placement.

    PIM avoids loading K_prev/V_prev but wastes the DRAM row (efficiency
    head_dim/row = 6.25% at 64) and serializes against the FCs already on
    PIM. The MU mapping costs the K/V load (overlappable by prefetch) but
    frees PIM/MU parallelism — the paper chooses the MU (Fig. 7c)."""
    eff = attention_gemv_efficiency(hw, head_dim)
    kv_bytes = 2 * kv_len * head_dim * hw.bytes_per_elem  # K and V of one head
    # per-head QK^T + SV = two (kv_len x head_dim) GEMVs
    gemv_elems = 2 * kv_len * head_dim
    pim_t = gemv_elems * hw.bytes_per_elem / (hw.pim_internal_bw * eff) \
        if hw.pim_internal_bw else float("inf")
    mu_t = 2.0 * 2 * gemv_elems / hw.mu_flops + kv_bytes / hw.ext_bw
    # prefetching K_prev of the next head hides the load (paper: "its small
    # size compared to the FC weight allows for prefetching")
    mu_t_scheduled = max(2.0 * 2 * gemv_elems / hw.mu_flops,
                         kv_bytes / hw.ext_bw)
    unit = MU if mu_t_scheduled <= pim_t else PIM
    return {"unit": unit, "pim_efficiency": eff, "pim_time": pim_t,
            "mu_time": mu_t, "mu_time_scheduled": mu_t_scheduled}


# --------------------------------------------------------------------------- #
# The engine's routing record: phase-aware FC routing for each dispatch
# --------------------------------------------------------------------------- #
def route_fc_tpu(n_tokens: int, d_in: int, d_out: int,
                 hw: HardwareModel = TPU_V5E) -> str:
    """'gemm' vs 'gemv' for an FC of n_tokens rows."""
    fc = FCConfig(d_in, d_out)
    gemm_t = pipelined_mu_time(hw, n_tokens, fc)
    gemv_t = pim_fc_time(hw, n_tokens, fc)
    return "gemv" if gemv_t < gemm_t else "gemm"


def decode_uses_gemv(batch_per_device: int,
                     hw: HardwareModel = TPU_V5E) -> bool:
    """Below the matrix engine's token parallelism the GEMV path wins."""
    return batch_per_device < hw.mu_token_parallel


def phase_log_entry(phase: str, n_tokens: int, active: int,
                    d_model: int, d_ff: int,
                    hw: HardwareModel = TPU_V5E,
                    force_mu: bool = False) -> dict:
    """One serving-step record: ``phase`` is "summarization" (n_tokens =
    prompt tokens in the dispatch) or "generation" (n_tokens = active
    slots). ``force_mu`` records a PIM-degraded node: every FC on the
    matrix-engine path."""
    n = max(n_tokens, 1)
    if force_mu:
        return {"phase": phase, "tokens": n_tokens, "active": active,
                "gemv_path": False, "ffn_route": "gemm"}
    return {"phase": phase, "tokens": n_tokens, "active": active,
            "gemv_path": decode_uses_gemv(n, hw),
            "ffn_route": route_fc_tpu(n, d_model, d_ff, hw)}


# --------------------------------------------------------------------------- #
# Schedule policy record (consumed by the simulator)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class PASPolicy:
    """What the scheduler is allowed to exploit (paper Fig. 13 knobs)."""
    adaptive_fc: bool = True       # Algorithm 1 on/off
    qk_sv_unit: str = MU           # "MU" (Fig 7c) | "PIM" (Fig 7b)
    scheduled: bool = True         # unified-memory-aware overlap vs naive
    unified_memory: bool = True    # unified (shared) vs partitioned memory

    @staticmethod
    def naive() -> "PASPolicy":
        """Fig. 13 'naive' bar: FC mapping unchanged (adaptive still routes
        GEMVs to PIM — mapping is not the variable), QK^T/SV on PIM, and no
        unified-memory-aware overlap scheduling."""
        return PASPolicy(adaptive_fc=True, qk_sv_unit=PIM,
                         scheduled=False, unified_memory=True)

    @staticmethod
    def paper() -> "PASPolicy":
        return PASPolicy()
