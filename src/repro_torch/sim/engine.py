"""Discrete-event simulator for the IANUS system (paper §6.1).

Greedy list scheduling over a command DAG. Every command occupies one
*execution unit* (per-core MU / VU / DMA engines, the PIM array) and possibly
the shared *memory device* resource, which encodes the unified-memory
constraint: "normal memory accesses and PIM computations cannot be performed
simultaneously" (§1). The partitioned configuration splits that resource in
two (and halves usable PIM throughput, §6.2 Fig. 13).

Scheduling modes:
  scheduled=True  — PAS: dependency-driven greedy overlap; PIM bursts only
                    exclude DMA (macro-PIM-command semantics, §4.3).
  scheduled=False — naive: PIM commands act as barriers (no NPU/PIM overlap,
                    the behaviour the paper attributes to scheduling that
                    "fails to observe the parallelizability").

The port's own copy of ``repro/sim/engine.py``.
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import (
    HardwareModel, IANUS_HW, mu_fc_time, pim_fc_time, vu_time,
)
from repro_torch.core.pas import Command, MU, VU, PIM, DMA, merge_streams


@dataclass(frozen=True)
class SimConfig:
    hw: HardwareModel = IANUS_HW
    unified: bool = True
    scheduled: bool = True
    # fixed per-command issue overhead (command scheduler, queue occupancy)
    issue_overhead: float = 0.2e-6
    # PIM macro-command decode overhead is pipelined away (paper §6.1:
    # "designed its operations to be pipelined with PIM computations")
    pim_macro_overhead: float = 0.5e-6
    # AM<->WM streaming-buffer path (on-chip transpose, §4.2.1)
    onchip_bw: float = 1e12
    dma_engines_per_core: int = 2
    trace: bool = False


@dataclass
class SimResult:
    makespan: float
    unit_busy: Dict[str, float]
    tag_time: Dict[str, float]
    energy: Dict[str, float]
    trace: List[Tuple[float, float, str, str, str]] = field(default_factory=list)
    n_commands: int = 0

    def utilization(self, unit: str) -> float:
        return self.unit_busy.get(unit, 0.0) / self.makespan if self.makespan else 0.0

    def concurrency(self) -> float:
        """Mean number of busy unit instances over the makespan (>1 ⇒ the
        schedule actually overlaps work across units — the metric the
        overlapped phase-stream scoring reports)."""
        if not self.makespan:
            return 0.0
        return sum(self.unit_busy.values()) / self.makespan

    def group_utilization(self, prefix: str) -> float:
        """Mean busy fraction over all unit instances with this prefix
        ("MU" averages MU0..MU3; "PIM" is the single array)."""
        units = [u for u in self.unit_busy if u.startswith(prefix)]
        if not units or not self.makespan:
            return 0.0
        return sum(self.unit_busy[u] for u in units) \
            / (len(units) * self.makespan)

    def to_dict(self) -> dict:
        """JSON-safe breakdown export (the trace-replay artifact format):
        drops the raw event trace, keeps everything a Fig. 10-style report
        needs."""
        return {
            "makespan": self.makespan,
            "n_commands": self.n_commands,
            "unit_busy": dict(self.unit_busy),
            "tag_time": dict(self.tag_time),
            "energy": dict(self.energy),
            "utilization": {p: self.group_utilization(p)
                            for p in ("MU", "VU", "PIM", "DMA")},
            "concurrency": self.concurrency(),
        }

    def exposed_tag_time(self) -> Dict[str, float]:
        """Wall-clock-style per-tag attribution (requires trace=True):
        compute-unit busy time is charged fully; DMA time is charged only
        where it is NOT overlapped by concurrent compute — matching how the
        paper measures op-group latency (hidden prefetch costs nothing)."""
        assert self.trace, "run with SimConfig(trace=True)"
        comp = sorted((s, e) for s, e, u, _n, _t in self.trace
                      if u.startswith(("MU", "VU", "PIM")) and e > s)
        merged: List[List[float]] = []
        for s, e in comp:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])

        def overlap(s, e):
            tot = 0.0
            for ms, me in merged:
                if me <= s:
                    continue
                if ms >= e:
                    break
                tot += min(e, me) - max(s, ms)
            return tot

        tags: Dict[str, float] = {}
        for s, e, u, _name, tag in self.trace:
            if e <= s:
                continue
            if u.startswith(("MU", "VU", "PIM")):
                tags[tag] = tags.get(tag, 0.0) + (e - s)
            else:  # DMA: exposed portion only
                tags[tag] = tags.get(tag, 0.0) + (e - s) - overlap(s, e)
        return tags


class Simulator:
    def __init__(self, cfg: SimConfig = SimConfig()):
        self.cfg = cfg

    # ---- per-command service time ---------------------------------------- #
    def duration(self, c: Command) -> float:
        hw = self.cfg.hw
        if c.unit == MU:
            assert c.fc is not None, c
            return mu_fc_time(hw, c.n_tokens, c.fc) + self.cfg.issue_overhead
        if c.unit == VU:
            return vu_time(hw, c.n_tokens, c.dim, c.vu_passes) \
                + self.cfg.issue_overhead
        if c.unit == PIM:
            if c.kind == "vec":           # activation fused after FC: free
                return 0.0
            assert c.fc is not None, c
            t = pim_fc_time(hw, c.n_tokens, c.fc)
            if not self.cfg.unified:
                t *= 2.0                  # half the PIM devices usable (§6.2)
            return t + self.cfg.pim_macro_overhead
        if c.unit == DMA:
            if c.bytes == 0:
                return self.cfg.issue_overhead
            bw = (self.cfg.onchip_bw if c.kind == "dma_onchip"
                  else hw.ext_bw * hw.ext_bw_eff)
            return c.bytes / bw + self.cfg.issue_overhead
        raise ValueError(c.unit)

    def _uses_memory_device(self, c: Command) -> bool:
        """Off-chip traffic: DMA loads/stores (on-chip transposes have
        bytes routed through the streaming buffer -> kind 'dma_onchip')."""
        if c.unit == DMA and c.kind != "dma_onchip":
            return True
        if c.unit == PIM and c.kind != "vec":
            return True
        return False

    # ---- scheduler -------------------------------------------------------- #
    def run(self, commands: Sequence[Command]) -> SimResult:
        cfg = self.cfg
        n = len(commands)
        deps: List[Tuple[int, ...]] = [c.deps for c in commands]

        if not cfg.scheduled:
            # naive: PIM commands are barriers in program order
            deps = [list(d) for d in deps]
            last_pim = -1
            issued: List[int] = []
            for i, c in enumerate(commands):
                if c.unit == PIM:
                    deps[i] = tuple(sorted(set(list(deps[i]) + issued)))
                    last_pim = i
                elif last_pim >= 0:
                    deps[i] = tuple(sorted(set(list(deps[i]) + [last_pim])))
                else:
                    deps[i] = tuple(deps[i])
                issued.append(i)
            deps = [tuple(d) for d in deps]

        indeg = [len(d) for d in deps]
        children: List[List[int]] = [[] for _ in range(n)]
        for i, d in enumerate(deps):
            for j in d:
                children[j].append(i)

        # unit instances
        unit_free: Dict[str, float] = {}
        for core in range(cfg.hw.mu_cores):
            unit_free[f"MU{core}"] = 0.0
            unit_free[f"VU{core}"] = 0.0
            for e in range(cfg.dma_engines_per_core):
                unit_free[f"DMA{core}.{e}"] = 0.0
        unit_free["PIM"] = 0.0
        # shared memory-device resource (the unified-memory constraint)
        mem_free = {"mem": 0.0} if cfg.unified else \
                   {"mem_npu": 0.0, "mem_pim": 0.0}

        def unit_instance(c: Command) -> str:
            core = c.core % cfg.hw.mu_cores   # graphs emit 4-way; clamp for
            if c.unit == PIM:                 # the Fig. 15 core sweeps
                return "PIM"
            if c.unit == DMA:
                # pick the earliest-free DMA engine on the command's core
                engines = [f"DMA{core}.{e}"
                           for e in range(cfg.dma_engines_per_core)]
                return min(engines, key=lambda u: unit_free[u])
            return f"{c.unit}{core}"

        def mem_resource(c: Command) -> Optional[str]:
            if not self._uses_memory_device(c):
                return None
            if cfg.unified:
                return "mem"
            return "mem_pim" if c.unit == PIM else "mem_npu"

        ready_time = [0.0] * n
        done_time = [0.0] * n
        ready: List[int] = [i for i in range(n) if indeg[i] == 0]
        heapq.heapify(ready)
        finished = 0
        busy: Dict[str, float] = {k: 0.0 for k in unit_free}
        tag_time: Dict[str, float] = {}
        trace: List[Tuple[float, float, str, str]] = []
        energy = {"mu_flops": 0.0, "vu_elems": 0.0, "pim_bytes": 0.0,
                  "dram_bytes": 0.0}

        while ready:
            # greedy: among ready commands pick the one that can start first
            best, best_start, best_unit = None, float("inf"), None
            pending: List[int] = []
            while ready:
                i = heapq.heappop(ready)
                pending.append(i)
            for i in pending:
                c = commands[i]
                u = unit_instance(c)
                start = max(ready_time[i], unit_free[u])
                m = mem_resource(c)
                if m is not None:
                    start = max(start, mem_free[m])
                if start < best_start or (start == best_start and
                                          (best is None or i < best)):
                    best, best_start, best_unit = i, start, u
            for i in pending:
                if i != best:
                    heapq.heappush(ready, i)

            i, c = best, commands[best]
            dur = self.duration(c)
            end = best_start + dur
            unit_free[best_unit] = end
            m = mem_resource(c)
            if m is not None:
                mem_free[m] = end
            busy[best_unit] = busy.get(best_unit, 0.0) + dur
            tag_time[c.tag or c.kind] = tag_time.get(c.tag or c.kind, 0.0) + dur
            if cfg.trace:
                trace.append((best_start, end, best_unit, c.name,
                              c.tag or c.kind))
            done_time[i] = end
            finished += 1

            # energy bookkeeping
            hw = cfg.hw
            if c.unit == MU and c.fc is not None:
                energy["mu_flops"] += 2.0 * c.n_tokens * c.fc.weight_elems
            elif c.unit == VU:
                energy["vu_elems"] += c.n_tokens * c.dim * c.vu_passes
            elif c.unit == PIM and c.fc is not None:
                energy["pim_bytes"] += (c.n_tokens * c.fc.weight_elems
                                        * hw.bytes_per_elem)
            elif c.unit == DMA and c.kind != "dma_onchip":
                energy["dram_bytes"] += c.bytes

            for ch in children[i]:
                indeg[ch] -= 1
                ready_time[ch] = max(ready_time[ch], end)
                if indeg[ch] == 0:
                    heapq.heappush(ready, ch)

        assert finished == n, f"deadlock: {finished}/{n} executed"
        makespan = max(done_time) if n else 0.0
        return SimResult(makespan=makespan, unit_busy=busy, tag_time=tag_time,
                         energy=energy, trace=trace, n_commands=n)

    def run_streams(self, streams: Sequence[Sequence[Command]],
                    mode: str = "parallel") -> SimResult:
        """Score several command streams as ONE scheduling problem
        (``core.pas.merge_streams``): mode="parallel" for the co-scheduled
        phase streams of an overlapped serving step (prefill chunk + decode
        contending for units and the unified memory device), "pipelined"
        for consecutive steps with cross-step weight prefetch."""
        return self.run(merge_streams(streams, mode))


# --------------------------------------------------------------------------- #
# replay composition: a served trace lowers to one command stream per engine
# step; steps execute back-to-back, so their results compose sequentially
# --------------------------------------------------------------------------- #
def merge_results(results: Sequence[SimResult]) -> SimResult:
    """Sequential composition of per-step SimResults (trace replay): the
    makespan is the sum, busy/tag/energy accumulate, and per-step event
    traces are shifted onto one global timeline so ``exposed_tag_time``
    still attributes DMA overlap correctly within each step."""
    busy: Dict[str, float] = {}
    tags: Dict[str, float] = {}
    energy: Dict[str, float] = {}
    trace: List[Tuple[float, float, str, str, str]] = []
    t0, n_cmds = 0.0, 0
    for r in results:
        for k, v in r.unit_busy.items():
            busy[k] = busy.get(k, 0.0) + v
        for k, v in r.tag_time.items():
            tags[k] = tags.get(k, 0.0) + v
        for k, v in r.energy.items():
            energy[k] = energy.get(k, 0.0) + v
        for s, e, u, name, tag in r.trace:
            trace.append((s + t0, e + t0, u, name, tag))
        t0 += r.makespan
        n_cmds += r.n_commands
    return SimResult(makespan=t0, unit_busy=busy, tag_time=tags,
                     energy=energy, trace=trace, n_commands=n_cmds)
