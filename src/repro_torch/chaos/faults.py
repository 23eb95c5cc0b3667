"""Deterministic fault injection for the fleet replayer (the port's own
copy of ``repro/chaos/faults.py``; paper §5 context:
a unified NPU-PIM node can lose its PIM side and keep serving on normal
memory accesses — chaos serving turns that, plus crashes and stragglers,
into a first-class, replayable regime).

A ``FaultPlan`` is a seeded, fully explicit schedule of fault events on
the GLOBAL fleet clock — no wall time, no randomness at injection time.
The plan serializes into every replica trace's header (schema v7
``chaos`` key), so a recorded chaos run carries everything needed to
replay it bit-identically.

Fault kinds:

node_crash    — instantaneous at ``step``: the node halts forever; its
                in-flight requests fail over (``chaos.recovery``).
pim_degraded  — window [step, until): the node's PIM side is offline;
                every routing decision is forced to the NPU/MU path
                (``ServeEngine.set_degraded`` → ``phase_log_entry``
                ``force_mu`` and the pim_aware overlap gate). Numerics
                are untouched — the node serves slower, not wrong.
slow_node     — window [step, until): straggler; each engine step costs
                ``factor`` fleet ticks instead of 1.
queue_reject  — window [step, until): admission-capacity fault; the
                node's effective admission queue capacity drops to
                ``cap`` and overflow arrivals bounce into the chaos
                driver's backoff/retry loop.

``FleetHealth`` is the live view the router consumes: crashed nodes
leave the ring (``alive``), degraded/slow nodes carry a load penalty so
LeastLoaded steers around them while they limp.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

FAULT_KINDS = ("node_crash", "pim_degraded", "slow_node", "queue_reject")

# load_stats units (queued + busy slots) for the LeastLoaded penalty: a
# degraded node prices like ~2 extra queued requests, a slow node like
# (factor - 1) of them — enough to steer, not enough to starve the node
DEGRADED_PENALTY = 2.0


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``until`` is exclusive and None for the
    instantaneous ``node_crash``; ``factor``/``cap`` only apply to
    slow_node / queue_reject respectively."""
    kind: str
    node: int
    step: int
    until: Optional[int] = None
    factor: int = 2
    cap: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (have: {FAULT_KINDS})")
        if self.node < 0:
            raise ValueError(f"fault node must be >= 0, got {self.node}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind == "node_crash":
            if self.until is not None:
                raise ValueError("node_crash is instantaneous (no until)")
        else:
            if self.until is None or self.until <= self.step:
                raise ValueError(
                    f"{self.kind} needs until > step, got "
                    f"step={self.step} until={self.until}")
        if self.kind == "slow_node" and self.factor < 2:
            raise ValueError(f"slow_node factor must be >= 2, "
                             f"got {self.factor}")
        if self.kind == "queue_reject" and self.cap < 0:
            raise ValueError(f"queue_reject cap must be >= 0, "
                             f"got {self.cap}")

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "node": self.node, "step": self.step}
        if self.until is not None:
            d["until"] = self.until
        if self.kind == "slow_node":
            d["factor"] = self.factor
        if self.kind == "queue_reject":
            d["cap"] = self.cap
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(kind=d["kind"], node=int(d["node"]), step=int(d["step"]),
                   until=None if d.get("until") is None else int(d["until"]),
                   factor=int(d.get("factor", 2)), cap=int(d.get("cap", 1)))


@dataclass
class FaultPlan:
    """An ordered fault schedule plus the seed that generated it (seed 0
    for hand-written plans). Events sort by (step, node, kind) so the
    chaos driver applies same-tick transitions deterministically."""
    events: List[FaultEvent] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self.events = sorted(self.events,
                             key=lambda e: (e.step, e.node, e.kind))

    def validate(self, replicas: int) -> "FaultPlan":
        for ev in self.events:
            if ev.node >= replicas:
                raise ValueError(f"fault targets node {ev.node} but the "
                                 f"fleet has {replicas} replicas")
        crashes = [e.node for e in self.events if e.kind == "node_crash"]
        if len(set(crashes)) != len(crashes):
            raise ValueError("a node can only crash once")
        if len(set(crashes)) >= replicas:
            raise ValueError("plan crashes every replica — nothing left "
                             "to fail over to")
        return self

    @property
    def horizon(self) -> int:
        """Last tick any scheduled fault touches."""
        return max((e.until if e.until is not None else e.step + 1
                    for e in self.events), default=0)

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(events=[FaultEvent.from_dict(e) for e in d["events"]],
                   seed=int(d.get("seed", 0)))

    @classmethod
    def load(cls, path) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse a compact CLI spec: ``;``-separated events, each
        ``kind,node=N,step=T[,until=U][,factor=F][,cap=C]`` — e.g.
        ``node_crash,node=1,step=12;pim_degraded,node=0,step=8,until=20``.
        """
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            fields = [p.strip() for p in part.split(",")]
            kw: Dict[str, int] = {}
            for f in fields[1:]:
                if "=" not in f:
                    raise ValueError(f"bad fault field {f!r} in {part!r} "
                                     "(want key=value)")
                k, v = f.split("=", 1)
                kw[k.strip()] = int(v)
            events.append(FaultEvent(kind=fields[0], **kw))
        if not events:
            raise ValueError(f"fault spec {spec!r} contains no events")
        return cls(events=events)

    @classmethod
    def from_cost_model(cls, sim_result, seed: int, *, replicas: int = 2,
                        horizon: int = 32,
                        pim_refresh_threshold: float = 0.5,
                        thermal_threshold: float = 40.0) -> "FaultPlan":
        """Derive a fault schedule from a SIMULATED cost model instead of
        hand-writing one: ``sim_result`` is a ``sim.SimResult`` (or its
        ``to_dict()`` export). Two physical failure modes map to fault
        windows:

        * PIM refresh storms — PIM-array utilization above
          ``pim_refresh_threshold`` means refresh windows can no longer
          hide behind idle banks; the excess becomes ``pim_degraded``
          windows (more and wider the hotter the array runs).
        * thermal throttling — energy density
          (``sim.energy.energy_of(...).total / makespan``, pJ per
          simulated time unit) above ``thermal_threshold`` becomes a
          ``slow_node`` window whose factor scales with the excess.

        ``random.Random(seed)`` places the windows (jitter only — WHAT
        faults exist is a pure function of the cost model), so the same
        (sim_result, seed) pair yields the identical plan forever."""
        from repro_torch.sim.energy import energy_of
        if isinstance(sim_result, dict):
            makespan = float(sim_result.get("makespan", 0.0))
            pim_util = float(
                sim_result.get("utilization", {}).get("PIM", 0.0))
            energy = dict(sim_result.get("energy", {}))
        else:
            makespan = float(sim_result.makespan)
            pim_util = float(sim_result.group_utilization("PIM"))
            energy = dict(sim_result.energy)
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        if pim_util > pim_refresh_threshold:
            excess = (pim_util - pim_refresh_threshold) \
                / max(1.0 - pim_refresh_threshold, 1e-9)
            n_windows = 1 + int(min(excess, 1.0) * 2)       # 1..3
            width = max(2, int(round(min(excess, 1.0) * horizon / 2)))
            for _ in range(n_windows):
                node = rng.randrange(replicas)
                step = rng.randrange(1, max(horizon - width, 2))
                events.append(FaultEvent("pim_degraded", node, step,
                                         until=step + width))
        energy = {k: float(energy.get(k, 0.0))
                  for k in ("mu_flops", "vu_elems", "dram_bytes",
                            "pim_bytes")}
        density = energy_of(energy).total / makespan if makespan else 0.0
        if density > thermal_threshold:
            # each doubling of the thermal excess throttles one step more
            factor = 2 + int(min(density / thermal_threshold - 1.0, 2.0))
            width = max(4, horizon // 4)
            node = rng.randrange(replicas)
            step = rng.randrange(1, max(horizon - width, 2))
            events.append(FaultEvent("slow_node", node, step,
                                     until=step + width, factor=factor))
        return cls(events=events, seed=seed)

    @classmethod
    def generate(cls, seed: int, replicas: int, horizon: int, *,
                 n_faults: int = 3) -> "FaultPlan":
        """Seeded random plan: at most one crash (never the whole fleet),
        plus degraded/slow/reject windows inside ``horizon``. Same seed ⇒
        identical plan, forever — ``random.Random(seed)`` only."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        crashed = False
        for _ in range(n_faults):
            kind = rng.choice(FAULT_KINDS)
            if kind == "node_crash":
                if crashed or replicas < 2:
                    kind = "pim_degraded"
                else:
                    crashed = True
            node = rng.randrange(replicas)
            step = rng.randrange(1, max(horizon - 2, 2))
            if kind == "node_crash":
                events.append(FaultEvent(kind, node, step))
                continue
            until = min(step + rng.randrange(4, 16), horizon + 8)
            events.append(FaultEvent(kind, node, step, until=until,
                                     factor=rng.choice((2, 3)),
                                     cap=rng.choice((0, 1, 2))))
        return cls(events=events, seed=seed)


class FleetHealth:
    """Live per-node health, advanced tick by tick by the chaos driver
    and read by the router (``alive``/``penalty``). Window state carries
    its begin tick so end transitions can report ``since`` (MTTR input).
    """

    def __init__(self, replicas: int):
        self.replicas = replicas
        self._crashed: Dict[int, int] = {}            # node -> crash tick
        self._degraded: Dict[int, Tuple[int, int]] = {}   # node -> (t0, t1)
        self._slow: Dict[int, Tuple[int, int, int]] = {}  # -> (t0, t1, f)
        self._reject: Dict[int, Tuple[int, int, int]] = {}  # -> (t0,t1,cap)

    # ---- router protocol --------------------------------------------------- #
    def alive(self, node: int) -> bool:
        return node not in self._crashed

    def penalty(self, node: int) -> float:
        p = 0.0
        if node in self._degraded:
            p += DEGRADED_PENALTY
        if node in self._slow:
            p += float(self._slow[node][2] - 1)
        if node in self._reject:
            # an admission-throttled node advertises an EMPTY queue, so
            # without a penalty LeastLoaded would keep slamming it
            p += DEGRADED_PENALTY
        return p

    # ---- chaos-driver protocol --------------------------------------------- #
    def crash_tick(self, node: int) -> Optional[int]:
        return self._crashed.get(node)

    def step_cost(self, node: int) -> int:
        """Fleet ticks one engine step costs right now (slow_node)."""
        return self._slow[node][2] if node in self._slow else 1

    def reject_cap(self, node: int) -> Optional[int]:
        """Effective admission-queue capacity during a queue_reject
        window (None outside one = engine default applies)."""
        return self._reject[node][2] if node in self._reject else None

    def begin(self, ev: FaultEvent) -> None:
        if ev.kind == "node_crash":
            self._crashed[ev.node] = ev.step
        elif ev.kind == "pim_degraded":
            self._degraded[ev.node] = (ev.step, ev.until)
        elif ev.kind == "slow_node":
            self._slow[ev.node] = (ev.step, ev.until, ev.factor)
        elif ev.kind == "queue_reject":
            self._reject[ev.node] = (ev.step, ev.until, ev.cap)

    def end(self, ev: FaultEvent) -> None:
        if ev.kind == "pim_degraded":
            self._degraded.pop(ev.node, None)
        elif ev.kind == "slow_node":
            self._slow.pop(ev.node, None)
        elif ev.kind == "queue_reject":
            self._reject.pop(ev.node, None)


__all__ = ["FAULT_KINDS", "DEGRADED_PENALTY", "FaultEvent", "FaultPlan",
           "FleetHealth"]
