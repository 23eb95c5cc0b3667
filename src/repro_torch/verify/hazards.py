"""Hazard analysis over PAS command DAGs.

``analyze_commands`` computes happens-before from the dependency edges
(bitset ancestor masks — deps point strictly backward, so one pass in index
order closes the relation) and reports every pair of commands that touch a
conflicting footprint (``verify.footprints``) without an ordering edge
between them:

  raw / war / waw          unordered write-read / read-write / write-write
                           on the same resource instance
  pim_normal_unordered     the IANUS class (paper §5): a PIM compute
                           command unordered with a normal memory access
                           whose data footprint collides — unified memory
                           cannot serve both sides at once, and without an
                           ordering edge the value read is timing-dependent
  dangling_dep/forward_dep malformed graphs (out-of-range or
                           forward-pointing deps) — reported and the
                           footprint pass skipped

``diff_commands`` / ``verify_lowered_step`` check a lowered step against
the DAG the deterministic lowering pipeline (``sim.graphs.build_stage`` +
Algorithm 1) produces for the same (phase, tokens, kv, policy): lowering
has no other inputs, so ANY dropped dependency edge — including pure
scheduling/activation edges with no memory footprint — surfaces as a
``missing_dep`` finding, while the footprint pass independently classifies
the data-carrying ones. ``analyze_lowered`` runs the hazard pass over every
dispatch-span DAG of a lowered trace exactly as the replay merges them
(fused -> shared issue root, unfused overlap -> chained, superstep ->
pipelined).

The port's own copy of ``repro/verify/hazards.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import HardwareModel, IANUS_HW
from repro_torch.core.pas import (Command, PASPolicy, lower_commands,
                                  merge_streams)
from repro_torch.sim import graphs
from repro_torch.verify.footprints import (Footprint, Resource, bank_set,
                                           command_footprints)

SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    """One verification finding, shared by every verify pass."""
    severity: str                   # "error" | "warning" | "info"
    klass: str                      # finding class (see module docstrings)
    message: str
    commands: Tuple[int, ...] = ()  # command indices (DAG findings)
    names: Tuple[str, ...] = ()     # command names (DAG findings)
    resource: str = ""              # conflicting resource, if any
    witness: Tuple[str, ...] = ()   # nearest-common-ancestor path context
    location: str = ""              # trace event / source position

    def to_dict(self) -> dict:
        return {"severity": self.severity, "class": self.klass,
                "message": self.message, "commands": list(self.commands),
                "names": list(self.names), "resource": self.resource,
                "witness": list(self.witness), "location": self.location}


def _structural(cmds: Sequence[Command]) -> List[Finding]:
    out: List[Finding] = []
    n = len(cmds)
    for i, c in enumerate(cmds):
        for d in c.deps:
            if not 0 <= d < n:
                out.append(Finding(
                    "error", "dangling_dep",
                    f"command {i} ({c.name!r}) depends on absent "
                    f"command id {d}", commands=(i,), names=(c.name,)))
            elif d >= i:
                out.append(Finding(
                    "error", "forward_dep",
                    f"command {i} ({c.name!r}) depends on later command "
                    f"{d} ({cmds[d].name!r}); deps must point backward",
                    commands=(i, d), names=(c.name, cmds[d].name)))
    return out


def _ancestor_masks(cmds: Sequence[Command]) -> List[int]:
    """Bitmask of (transitive) ancestors per command. deps < index, so one
    forward pass closes the relation."""
    anc: List[int] = []
    for i, c in enumerate(cmds):
        m = 0
        for d in c.deps:
            m |= anc[d] | (1 << d)
        anc.append(m)
    return anc


def _witness(cmds: Sequence[Command], anc: List[int],
             i: int, j: int) -> Tuple[str, ...]:
    """Names on a path from the latest common ancestor to each of i and j —
    the context a reader needs to see where the ordering chain forked."""
    common = anc[i] & anc[j]
    if not common:
        return ()
    lca = common.bit_length() - 1

    def climb(x: int) -> List[str]:
        path = [cmds[x].name]
        while x != lca:
            nxt = None
            for d in cmds[x].deps:
                if d == lca or (anc[d] >> lca) & 1:
                    nxt = d
                    break
            if nxt is None:
                break
            path.append(cmds[nxt].name)
            x = nxt
        return path

    left = climb(i)
    right = climb(j)
    return tuple(reversed(left)) + ("<fork>",) + tuple(right[:-1])


def _classify(fi: Footprint, fj: Footprint, wi: bool, wj: bool) -> str:
    if (fi.pim_compute and fj.normal_access) \
            or (fj.pim_compute and fi.normal_access):
        return "pim_normal_unordered"
    if wi and wj:
        return "waw"
    return "raw" if wi else "war"


def analyze_commands(cmds: Sequence[Command]) -> List[Finding]:
    """All hazard findings for one command DAG (empty = hazard-free)."""
    findings = _structural(cmds)
    if findings:
        return findings
    fps = command_footprints(cmds)
    anc = _ancestor_masks(cmds)

    # group accesses by (space, key); only same-instance pairs can conflict
    groups: dict = {}
    for i, fp in enumerate(fps):
        for res in fp.reads:
            groups.setdefault((res.space, res.key), []).append(
                (i, res, False))
        for res in fp.writes:
            groups.setdefault((res.space, res.key), []).append(
                (i, res, True))

    seen = set()
    for accesses in groups.values():
        if not any(w for _, _, w in accesses):
            continue
        for a in range(len(accesses)):
            i, ri, wi = accesses[a]
            for b in range(a + 1, len(accesses)):
                j, rj, wj = accesses[b]
                if i == j or not (wi or wj) or not ri.overlaps(rj):
                    continue
                lo, hi = (i, j) if i < j else (j, i)
                if (lo, hi) in seen:
                    continue
                ordered = ((anc[hi] >> lo) & 1) == 1
                if ordered:
                    continue
                seen.add((lo, hi))
                # report in index order so the class reads causally
                wlo, whi = (wi, wj) if i < j else (wj, wi)
                klass = _classify(fps[lo], fps[hi], wlo, whi)
                overlap = Resource(ri.space, ri.key,
                                   max(ri.lo, rj.lo), min(ri.hi, rj.hi))
                banks = bank_set(overlap)
                bank_note = f" (banks {list(banks)})" if banks else ""
                findings.append(Finding(
                    "error", klass,
                    f"{cmds[lo].name!r} and {cmds[hi].name!r} are "
                    f"unordered but conflict on "
                    f"{overlap.describe()}{bank_note}",
                    commands=(lo, hi),
                    names=(cmds[lo].name, cmds[hi].name),
                    resource=overlap.describe(),
                    witness=_witness(cmds, anc, lo, hi)))
    findings.sort(key=lambda f: f.commands)
    return findings


# --------------------------------------------------------------------------- #
# reference-DAG diff: non-footprint edges covered by determinism
# --------------------------------------------------------------------------- #
def reference_commands(cfg: ModelConfig, phase: str, n_tokens: int,
                       kv_len: int, policy: PASPolicy = PASPolicy.paper(),
                       hw: HardwareModel = IANUS_HW) -> List[Command]:
    """The DAG the lowering pipeline deterministically emits for this step
    shape — identical to ``trace.lower.trace_to_commands``'s per-event
    build, so a recorded step can be re-derived and diffed."""
    base = dataclasses.replace(policy, adaptive_fc=False)
    cmds = graphs.build_stage(cfg, n_tokens, kv_len, phase, base,
                              lm_head=(phase == "generation"), hw=hw)
    cmds, _ = lower_commands(cmds, n_tokens, hw, adaptive=policy.adaptive_fc)
    return cmds


def diff_commands(actual: Sequence[Command],
                  expected: Sequence[Command]) -> List[Finding]:
    """Diff a command stream against its reference: shape mismatches,
    missing dependency edges (error — an ordering constraint was dropped)
    and extra edges (warning — over-serialization, not a hazard)."""
    out: List[Finding] = []
    if len(actual) != len(expected):
        out.append(Finding(
            "error", "graph_shape",
            f"stream has {len(actual)} commands, reference has "
            f"{len(expected)}"))
    for i, (a, e) in enumerate(zip(actual, expected)):
        if (a.name, a.unit, a.kind) != (e.name, e.unit, e.kind):
            out.append(Finding(
                "error", "graph_shape",
                f"command {i} is ({a.name!r}, {a.unit}, {a.kind}), "
                f"reference has ({e.name!r}, {e.unit}, {e.kind})",
                commands=(i,), names=(a.name,)))
            continue
        missing = sorted(set(e.deps) - set(a.deps))
        extra = sorted(set(a.deps) - set(e.deps))
        if missing:
            out.append(Finding(
                "error", "missing_dep",
                f"command {i} ({a.name!r}) lost dependency edges on "
                + ", ".join(f"{d} ({expected[d].name!r})"
                            for d in missing),
                commands=(i,) + tuple(missing), names=(a.name,)))
        if extra:
            out.append(Finding(
                "warning", "extra_dep",
                f"command {i} ({a.name!r}) carries extra dependency "
                f"edges on {extra}", commands=(i,) + tuple(extra),
                names=(a.name,)))
    return out


def verify_lowered_step(ls, cfg: ModelConfig,
                        policy: PASPolicy = PASPolicy.paper(),
                        hw: HardwareModel = IANUS_HW) -> List[Finding]:
    """Diff one ``trace.lower.LoweredStep`` against its re-derived
    reference DAG (lowering is deterministic in the step shape)."""
    ref = reference_commands(cfg, ls.phase, ls.n_tokens, ls.kv_len,
                             policy, hw)
    return diff_commands(ls.commands, ref)


def analyze_lowered(lowered) -> List[Finding]:
    """Hazard-analyze every dispatch-span DAG of a lowered trace, merged
    exactly as ``trace.replay`` composes them: fused overlapped steps share
    one issue root, unfused overlapped steps chain their issue slots, and a
    superstep's inner rounds pipeline."""
    from repro_torch.trace.lower import group_dispatch_spans
    out: List[Finding] = []
    for gi, group in enumerate(group_dispatch_spans(lowered)):
        if len(group) == 1:
            cmds = group[0].commands
        elif group[0].overlap:
            fused = all(ls.fused for ls in group)
            cmds = merge_streams(
                [ls.commands for ls in group], mode="parallel",
                issue_mode="shared" if fused else "chained")
        else:
            cmds = merge_streams([ls.commands for ls in group],
                                 mode="pipelined")
        loc = f"span#{gi}@step{group[0].step}"
        for f in analyze_commands(cmds):
            out.append(dataclasses.replace(f, location=loc))
    return out


__all__ = ["Finding", "SEVERITIES", "analyze_commands", "analyze_lowered",
           "diff_commands", "reference_commands", "verify_lowered_step"]
