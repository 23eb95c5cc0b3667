"""Static read/write footprints for PAS commands.

Every ``core.pas.Command`` is mapped to the sets of memory resources it
reads and writes, derived ONLY from the command's kind/unit/shape metadata
and the naming conventions of ``sim.graphs`` / ``core.pas.merge_streams`` —
never from the dependency edges themselves. That inversion is the point:
the hazard pass (``verify.hazards``) checks whether the dep edges order
every conflicting footprint pair, so a *missing* edge shows up as two
unordered conflicting accesses instead of silently vanishing with the edge.

Resource model
--------------
  wbuf:<name>#<k>      on-chip weight buffer one ``<fc>.w<core>`` DMA fills
                       and the matching MU FC ``<fc>.<core>`` reads
  kvbuf:#<k>           on-chip K/V staging the generation ``kv_prefetch``
                       fills and the Fig. 7c MU QK^T/SV read
  ktr:#<k>             transposed-K buffer (``k_transpose`` -> MU ``qk.c*``)
  vmove:#<k>.c<c>      per-core V staging (``v_move.c*`` -> MU ``sv.c*``)
  kv:#<k>[lo:hi)       the layer's K/V cache region in unified memory, as a
                       byte interval: ``kv_prefetch`` reads [0, prefetch),
                       ``kv_store`` writes [prefetch, prefetch+store), the
                       Fig. 7b PIM QK^T/SV read the whole span
  pim_w:<name>#<k>     PIM-resident weight tiles a retargeted FC computes on

``<k>`` disambiguates instances: the k-th occurrence of a leaf name within
its stream is layer k (command names repeat per decoder layer). Merged
streams (``s<i>.<name>``) are namespaced per stream — cross-stream kv
aliasing is a slot-level concern the trace-level protocol lint owns, while
pipelined cross-step ordering is enforced by the merge chaining itself.

Beyond named resources, two occupancy bits feed the IANUS-specific check:
``normal_access`` (the command occupies the shared memory device with a
normal NPU access — DMA loads/stores with real bytes) and ``pim_compute``
(the command computes in the memory device's banks). The hazard pass flags
a PIM compute unordered with a normal access only when their *data*
footprints also collide — mere device co-occupancy is the simulator's
shared-"mem"-resource serialization, not a correctness bug.

The port's own copy of ``repro/verify/footprints.py``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.pas import Command, DMA, MU, PIM
from repro_torch.core.unified_memory import AddressMap

_STREAM_RE = re.compile(r"^(s\d+)\.(.*)$")
_WLOAD_RE = re.compile(r"^(.+)\.w(\d+)$")        # <fc>.w<core> weight DMA
_FC_CORE_RE = re.compile(r"^(.+)\.(\d+)$")       # <fc>.<core> FC compute
_QK_MU_RE = re.compile(r"^qk\.c(\d+)$")          # Fig. 7a/7c MU QK^T
_SV_MU_RE = re.compile(r"^sv\.c(\d+)$")          # Fig. 7a/7c MU SV
_QK_SV_PIM_RE = re.compile(r"^(qk|sv)\.(\d+)$")  # Fig. 7b per-head PIM
_VMOVE_RE = re.compile(r"^v_move\.c(\d+)$")


@dataclass(frozen=True)
class Resource:
    """A named resource instance, optionally with a byte interval (the kv
    cache region); non-interval resources use the unit interval."""
    space: str
    key: str
    lo: int = 0
    hi: int = 1

    def overlaps(self, other: "Resource") -> bool:
        return (self.space == other.space and self.key == other.key
                and self.lo < other.hi and other.lo < self.hi)

    def describe(self) -> str:
        if (self.lo, self.hi) == (0, 1):
            return f"{self.space}:{self.key}"
        return f"{self.space}:{self.key}[{self.lo}:{self.hi})"


@dataclass(frozen=True)
class Footprint:
    reads: Tuple[Resource, ...] = ()
    writes: Tuple[Resource, ...] = ()
    normal_access: bool = False     # occupies memory with a normal access
    pim_compute: bool = False       # computes inside the memory device


def _split(name: str) -> Tuple[str, str]:
    """('s<i>', leaf) for merged streams; ('', name) for a single stream."""
    m = _STREAM_RE.match(name)
    return (m.group(1), m.group(2)) if m else ("", name)


def command_footprints(cmds: Sequence[Command]) -> List[Footprint]:
    """Footprint per command, index-aligned with ``cmds``."""
    # pass A: per-(stream, leaf) occurrence ordinals (= decoder layer) and
    # the per-layer kv-region extents (prefetch / store byte counts)
    occ_count: Dict[Tuple[str, str], int] = {}
    occs: List[Tuple[str, str, int]] = []
    pf_bytes: Dict[Tuple[str, int], int] = {}
    st_bytes: Dict[Tuple[str, int], int] = {}
    vmove_at: Dict[Tuple[str, int, int], bool] = {}
    for c in cmds:
        stream, leaf = _split(c.name)
        k = occ_count.get((stream, leaf), 0)
        occ_count[(stream, leaf)] = k + 1
        occs.append((stream, leaf, k))
        if leaf == "kv_prefetch":
            pf_bytes[(stream, k)] = c.bytes
        elif leaf == "kv_store":
            st_bytes[(stream, k)] = c.bytes
        else:
            m = _VMOVE_RE.match(leaf)
            if m:
                vmove_at[(stream, k, int(m.group(1)))] = True

    # pass B: footprints
    out: List[Footprint] = []
    for c, (stream, leaf, k) in zip(cmds, occs):
        reads: List[Resource] = []
        writes: List[Resource] = []
        normal = False
        pim = False
        if c.kind == "dma_load":
            normal = c.bytes > 0
            if leaf == "kv_prefetch":
                reads.append(Resource("kv", f"{stream}#{k}",
                                      0, max(c.bytes, 1)))
                writes.append(Resource("kvbuf", f"{stream}#{k}"))
            else:
                m = _WLOAD_RE.match(leaf)
                if m:
                    writes.append(Resource("wbuf", f"{stream}:{leaf}#{k}"))
                # embed / other loads: normal access only
        elif c.kind == "dma_store":
            normal = c.bytes > 0
            if leaf == "kv_store":
                base = pf_bytes.get((stream, k), 0)
                writes.append(Resource("kv", f"{stream}#{k}",
                                       base, base + max(c.bytes, 1)))
        elif c.kind == "dma_onchip":
            if leaf == "k_transpose":
                writes.append(Resource("ktr", f"{stream}#{k}"))
            else:
                m = _VMOVE_RE.match(leaf)
                if m:
                    writes.append(Resource(
                        "vmove", f"{stream}#{k}.c{m.group(1)}"))
                # step_issue roots: no footprint
        elif c.kind in ("fc", "gemv") and c.unit == MU:
            m = _QK_MU_RE.match(leaf)
            if m:
                reads.append(Resource("ktr", f"{stream}#{k}"))
                if (stream, k) in pf_bytes:      # generation Fig. 7c
                    reads.append(Resource("kvbuf", f"{stream}#{k}"))
            elif _SV_MU_RE.match(leaf):
                core = int(_SV_MU_RE.match(leaf).group(1))
                if (stream, k) in pf_bytes:      # generation Fig. 7c
                    reads.append(Resource("kvbuf", f"{stream}#{k}"))
                elif (stream, k, core) in vmove_at:  # summarization Fig. 7a
                    reads.append(Resource("vmove", f"{stream}#{k}.c{core}"))
            elif c.weights_resident:
                m = _FC_CORE_RE.match(leaf)
                if m:
                    wleaf = f"{m.group(1)}.w{m.group(2)}"
                    reads.append(Resource("wbuf", f"{stream}:{wleaf}#{k}"))
        elif c.kind in ("fc", "gemv") and c.unit == PIM:
            pim = True
            m = _QK_SV_PIM_RE.match(leaf)
            if m:                                # generation Fig. 7b
                span = pf_bytes.get((stream, k), 0) \
                    + st_bytes.get((stream, k), 0)
                reads.append(Resource("kv", f"{stream}#{k}",
                                      0, max(span, 1)))
            elif c.weights_resident:
                reads.append(Resource("pim_w", f"{stream}:{leaf}#{k}"))
        # VU vec ops / noop_load / PIM-fused activations: pure compute or
        # voided traffic — activation flow is carried by the dep edges the
        # reference-DAG diff checks, not by memory resources
        out.append(Footprint(reads=tuple(reads), writes=tuple(writes),
                             normal_access=normal, pim_compute=pim))
    return out


def bank_set(res: Resource, amap: AddressMap = AddressMap(),
             cap: int = 16) -> Tuple[Tuple[int, int], ...]:
    """(channel, bank) pairs a kv byte interval touches under the Fig. 5
    Row|Channel|Bank|Column interleave, assuming the region is page-aligned
    at a row boundary — the annotation findings attach so a PIM/normal
    collision names the banks it contends on. Capped at ``cap`` pairs."""
    if res.space != "kv" or res.hi <= res.lo:
        return ()
    first = res.lo >> amap.col_bits
    last = (res.hi - 1) >> amap.col_bits
    pairs = []
    for page in range(first, min(last + 1, first + cap)):
        bank = page & (amap.n_banks - 1)
        ch = (page >> amap.bank_bits) & (amap.n_channels - 1)
        if (ch, bank) not in pairs:
            pairs.append((ch, bank))
    return tuple(pairs)


__all__ = ["Resource", "Footprint", "command_footprints", "bank_set"]
