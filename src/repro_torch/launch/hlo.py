"""Collective bytes and cost scaling: the port's ``repro/launch/hlo.py``.

The reference parses its collectives from XLA's optimized per-device HLO
text. The port records them as they run (``sharding/comm.py`` into
``launch/cost.py``'s counter), each with the reference's opcode and its
per-device result bytes; ``collective_bytes`` applies the reference's
convention to those records.

A step is traced at n_super = 1 and 2 superblocks and extended, as the
reference extends XLA's counts (its cost analysis counts a loop body
once; the port's trace of a deep model costs time):

    total(L) = cost(1) + (n_super - 1) * (cost(2) - cost(1))
"""
from __future__ import annotations

from typing import Dict, Iterable

# per-device traffic factor on a ring (bytes each chip puts on links,
# relative to the op's per-device result shape)
_RING_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(records: Iterable[dict], chips: int) -> Dict[str, float]:
    """Sum per-op collective traffic over one rank's recorded collectives
    (``{"op", "result_bytes"}`` each).

    Convention: collective_bytes = sum over ops of
        per-device result bytes x ring factor x chips
    i.e. total bytes crossing links fleet-wide (the roofline denominator is
    chips x link_bw, so the ratio is per-chip link time)."""
    per_op: Dict[str, float] = {}
    total = 0.0
    for r in records:
        op = r["op"]
        b = r["result_bytes"] * _RING_FACTOR[op] * chips
        per_op[op] = per_op.get(op, 0.0) + b
        total += b
    per_op["total"] = total
    return per_op


def extrapolate(cost1: float, cost2: float, n_super: int) -> float:
    """total(L) from costs at n_super=1 and 2."""
    body = max(0.0, cost2 - cost1)
    return cost1 + (n_super - 1) * body
