"""Dynamic-energy model (paper §6.1/§6.2 Fig. 11): the port's own copy of
``repro/sim/energy.py``, which ``chaos.faults.FaultPlan.from_cost_model``
reads.

"Based on prior analysis [26], we assume that the power consumption of PIM
computing operations is 3x of that for DRAM read operations." Energy is
reported as *relative dynamic energy* (the paper normalizes to IANUS/GPT-2 M),
so only the ratios between the coefficients matter.
"""
from __future__ import annotations

from dataclasses import dataclass

# pJ-scale coefficients (relative units, normalized to one DRAM array read)
# A NORMAL access pays array read + GDDR6 I/O/PHY + SoC transport (I/O
# dominates external DRAM energy); a PIM MAC touches the array only —
# "PIM computing operations [are] 3x of that for DRAM read operations"
# refers to the in-array op vs the array read (paper §6.1 / [26]).
E_DRAM_ARRAY = 1.0
E_DRAM_IO = 13.0               # interface + transport per byte (I/O+PHY+SoC
                               # is ~90% of external GDDR6 access energy)
E_DRAM_PER_BYTE = E_DRAM_ARRAY + E_DRAM_IO
E_PIM_PER_BYTE = 3.0 * E_DRAM_ARRAY
E_MU_PER_FLOP = 0.010          # NPU core MAC energy
E_VU_PER_ELEM = 0.05           # vector-lane op


@dataclass(frozen=True)
class EnergyBreakdown:
    core_compute: float
    normal_memory: float
    pim_ops: float

    @property
    def total(self) -> float:
        return self.core_compute + self.normal_memory + self.pim_ops


def energy_of(sim_energy: dict) -> EnergyBreakdown:
    """sim_energy: the counters accumulated by the simulator."""
    return EnergyBreakdown(
        core_compute=(sim_energy["mu_flops"] * E_MU_PER_FLOP
                      + sim_energy["vu_elems"] * E_VU_PER_ELEM),
        normal_memory=sim_energy["dram_bytes"] * E_DRAM_PER_BYTE,
        pim_ops=sim_energy["pim_bytes"] * E_PIM_PER_BYTE,
    )
