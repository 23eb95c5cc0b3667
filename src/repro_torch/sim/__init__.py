"""The IANUS discrete-event simulator (the port's own copy of
``repro.sim``): the paper's IANUS, NPU-MEM, A100 and DFX machine models.
Its times are those models' outputs, never a measurement of the card the
port runs on."""
from repro_torch.sim.engine import (SimConfig, SimResult, Simulator,
                                    merge_results)
from repro_torch.sim import graphs, baselines, energy

__all__ = ["SimConfig", "SimResult", "Simulator", "merge_results",
           "graphs", "baselines", "energy"]
