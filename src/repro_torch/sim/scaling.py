"""Multi-device IANUS scaling (paper §7.1, Figs. 17 & 18).

D IANUS devices interconnected over PCIe 5.0 x16. Weights are partitioned
with intra-layer (column) + attention-head parallelism across devices, so
per-device PIM/MU work scales ~1/D, at the cost of activation
synchronization: the paper's four sync points per layer become PCIe
all-reduces of the (n x d_model) activation.

The port's own copy of ``repro/sim/scaling.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import HardwareModel, IANUS_HW
from repro_torch.core.pas import PASPolicy
from repro_torch.sim.engine import SimConfig, Simulator
from repro_torch.sim import graphs


@dataclass(frozen=True)
class Interconnect:
    bw: float = 50e9              # effective PCIe 5.0 x16 per direction
    latency: float = 2e-6         # per-stage latency (tree/recursive-doubling)
    syncs_per_layer: int = 4      # paper §5.1


def allreduce_time(n_bytes: int, n_dev: int, ic: Interconnect) -> float:
    if n_dev <= 1:
        return 0.0
    # recursive-doubling: 2*log2(D) latency stages; ring-equivalent bandwidth
    import math
    stages = 2 * math.ceil(math.log2(n_dev))
    bw_term = 2 * (n_dev - 1) / n_dev * n_bytes / ic.bw
    return stages * ic.latency + bw_term


def device_slice(hw: HardwareModel, n_dev: int) -> HardwareModel:
    """Per-device hardware is unchanged; the model is sliced 1/D onto each.
    We simulate a 1/D-width model on one device and add comm."""
    return hw


def _sliced_cfg(cfg: ModelConfig, n_dev: int) -> ModelConfig:
    """Column/head-parallel slice: d_ff, heads, vocab divide by D; d_model
    stays (activations replicated, synced at the four points)."""
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}/dev{n_dev}",
        num_heads=max(1, cfg.num_heads // n_dev),
        num_kv_heads=max(1, cfg.num_kv_heads // n_dev),
        d_ff=max(1, cfg.d_ff // n_dev),
        vocab_size=max(1024, cfg.vocab_size // n_dev),
    )


def multi_device_e2e(cfg: ModelConfig, n_in: int, n_out: int, n_dev: int,
                     policy: PASPolicy = PASPolicy(),
                     hw: HardwareModel = IANUS_HW,
                     ic: Interconnect = Interconnect(),
                     sim_cfg: SimConfig = None) -> dict:
    sim = Simulator(sim_cfg or SimConfig(hw=hw, issue_overhead=0.1e-6))
    sliced = _sliced_cfg(cfg, n_dev)
    base = graphs.e2e_latency(sim, sliced, n_in, n_out, policy)
    # communication: 4 all-reduces of (n, d) per layer
    sync_sum = (cfg.num_layers * ic.syncs_per_layer
                * allreduce_time(n_in * cfg.d_model * 2, n_dev, ic))
    sync_gen = (cfg.num_layers * ic.syncs_per_layer
                * allreduce_time(1 * cfg.d_model * 2, n_dev, ic)) * n_out
    return {
        "total": base["total"] + sync_sum + sync_gen,
        "summarization": base["summarization"] + sync_sum,
        "generation": base["generation"] + sync_gen,
        "comm": sync_sum + sync_gen,
        "compute": base["total"],
    }
