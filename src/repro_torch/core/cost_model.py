"""Analytical engine cost models: the substrate of PIM Access Scheduling
(the port's own copy of ``repro/core/cost_model.py``).

The paper's Algorithm 1 relies on "a simple analytical model that estimates
the execution time across different execution units (MU, VU, DMA, PIM) based
on the number of input tokens at compile time" (§5.2). This module is that
model, with the reference's machines and constants unchanged, so that the
port's routing, scheduling and simulator give the reference's answers:

  * ``IANUS_HW``   — the paper's simulation parameters (Tables 1 & 2):
                     SAPEON NPU (4 cores) + 4x GDDR6-AiM chips.
  * ``NPU_MEM_HW`` — the same NPU on plain GDDR6 (the paper's ablation).
  * ``TPU_V5E``    — the reference's adaptation target: MXU = the MU; the
                     "PIM" engine is a bandwidth-saturating streaming GEMV.
                     The engine's routing record keeps it so that the
                     port's ``pas_log`` equals the reference engine's.

These are models of the paper's and the reference's machines, not of the
card the port runs on: no time computed here is a measurement of it.
All times are in seconds; sizes in elements unless suffixed _bytes.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


# --------------------------------------------------------------------------- #
# Hardware descriptions
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class HardwareModel:
    name: str
    # matrix engine (MU / MXU)
    mu_flops: float               # peak FLOP/s (all cores)
    mu_token_parallel: int        # tokens processed per pass (systolic rows)
    mu_cores: int
    # vector engine (VU / VPU)
    vu_elems_per_s: float         # elementwise element throughput
    # DMA / external memory
    ext_bw: float                 # bytes/s from main memory to compute
    # PIM engine (or its bandwidth-roofline analogue)
    pim_flops: float              # peak in-memory FLOP/s
    pim_internal_bw: float        # bytes/s streamed inside the memory
    pim_row_elems: int            # elements per DRAM row (GEMV granule)
    pim_chips: int
    # on-chip staging for the pipelined MU path
    weight_buf_bytes: int         # WM (weight scratch-pad) per core / VMEM slice
    bytes_per_elem: int = 2       # BF16
    ext_bw_eff: float = 1.0       # achieved DMA fraction (row misses, refresh)
    # unified-memory property: PIM compute and normal DMA share the device
    unified: bool = True
    # DRAM-level PIM timing (Table 1; 0 => pure-bandwidth model, used for TPU)
    pim_t_act: float = 0.0        # row activate (tRCDRD)
    pim_t_pre: float = 0.0        # precharge (tRP)
    pim_t_ccd: float = 0.0        # per-MAC column cycle (tCCD)
    pim_elems_per_mac: int = 16   # BF16 elements per MAC op (256-bit)
    pim_t_stagger: float = 0.0    # bank-activation stagger per tile (tRRD sum)
    pim_tile_rows: int = 128      # banks x channels rows per tile (Fig. 4)

    def scaled(self, *, cores: Optional[int] = None,
               pim_chips: Optional[int] = None) -> "HardwareModel":
        """Sensitivity-study scaling (paper Fig. 15): cores / PIM chips vary,
        external memory bandwidth held constant."""
        c = cores if cores is not None else self.mu_cores
        p = pim_chips if pim_chips is not None else self.pim_chips
        return dataclasses.replace(
            self, name=f"{self.name}-c{c}p{p}",
            mu_flops=self.mu_flops * c / self.mu_cores,
            vu_elems_per_s=self.vu_elems_per_s * c / self.mu_cores,
            mu_cores=c,
            pim_flops=self.pim_flops * p / self.pim_chips,
            pim_internal_bw=self.pim_internal_bw * p / self.pim_chips,
            # fewer chips = fewer channels in a tile -> more tile batches
            pim_tile_rows=max(16, self.pim_tile_rows * p // self.pim_chips),
            pim_chips=p,
        )


# Table 1 / Table 2: 4-core NPU @700 MHz, 128x64 PEs x 4 MACs -> 45.9 TFLOPS/core
IANUS_HW = HardwareModel(
    name="ianus",
    mu_flops=184e12,               # 4 cores x 46 TFLOPS
    mu_token_parallel=128,
    mu_cores=4,
    # 16 VLIW procs x 4 lanes x 700 MHz per core x 4 cores
    vu_elems_per_s=16 * 4 * 0.7e9 * 4,
    ext_bw=256e9,                  # GDDR6 8ch x 16 Gb/s x16
    ext_bw_eff=0.72,               # calibrated: NPU-MEM XL step = 15.5 ms
    pim_flops=4e12,                # 4 chips x 1 TFLOPS
    pim_internal_bw=4096e9,        # 4 chips x 1 TB/s
    pim_row_elems=1024,            # 2 KB row of BF16
    pim_chips=4,
    weight_buf_bytes=4 * 2**20,    # WM: 4 MB per core
    unified=True,
    # Table 1 GDDR6-AiM timing: tRCDRD=36ns, tRP=30ns, tCCD=1ns
    pim_t_act=36e-9,
    pim_t_pre=30e-9,
    pim_t_ccd=1e-9,
    pim_elems_per_mac=16,
    # staggered per-channel ACTs + global-buffer input staging per tile
    # (calibrated: IANUS XL generation step = 3.8 ms)
    pim_t_stagger=100e-9,
    pim_tile_rows=128,             # 16 banks x 8 channels (Fig. 4)
)

# NPU-MEM: same NPU with standard GDDR6 (no PIM) — paper's ablation baseline.
NPU_MEM_HW = dataclasses.replace(
    IANUS_HW, name="npu-mem", pim_flops=0.0, pim_internal_bw=0.0)

# TPU v5e (per chip): the adaptation target. The "PIM" engine maps to a
# weight-streaming GEMV at full HBM bandwidth; MU token-parallelism = MXU rows.
TPU_V5E = HardwareModel(
    name="tpu-v5e",
    mu_flops=197e12,
    mu_token_parallel=128,         # MXU 128x128
    mu_cores=1,
    vu_elems_per_s=197e12 / 128,   # VPU ~ 8x128 lanes @ ~0.94 GHz
    ext_bw=819e9,
    pim_flops=197e12,              # streaming GEMV still runs on the MXU/VPU
    pim_internal_bw=819e9,         # ... at HBM bandwidth (the roofline lever)
    pim_row_elems=128,             # lane granule (HBM has no DRAM-row granule;
                                   # the Pallas kernel tiles at 128)
    pim_chips=1,
    weight_buf_bytes=64 * 2**20,   # usable VMEM slice for weight tiles
    unified=True,
)

# v5e ICI: ~50 GB/s per link (roofline collective term).
TPU_ICI_BW = 50e9
TPU_HBM_GB = 16


# --------------------------------------------------------------------------- #
# FC descriptor
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class FCConfig:
    d_in: int
    d_out: int

    @property
    def weight_elems(self) -> int:
        return self.d_in * self.d_out


# --------------------------------------------------------------------------- #
# Engine time models (Algorithm 1 lines 5-13)
# --------------------------------------------------------------------------- #
def dma_weight_time(hw: HardwareModel, w: FCConfig) -> float:
    """Load FC weights from main memory (normal access path)."""
    return w.weight_elems * hw.bytes_per_elem / (hw.ext_bw * hw.ext_bw_eff)


def mu_fc_time(hw: HardwareModel, n_tokens: int, w: FCConfig) -> float:
    """FC on the matrix unit: the systolic array processes
    ``mu_token_parallel`` tokens per pass, so small n quantizes up — this is
    the Fig. 12 plateau (4/8/16 tokens take equal MU time)."""
    passes = math.ceil(max(1, n_tokens) / hw.mu_token_parallel)
    eff_tokens = passes * hw.mu_token_parallel
    flops = 2.0 * eff_tokens * w.weight_elems
    return flops / hw.mu_flops


def pipelined_mu_time(hw: HardwareModel, n_tokens: int, w: FCConfig) -> float:
    """pipe((w_load, mu_fc), T): weight tiles stream through the WM while the
    MU computes — total = max(load, compute) + first-tile fill."""
    load = dma_weight_time(hw, w)
    comp = mu_fc_time(hw, n_tokens, w)
    tile_bytes = hw.weight_buf_bytes
    n_tiles = max(1, math.ceil(w.weight_elems * hw.bytes_per_elem / tile_bytes))
    fill = min(load, comp) / n_tiles
    return max(load, comp) + fill


def pim_row_efficiency(hw: HardwareModel, d_in: int) -> float:
    """GEMV input segments occupy whole DRAM rows: d_in=1280 on a 1024-elem
    row wastes 2 activations (paper §6.2 energy discussion; Fig. 12
    crossovers). 1.0 when d_in is a multiple of the row size."""
    rows = math.ceil(d_in / hw.pim_row_elems)
    return d_in / (rows * hw.pim_row_elems)


def pim_gemv_time(hw: HardwareModel, w: FCConfig) -> float:
    """One GEMV y = W x in PIM.

    DRAM-timing model (IANUS): the weight is tiled per Fig. 4 into
    (pim_tile_rows x pim_row_elems) tiles; each tile costs one staggered
    all-bank ACT, row_elems/elems_per_mac MAC column cycles, and a PRE —
    executed tile after tile (macro PIM command). Pure-bandwidth model (TPU
    adaptation): weight bytes / internal bandwidth, derated by row fill.
    """
    if hw.pim_internal_bw <= 0:
        return float("inf")
    if hw.pim_t_act > 0:
        tiles = (math.ceil(w.d_out / hw.pim_tile_rows)
                 * math.ceil(w.d_in / hw.pim_row_elems))
        per_tile = (hw.pim_t_act + hw.pim_t_stagger
                    + (hw.pim_row_elems // hw.pim_elems_per_mac) * hw.pim_t_ccd
                    + hw.pim_t_pre)
        return tiles * per_tile
    eff = pim_row_efficiency(hw, w.d_in)
    stream = w.weight_elems * hw.bytes_per_elem / (hw.pim_internal_bw * eff)
    compute = 2.0 * w.weight_elems / hw.pim_flops if hw.pim_flops else 0.0
    return max(stream, compute)


def pim_fc_time(hw: HardwareModel, n_tokens: int, w: FCConfig) -> float:
    """FC as n sequential GEMVs in PIM: ``pim_time <- n x PIM(w_cfg)``
    (Algorithm 1 line 12; "PIM sequentially repeats matrix-vector
    multiplication as much as the input token size", §6.2)."""
    return max(1, n_tokens) * pim_gemv_time(hw, w)


def vu_time(hw: HardwareModel, n_tokens: int, dim: int, passes: float = 1.0) -> float:
    """Vector-unit elementwise time (layernorm ~ 2 passes: stats + normalize —
    the paper's two-phase VU LayerNorm, §4.2.2)."""
    return passes * max(1, n_tokens) * dim / hw.vu_elems_per_s


def attention_gemv_efficiency(hw: HardwareModel, head_dim: int) -> float:
    """PIM efficiency for QK^T/SV: only head_dim elements of a DRAM row are
    used (6.25% for head_dim=64 — paper §5.3)."""
    return head_dim / hw.pim_row_elems


# --------------------------------------------------------------------------- #
# roofline terms (TPU, per-chip)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(flops: float, hbm_bytes: float, collective_bytes: float,
             chips: int, hw: HardwareModel = TPU_V5E,
             ici_bw: float = TPU_ICI_BW) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops / (chips * hw.mu_flops),
        memory_s=hbm_bytes / (chips * hw.ext_bw),
        collective_s=collective_bytes / (chips * ici_bw),
    )
