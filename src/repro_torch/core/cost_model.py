"""The analytical FC timing model behind PAS routing decisions.

The port's own copy of the part of ``repro/core/cost_model.py`` that
``pas.route_fc_tpu`` reads: ``HardwareModel``, ``FCConfig``, the two
machines (``IANUS_HW``, the paper's; ``TPU_V5E``, the reference's
adaptation target) with the fields those functions read, and the GEMM /
GEMV time functions. The engine's
routing record keeps the TPU constants on purpose, so that the port's
``pas_log`` equals the reference engine's entry for entry; the
``pim_aware`` scheduler routes on ``IANUS_HW``, as the reference's does.
The model describes the paper's mapping decision, not this card's speed.
All times are in seconds, sizes in elements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareModel:
    name: str
    # matrix engine (MU / MXU)
    mu_flops: float               # peak FLOP/s (all cores)
    mu_token_parallel: int        # tokens per matrix-engine pass
    # DMA / external memory
    ext_bw: float                 # bytes/s from main memory
    # PIM engine (or its weight-streaming GEMV analogue)
    pim_flops: float              # peak in-memory FLOP/s
    pim_internal_bw: float        # bytes/s streamed inside the memory
    pim_row_elems: int            # elements per DRAM row (GEMV granule)
    weight_buf_bytes: int         # on-chip weight staging
    bytes_per_elem: int = 2       # BF16
    ext_bw_eff: float = 1.0       # achieved DMA fraction
    # DRAM-level PIM timing (0 => the pure-bandwidth model, the TPU's)
    pim_t_act: float = 0.0        # row activate (tRCDRD)
    pim_t_pre: float = 0.0        # precharge (tRP)
    pim_t_ccd: float = 0.0        # per-MAC column cycle (tCCD)
    pim_elems_per_mac: int = 16   # BF16 elements per MAC op (256-bit)
    pim_t_stagger: float = 0.0    # bank-activation stagger per tile
    pim_tile_rows: int = 128      # banks x channels rows per tile


# The paper's machine (Tables 1 and 2): a 4-core NPU at 700 MHz beside 4
# GDDR6-AiM chips, calibrated as the reference calibrates it.
IANUS_HW = HardwareModel(
    name="ianus",
    mu_flops=184e12,
    mu_token_parallel=128,
    ext_bw=256e9,
    ext_bw_eff=0.72,
    pim_flops=4e12,
    pim_internal_bw=4096e9,
    pim_row_elems=1024,
    weight_buf_bytes=4 * 2**20,
    pim_t_act=36e-9,
    pim_t_pre=30e-9,
    pim_t_ccd=1e-9,
    pim_elems_per_mac=16,
    pim_t_stagger=100e-9,
    pim_tile_rows=128,
)

# TPU v5e (per chip): the reference's routing target (MXU = the matrix
# engine; the "PIM" engine is a weight-streaming GEMV at HBM bandwidth).
TPU_V5E = HardwareModel(
    name="tpu-v5e",
    mu_flops=197e12,
    mu_token_parallel=128,
    ext_bw=819e9,
    pim_flops=197e12,
    pim_internal_bw=819e9,
    pim_row_elems=128,
    weight_buf_bytes=64 * 2**20,
)


@dataclass(frozen=True)
class FCConfig:
    d_in: int
    d_out: int

    @property
    def weight_elems(self) -> int:
        return self.d_in * self.d_out


def dma_weight_time(hw: HardwareModel, w: FCConfig) -> float:
    return w.weight_elems * hw.bytes_per_elem / (hw.ext_bw * hw.ext_bw_eff)


def mu_fc_time(hw: HardwareModel, n_tokens: int, w: FCConfig) -> float:
    """Small n quantizes up to the matrix engine's token parallelism."""
    passes = math.ceil(max(1, n_tokens) / hw.mu_token_parallel)
    return 2.0 * passes * hw.mu_token_parallel * w.weight_elems / hw.mu_flops


def pipelined_mu_time(hw: HardwareModel, n_tokens: int, w: FCConfig) -> float:
    """Weight tiles stream while the matrix engine computes:
    max(load, compute) + first-tile fill."""
    load = dma_weight_time(hw, w)
    comp = mu_fc_time(hw, n_tokens, w)
    n_tiles = max(1, math.ceil(w.weight_elems * hw.bytes_per_elem
                               / hw.weight_buf_bytes))
    return max(load, comp) + min(load, comp) / n_tiles


def pim_row_efficiency(hw: HardwareModel, d_in: int) -> float:
    rows = math.ceil(d_in / hw.pim_row_elems)
    return d_in / (rows * hw.pim_row_elems)


def pim_gemv_time(hw: HardwareModel, w: FCConfig) -> float:
    """One GEMV. DRAM-timing model (``IANUS_HW``): the weight is tiled into
    (pim_tile_rows x pim_row_elems) tiles, each costing one staggered
    all-bank activate, row_elems / elems_per_mac MAC column cycles and a
    precharge, tile after tile. Pure-bandwidth model (``TPU_V5E``): weight
    bytes over the streaming bandwidth, derated by row fill."""
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
    """FC as n sequential GEMVs (Algorithm 1 line 12)."""
    return max(1, n_tokens) * pim_gemv_time(hw, w)
