"""The analytical FC timing model behind the engine's PAS routing record.

The port's own copy of the part of ``repro/core/cost_model.py`` that
``pas.route_fc_tpu`` reads: ``HardwareModel``, ``FCConfig``, the
``TPU_V5E`` instance and the GEMM / streaming-GEMV time functions. The
routing record keeps the TPU constants on purpose, so that the port's
``pas_log`` equals the reference engine's entry for entry; the model
describes the paper's mapping decision, not this card's speed. All times
are in seconds, sizes in elements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareModel:
    name: str
    mu_flops: float               # matrix-engine peak FLOP/s
    mu_token_parallel: int        # tokens per matrix-engine pass
    ext_bw: float                 # bytes/s from main memory
    pim_flops: float              # streaming-GEMV peak FLOP/s
    pim_internal_bw: float        # bytes/s the GEMV streams at
    pim_row_elems: int            # GEMV granule (elements)
    weight_buf_bytes: int         # on-chip weight staging
    bytes_per_elem: int = 2       # BF16
    ext_bw_eff: float = 1.0


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
    """One GEMV: weight bytes over the streaming bandwidth, derated by row
    fill (the reference's pure-bandwidth model, which its TPU instance
    uses)."""
    if hw.pim_internal_bw <= 0:
        return float("inf")
    eff = pim_row_efficiency(hw, w.d_in)
    stream = w.weight_elems * hw.bytes_per_elem / (hw.pim_internal_bw * eff)
    compute = 2.0 * w.weight_elems / hw.pim_flops if hw.pim_flops else 0.0
    return max(stream, compute)


def pim_fc_time(hw: HardwareModel, n_tokens: int, w: FCConfig) -> float:
    """FC as n sequential GEMVs (Algorithm 1 line 12)."""
    return max(1, n_tokens) * pim_gemv_time(hw, w)
