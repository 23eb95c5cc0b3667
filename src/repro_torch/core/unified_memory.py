"""Unified memory system: Fig. 4 tile allocation + Fig. 5 address mapping,
and the capacity/duplication accounting behind the paper's §3.2 argument
(the port's own copy of ``repro/core/unified_memory.py``).

The DRAM-level pieces (row/channel/bank/column interleave) describe the
paper's GDDR6-AiM devices, not the card the port runs on; they are the
paper's second contribution and drive the simulator's PIM timing, and the
verifier's bank footprints. The capacity helpers quantify what a
*partitioned* plan would cost against the unified one (Fig. 13 ablation).

The reference's ``assert_unified_layout`` checks one sharding per
parameter across a device mesh; the port has no mesh yet, so that check
waits for the sharded slice.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

from repro_torch.configs.base import ModelConfig


# --------------------------------------------------------------------------- #
# Fig. 5: (MSB) Row | Channel | Bank | Column (LSB) address mapping
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class AddressMap:
    """IANUS DRAM address mapping. Field widths are powers of two."""
    n_rows: int = 16384            # rows per bank (8 Gb GDDR6 class)
    n_channels: int = 8
    n_banks: int = 16
    row_bytes: int = 2048          # 2 KB page

    def __post_init__(self):
        for v in (self.n_rows, self.n_channels, self.n_banks, self.row_bytes):
            assert v & (v - 1) == 0, f"{v} not a power of two"

    @property
    def col_bits(self) -> int:
        return (self.row_bytes - 1).bit_length()

    @property
    def bank_bits(self) -> int:
        return (self.n_banks - 1).bit_length()

    @property
    def ch_bits(self) -> int:
        return (self.n_channels - 1).bit_length()

    @property
    def row_bits(self) -> int:
        return (self.n_rows - 1).bit_length()

    @property
    def capacity_bytes(self) -> int:
        return self.n_rows * self.n_channels * self.n_banks * self.row_bytes

    def encode(self, row: int, ch: int, bank: int, col: int) -> int:
        assert 0 <= row < self.n_rows and 0 <= ch < self.n_channels
        assert 0 <= bank < self.n_banks and 0 <= col < self.row_bytes
        addr = row
        addr = (addr << self.ch_bits) | ch
        addr = (addr << self.bank_bits) | bank
        addr = (addr << self.col_bits) | col
        return addr

    def decode(self, addr: int) -> Tuple[int, int, int, int]:
        col = addr & (self.row_bytes - 1)
        addr >>= self.col_bits
        bank = addr & (self.n_banks - 1)
        addr >>= self.bank_bits
        ch = addr & (self.n_channels - 1)
        addr >>= self.ch_bits
        row = addr
        assert row < self.n_rows, "address beyond device capacity"
        return row, ch, bank, col


# --------------------------------------------------------------------------- #
# Fig. 4: PIM-aware weight tiling
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class TileShape:
    """A tile = (banks x channels) weight rows x up-to-row_elems columns."""
    rows: int                      # = n_banks * n_channels
    cols: int                      # <= row_bytes / bytes_per_elem


class WeightTiler:
    """Row-major tiling of an FC weight matrix onto PIM tiles (Fig. 4):
    every weight row in a tile lands on the SAME DRAM row address across a
    distinct (channel, bank) — all-bank all-channel parallel MACs with zero
    row conflicts inside a tile."""

    def __init__(self, amap: AddressMap, bytes_per_elem: int = 2):
        self.amap = amap
        self.bytes_per_elem = bytes_per_elem
        self.tile = TileShape(
            rows=amap.n_banks * amap.n_channels,
            cols=amap.row_bytes // bytes_per_elem,
        )

    def tile_grid(self, w_rows: int, w_cols: int) -> Tuple[int, int]:
        return (math.ceil(w_rows / self.tile.rows),
                math.ceil(w_cols / self.tile.cols))

    def num_tiles(self, w_rows: int, w_cols: int) -> int:
        tr, tc = self.tile_grid(w_rows, w_cols)
        return tr * tc

    def element_address(self, w_rows: int, w_cols: int,
                        r: int, c: int) -> int:
        """DRAM address of weight element (r, c) under row-major tiling."""
        assert 0 <= r < w_rows and 0 <= c < w_cols
        tr, tc = self.tile_grid(w_rows, w_cols)
        tile_r, in_r = divmod(r, self.tile.rows)
        tile_c, in_c = divmod(c, self.tile.cols)
        tile_idx = tile_r * tc + tile_c      # row-major tile order
        # within a tile: weight row -> (channel, bank); column -> DRAM column
        ch, bank = divmod(in_r, self.amap.n_banks)
        return self.amap.encode(tile_idx, ch, bank,
                                in_c * self.bytes_per_elem)

    def rows_activated(self, w_rows: int, w_cols: int) -> int:
        """DRAM row activations for one full GEMV over this weight: one
        activation per (tile, bank, channel) row touched."""
        tr, tc = self.tile_grid(w_rows, w_cols)
        return tr * tc * self.tile.rows


# --------------------------------------------------------------------------- #
# §3.2: unified vs partitioned capacity accounting
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MemoryPlan:
    name: str
    capacity_bytes: int
    weight_bytes: int              # one copy of all parameters
    shared_bytes: int              # FC params used by both NPU and PIM
    duplicated_bytes: int          # extra copy required (partitioned only)
    transfer_bytes_per_step: int   # shared data moved when it can't duplicate

    @property
    def footprint(self) -> int:
        return self.weight_bytes + self.duplicated_bytes

    @property
    def fits(self) -> bool:
        return self.footprint <= self.capacity_bytes

    @property
    def pim_throughput_factor(self) -> float:
        """Unified memory exposes ALL memory devices to PIM compute; a
        half-split partition halves usable PIM throughput (paper Fig. 13:
        'doubled PIM throughput available in the unified configuration')."""
        return 1.0 if self.name == "unified" else 0.5


def shared_fraction(cfg: ModelConfig) -> float:
    """Fraction of parameters shared between the NPU and PIM = FC weights
    (attention projections + FFN); embeddings/norms are NPU-only.
    ~0.91 for GPT-2 XL-class models (paper §1)."""
    pc = cfg.param_counts()["total"]
    d, f = cfg.d_model, cfg.d_ff
    per_layer_fc = (cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                    + cfg.q_dim * cfg.d_model)
    ffn_fc = (3 if cfg.act == "silu" else 2) * d * f
    n_fc = sum(1 for k in cfg.layer_kinds() if k == "attn")
    fc_total = n_fc * per_layer_fc + cfg.num_layers * ffn_fc
    return min(1.0, fc_total / pc)


def unified_plan(cfg: ModelConfig, capacity_bytes: int,
                 bytes_per_elem: int = 2) -> MemoryPlan:
    w = cfg.param_counts()["total"] * bytes_per_elem
    return MemoryPlan("unified", capacity_bytes, w,
                      int(w * shared_fraction(cfg)), 0, 0)


def partitioned_plan(cfg: ModelConfig, capacity_bytes: int,
                     bytes_per_elem: int = 2) -> MemoryPlan:
    """Half the devices to the NPU, half to the PIM accelerator. Shared FC
    params are duplicated while capacity allows; any remainder must be
    transferred (or computed on the MU from the NPU half) every step —
    the GPT-2 2.5B case in Fig. 13."""
    w = cfg.param_counts()["total"] * bytes_per_elem
    shared = int(w * shared_fraction(cfg))
    half = capacity_bytes // 2
    # NPU half must hold all weights (it runs summarization end-to-end).
    dup_possible = max(0, half - (w - shared))   # PIM half free space
    duplicated = min(shared, dup_possible, half)
    transfer = shared - duplicated
    return MemoryPlan("partitioned", capacity_bytes, w, shared,
                      duplicated, transfer)


# --------------------------------------------------------------------------- #
# the unified property on a mesh
# --------------------------------------------------------------------------- #
def assert_unified_layout(param_defs, mesh, cfg=None) -> Dict[str, int]:
    """The distributed realization of unified memory: the sharding planned
    for the GEMM phase and for the GEMV phase must be the SAME for every
    parameter (no resharding between prefill and decode). Returns byte
    stats, each parameter counted at 2 bytes an element as the reference
    counts it. This holds by construction (one rule table).

    With ``cfg`` (the model of ``param_defs``) it also reports
    ``resident_param_bytes``, what one rank of the port holds
    (``models.params.local_defs`` under ``resident_axes(cfg)``), and on a
    mesh whose axes other than 'model' have extent 1 it asserts that a
    rank's resident spec of every leaf, in every family, is the rule
    table's: the port's resident layout is the unified layout itself."""
    import numpy as np
    from repro_torch.models.params import (is_def, local_defs, resident_axes,
                                           resident_specs, tree_leaves)
    from repro_torch.sharding.axes import axis_sizes, logical_sharding

    total = 0
    for leaf in tree_leaves(param_defs):
        if not is_def(leaf):
            continue
        s_prefill = logical_sharding(leaf.shape, leaf.logical_axes, mesh)
        s_decode = logical_sharding(leaf.shape, leaf.logical_axes, mesh)
        assert s_prefill == s_decode
        total += int(np.prod(leaf.shape)) * 2
    out = {"param_bytes": total, "resharded_bytes": 0}
    if cfg is None:
        return out
    resident = resident_axes(cfg)
    out["resident_param_bytes"] = sum(
        int(np.prod(leaf.shape)) * 2 for leaf in tree_leaves(
            local_defs(param_defs, mesh, resident)) if is_def(leaf))
    if all(n == 1 for a, n in axis_sizes(mesh).items() if a != "model"):
        for leaf, spec in zip(
                [x for x in tree_leaves(param_defs) if is_def(x)],
                tree_leaves(resident_specs(param_defs, mesh, resident))):
            rule = logical_sharding(leaf.shape, leaf.logical_axes, mesh).spec
            assert spec == rule, (leaf, spec, rule)
    return out
