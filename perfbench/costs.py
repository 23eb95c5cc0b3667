"""The yardstick's arithmetic: the work a step or a kernel call needs,
counted from shapes, and the published peaks it is held against.

A frozen copy of the formulas the metrics need, so that they read the same
work whatever implements it: the dot-class flops of a dense decoder's
token (its projections, MLP and head; attention's two products a query
head and attended key) and the GEMV's flops and bytes (as
``kernels/ops.py``'s ``_matvec_cost`` counts them). Attention counts the
keys a query attends, not the whole cache or score matrix as
``launch/cost.py`` counts them. Bytes are each input read once and each
output written once.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Optional

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def peaks(kind: Optional[str] = None) -> dict:
    """The published peaks of the card named ``kind`` (the H100 SXM's
    where the table has no entry of that name)."""
    table = json.loads(PEAKS_FILE.read_text())
    return table.get(kind or DEFAULT_CARD, table[DEFAULT_CARD])


# --------------------------------------------------------------------------- #
# a dense decoder's dot-class flops
# --------------------------------------------------------------------------- #
def layer_matmul_flops(cfg) -> int:
    """One token through one layer's projections and MLP: 2 x the
    multiply-adds of q, k, v, o and the MLP's two (gated: three)
    matrices."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    mlp = 3 if cfg.act == "silu" else 2
    return 2 * (d * q + 2 * d * kv + q * d + mlp * d * f)


def stack_token_flops(cfg) -> int:
    """One token through every layer, attention's products aside."""
    return cfg.num_layers * layer_matmul_flops(cfg)


def head_flops(cfg) -> int:
    """One row of logits: the LM head's product."""
    return 2 * cfg.d_model * cfg.vocab_size


def attention_flops(cfg, pairs: int) -> int:
    """QK^T and PV over ``pairs`` (query, key) pairs a head, every
    layer."""
    return cfg.num_layers * 4 * cfg.num_heads * cfg.head_dim * int(pairs)


def decode_round_flops(cfg, attended: Iterable[int]) -> int:
    """One decode round of rows that attend ``attended`` keys each: every
    row's stack, head and attention."""
    attended = list(attended)
    return (len(attended) * (stack_token_flops(cfg) + head_flops(cfg))
            + attention_flops(cfg, sum(attended)))


def prefill_flops(cfg, tokens: int, pairs: int) -> int:
    """A prefill of ``tokens`` rows (no logits) whose attention keeps
    ``pairs`` (query, key) pairs a head."""
    return int(tokens) * stack_token_flops(cfg) + attention_flops(cfg, pairs)


def prompt_pairs(n: int) -> int:
    """Causal pairs of an n-token prompt prefilled from position 0."""
    return n * (n + 1) // 2


# --------------------------------------------------------------------------- #
# kernel calls
# --------------------------------------------------------------------------- #
def matvec_cost(n: int, d_in: int, d_out: int, itemsize: int,
                bias: bool = False) -> dict:
    """act(x @ W + b) of n rows: x, W and b read once, y written once."""
    return {"flops": 2 * n * d_in * d_out,
            "bytes": itemsize * (n * d_in + d_in * d_out + n * d_out
                                 + (d_out if bias else 0))}


def bound_s(cost: dict, peak: dict) -> float:
    """The least time the card could take: the larger of the flops at
    the bf16 rate and the bytes at the HBM rate."""
    return max(cost["flops"] / peak["bf16_flops_s"],
               cost["bytes"] / peak["hbm_bytes_s"])
