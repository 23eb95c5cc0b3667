"""The engine's PAS routing record (the port's own copy of the part of
``repro/core/pas.py`` the serving engine uses).

Each serving dispatch logs its phase and the FC route that Algorithm 1's
decision procedure picks for it: ``gemm`` (matrix-engine path) or ``gemv``
(the streaming matvec path, the PIM analogue). Generation steps land on
the GEMV side of the crossover; the port's decode step runs its FCs
through the ``pim_matvec`` kernel accordingly.
"""
from __future__ import annotations

from repro_torch.core.cost_model import (FCConfig, HardwareModel, TPU_V5E,
                                         pim_fc_time, pipelined_mu_time)


def route_fc_tpu(n_tokens: int, d_in: int, d_out: int,
                 hw: HardwareModel = TPU_V5E) -> str:
    """'gemm' vs 'gemv' for an FC of n_tokens rows."""
    fc = FCConfig(d_in, d_out)
    gemm_t = pipelined_mu_time(hw, n_tokens, fc)
    gemv_t = pim_fc_time(hw, n_tokens, fc)
    return "gemv" if gemv_t < gemm_t else "gemm"


def decode_uses_gemv(batch_per_device: int,
                     hw: HardwareModel = TPU_V5E) -> bool:
    """Below the matrix engine's token parallelism the GEMV path wins."""
    return batch_per_device < hw.mu_token_parallel


def phase_log_entry(phase: str, n_tokens: int, active: int,
                    d_model: int, d_ff: int,
                    hw: HardwareModel = TPU_V5E) -> dict:
    """One serving-step record: ``phase`` is "summarization" (n_tokens =
    prompt tokens in the dispatch) or "generation" (n_tokens = active
    slots)."""
    n = max(n_tokens, 1)
    return {"phase": phase, "tokens": n_tokens, "active": active,
            "gemv_path": decode_uses_gemv(n, hw),
            "ffn_route": route_fc_tpu(n, d_model, d_ff, hw)}
