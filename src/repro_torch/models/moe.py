"""Mixture-of-Experts FFN of the port: top-k routing and sort-based
capacity dispatch.

Counterpart of ``repro/models/moe.py`` on one device: the ``gspmd`` path
with no mesh, so one routing group holds every token (``_num_groups``
gives 1). Within it each expert takes at most ``C`` tokens (``capacity``);
a token past its expert's capacity, in the stable order of token index,
is dropped from that expert, as in the reference. The expert products
(``gecd,edf`` there) are plain batched matmuls, as the reference leaves
them to XLA outside any Pallas kernel. ``apply_moe_ep`` (the expert-
parallel ``shard_map`` path) waits for sharding.

Nothing here reads a device value on the host: ``counts`` comes from
``scatter_add_``, the (E, C + 1) table from an index ``scatter_`` and the
combine from a gather of each token's k slots, so the decode step keeps
its one host sync. The combine sums a token's k expert outputs in the
order of its top-k, where the reference scatter-adds them (``.at[].add``):
a CUDA scatter-add sums them by atomics in an order that varies from run
to run, and with k 8 bf16 sums in another order round differently, so a
serve would not repeat its own tokens. ``lax.top_k`` and
``jnp.argsort(stable=True)`` break ties by the lower index, and so do the
stable sorts here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation, mm
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ModelConfig, stacked: Optional[int] = None) -> dict:
    """The reference's MoE parameters. As there, no dtype is passed, so
    every leaf takes ``ParamDef``'s default, bfloat16."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)
    ff = "fsdp" if cfg.fsdp_params else "d_ff"
    return {
        "router": ParamDef(lead + (d, e), la + ("d_model", None), "small_normal"),
        "wi": ParamDef(lead + (e, d, f), la + ("experts", "d_model", ff)),
        "wg": ParamDef(lead + (e, d, f), la + ("experts", "d_model", ff)),
        "wo": ParamDef(lead + (e, f, d), la + ("experts", ff, "d_model")),
    }


def capacity(tokens_per_group: int, k: int, num_experts: int,
             cf: float) -> int:
    c = int(-(-(tokens_per_group * k * cf) // num_experts))  # ceil
    return max(1, min(c, tokens_per_group * k))


def route(router_logits: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """top-k routing. router_logits: (..., E) -> (weights (..., k) f32,
    idx (..., k)); ties go to the lower expert index."""
    vals, idx = torch.sort(router_logits, dim=-1, descending=True,
                           stable=True)
    weights = torch.softmax(vals[..., :k].float(), dim=-1)
    return weights, idx[..., :k]


def load_balance_loss(router_probs: torch.Tensor, expert_idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * <fraction routed> . <mean prob>."""
    lead = tuple(range(router_probs.ndim - 1))
    probs_mean = router_probs.mean(dim=lead)
    experts = torch.arange(num_experts, device=expert_idx.device)
    one_hot = (expert_idx[..., 0, None] == experts).float()
    frac = one_hot.mean(dim=lead)
    return num_experts * (frac * probs_mean).sum()


def _dispatch_tables(expert_idx: torch.Tensor, k: int, E: int, C: int):
    """(E, C) gather tables from per-token top-k expert assignments.

    expert_idx: (T, k) integer. Returns:
      token_for_slot (E, C): the token feeding each expert slot (sentinel T
                             for empty slots),
      slot_weight_sel (E, C): index into the flattened (T * k,) weights
                              (T * k for empty slots),
      valid (E, C) bool."""
    T = expert_idx.shape[0]
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1).long()                  # (T*k,)
    sorted_e, order = torch.sort(flat_e, stable=True)     # grouped by expert
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts               # exclusive
    pos_in_e = torch.arange(T * k, device=dev) - starts[sorted_e]
    # entries past an expert's capacity land in column C, which is cut off
    slot = torch.where(pos_in_e < C, pos_in_e, torch.full_like(pos_in_e, C))
    table = torch.full((E * (C + 1),), T * k, dtype=torch.long, device=dev)
    table.scatter_(0, sorted_e * (C + 1) + slot, order)
    table = table.reshape(E, C + 1)[:, :C]
    valid = table < T * k
    token_for_slot = torch.where(valid, table // k,
                                 torch.full_like(table, T))
    return token_for_slot, table, valid


def apply_moe_ep(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh):
    raise NotImplementedError(
        "not ported yet: the expert-parallel MoE (shard_map) waits for "
        "sharding, ROADMAP queue 1 item 7")


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss f32 scalar). One routing
    group of all B * S tokens; ``mesh`` is for the expert-parallel path,
    which is not ported."""
    if mesh is not None:
        return apply_moe_ep(cfg, p, x, mesh)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    Tg = B * S
    C = capacity(Tg, k, E, cfg.capacity_factor)

    xg = x.reshape(Tg, d)
    logits = mm(xg, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = route(logits, k)                         # (Tg, k) each
    aux = load_balance_loss(probs, idx, E)

    token_for_slot, weight_sel, valid = _dispatch_tables(idx, k, E, C)
    x_pad = torch.cat([xg, xg.new_zeros((1, d))], dim=0)
    inp = x_pad[token_for_slot]                             # (E, C, d)
    w_flat = torch.cat([weights.reshape(-1), weights.new_zeros((1,))])
    w_slot = w_flat[torch.where(valid, weight_sel,
                                torch.full_like(weight_sel, Tg * k))]

    h = mm(inp, p["wi"])                                    # (E, C, f)
    h = activation(cfg, mm(inp, p["wg"])) * h
    out = mm(h, p["wo"])                                    # (E, C, d)
    out = out * w_slot[..., None].to(out.dtype)
    # each token's k slots (row E * C, zeros, for an assignment dropped by
    # the capacity), summed in top-k order; empty slots write the sentinel
    # entry Tg * k, which is cut off
    slot_of = torch.full((Tg * k + 1,), E * C, dtype=torch.long,
                         device=x.device)
    slot_of.scatter_(0, weight_sel.reshape(-1),
                     torch.arange(E * C, device=x.device))
    out_pad = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])
    y = out_pad[slot_of[:Tg * k].reshape(Tg, k)].sum(dim=1)
    return y.reshape(B, S, d), aux
