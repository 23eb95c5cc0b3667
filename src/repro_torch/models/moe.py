"""Mixture-of-Experts FFN of the port: top-k routing and sort-based
capacity dispatch.

Counterpart of ``repro/models/moe.py``: the ``gspmd`` path routes in
``_num_groups`` groups (one without a mesh), and ``apply_moe_ep`` is the
expert-parallel ``shard_map`` path on a rank's resident experts. Within a
group each expert takes at most ``C`` tokens (``capacity``);
a token past its expert's capacity, in the stable order of token index,
is dropped from that expert, as in the reference. The expert products
(``gecd,edf`` there) are plain batched matmuls, as the reference leaves
them to XLA outside any Pallas kernel.

Under tensor parallelism (a ``moe`` rank's resident experts, split over
'model' whatever ``moe_impl``) the ``gspmd`` path routes every token
replicated, computes the slots of its E/m experts of the (E, C) dispatch
and psums the combined output over 'model', as the reference's GSPMD
partitioning all-reduces it.

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
from repro_torch.models.layers import activation, mm, tp_mesh
from repro_torch.models.params import ParamDef
from repro_torch.sharding import comm
from repro_torch.sharding.axes import _current_mesh, axis_sizes


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


def _num_groups(batch: int, mesh) -> int:
    """One routing group per data shard of the logical batch (sort and
    gather stay local), as the reference counts them."""
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    g = 1
    for ax in ("pod", "data"):
        e = sizes.get(ax, 1)
        if batch % (g * e) == 0:
            g *= e
    return g


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _route_group(cfg: ModelConfig, xg: torch.Tensor, weights, idx, C: int,
                 wi, wg, wo, e0: int = 0, f_sum=None):
    """One routing group: xg (T, d) with its top-k ``weights``/``idx``
    (T, k) through experts [e0, e0 + wi.shape[0]) of capacity C each.
    ``f_sum`` (the EP path) sums the experts' partial outputs over the d_ff
    slices before the routing weights scale them. -> (T, d)."""
    T, d = xg.shape
    k = cfg.experts_per_token
    e_loc = wi.shape[0]
    local = idx - e0
    ours = (local >= 0) & (local < e_loc)
    # another rank's experts go to row e_loc of the table, which is cut off
    token_for_slot, weight_sel, valid = _dispatch_tables(
        torch.where(ours, local, torch.full_like(local, e_loc)), k,
        e_loc + 1, C)
    token_for_slot, weight_sel, valid = (token_for_slot[:e_loc],
                                         weight_sel[:e_loc], valid[:e_loc])
    x_pad = torch.cat([xg, xg.new_zeros((1, d))], dim=0)
    inp = x_pad[token_for_slot]                             # (e, C, d)
    w_flat = torch.cat([weights.reshape(-1), weights.new_zeros((1,))])
    w_slot = w_flat[torch.where(valid, weight_sel,
                                torch.full_like(weight_sel, T * k))]
    h = mm(inp, wi)                                         # (e, C, f)
    h = activation(cfg, mm(inp, wg)) * h
    out = mm(h, wo)                                         # (e, C, d)
    if f_sum is not None:
        out = f_sum(out)
    out = out * w_slot[..., None].to(out.dtype)
    # each token's k slots (row e * C, zeros, for an assignment dropped by
    # the capacity or routed to another rank), summed in top-k order;
    # empty slots write the sentinel entry T * k, which is cut off
    slot_of = torch.full((T * k + 1,), e_loc * C, dtype=torch.long,
                         device=xg.device)
    slot_of.scatter_(0, weight_sel.reshape(-1),
                     torch.arange(e_loc * C, device=xg.device))
    out_pad = torch.cat([out.reshape(e_loc * C, d), out.new_zeros((1, d))])
    return out_pad[slot_of[:T * k].reshape(T, k)].sum(dim=1)


def apply_moe_ep(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resident expert-parallel MoE: the reference's ``shard_map`` body on
    this rank. p holds the rank's resident slices: experts over 'model'
    (E / m of them) and, with ``fsdp_params``, d_ff over the data axes;
    without it the rank takes its d_ff slice of the full d_ff here. x is
    the rank's tokens (B, S, d).

    The tokens are all-gathered over the data axes, routed as one group
    (capacity from all T tokens), run through the local experts' d_ff
    slice, the partial outputs psummed over the data axes (the d_ff
    slices) and, weighted and combined per token, over 'model' (the
    experts); each rank returns its own tokens and the (replicated)
    balance loss. Differentiable through ``sharding/comm.py``'s
    collectives."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    sizes = axis_sizes(mesh)
    m_ext = sizes.get("model", 1)
    data_axes = _data_axes(mesh)
    d_ext = 1
    for a in data_axes:
        d_ext *= sizes[a]
    assert E % m_ext == 0 and cfg.d_ff % d_ext == 0
    # the tokens' gradient made whole on every 'model' rank
    # (``comm._CopyToModel``)
    x_all = comm.copy_to_model(x, mesh)
    for ax in data_axes:
        x_all = comm.all_gather(x_all, mesh, ax, dim=0)
    T = x_all.shape[0] * S
    C = capacity(T, k, E, cfg.capacity_factor)
    xf = x_all.reshape(T, d)
    logits = mm(xf, p["router"]).float()                # router replicated
    weights, idx = route(logits, k)
    probs = torch.softmax(logits, dim=-1)
    aux = load_balance_loss(probs, idx, E)

    # this rank's index among the data shards: its d_ff slice and tokens
    shard = 0
    for ax in data_axes:
        shard = shard * sizes[ax] + comm.axis_index(mesh, ax)
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    f_loc = cfg.d_ff // d_ext
    if wi.shape[-1] != f_loc:            # d_ff replicated: take our slice
        wi = wi.narrow(-1, shard * f_loc, f_loc)
        wg = wg.narrow(-1, shard * f_loc, f_loc)
        wo = wo.narrow(-2, shard * f_loc, f_loc)

    def f_sum(z):
        for ax in reversed(data_axes):                  # sum f slices
            z = comm.psum(z, mesh, ax)
        return z

    e0 = comm.axis_index(mesh, "model") * wi.shape[0]
    y = _route_group(cfg, xf, weights, idx, min(C, T * k), wi, wg, wo,
                     e0=e0, f_sum=f_sum)
    y = comm.psum(y, mesh, "model")                     # combine experts
    t_loc = B * S                        # this rank's tokens: undo the gather
    return y[shard * t_loc:(shard + 1) * t_loc].reshape(B, S, d), aux


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss f32 scalar). Under a mesh
    (``mesh`` or the current one) with more than one rank,
    ``cfg.moe_impl == "ep"`` takes the expert-parallel path; otherwise the
    tokens route in the reference's ``_num_groups`` groups, one per data
    shard of the logical batch. x is the rank's share of that batch (split
    over the data axes, as the train step splits it; a serve runs under a
    data extent of 1), so its rows are one group."""
    mesh = mesh or _current_mesh()
    if cfg.moe_impl == "ep" and mesh is not None and mesh.size > 1:
        return apply_moe_ep(cfg, p, x, mesh)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    n_data = 1
    if mesh is not None:
        for a in _data_axes(mesh):
            n_data *= axis_sizes(mesh)[a]
    # the reference routes one group a data shard of the logical batch;
    # this rank's rows are its shard: one group
    assert _num_groups(B * n_data, mesh) == n_data
    T = B * S
    C = capacity(T, k, E, cfg.capacity_factor)

    # experts split over 'model' (else d_ff, where 'model' does not
    # divide the experts): this rank's slots of every token, then the psum
    wi = p["wi"]
    split = tp_mesh(wi.shape[-3], E)
    e0 = 0 if split is None else \
        comm.axis_index(split, "model") * wi.shape[-3]
    if split is None:
        split = tp_mesh(wi.shape[-1], cfg.d_ff)
    xg = comm.copy_to_model(x.reshape(T, d), split)
    logits = mm(xg, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = route(logits, k)                         # (T, k) each
    if n_data == 1:
        aux = load_balance_loss(probs, idx, E)
    else:
        # the balance loss of the logical batch: its two means over every
        # data shard's tokens (each shard holds as many), one psum
        experts = torch.arange(E, device=idx.device)
        means = torch.stack([probs.mean(dim=0), (
            idx[:, 0, None] == experts).float().mean(dim=0)])
        for a in _data_axes(mesh):
            means = comm.psum(means, mesh, a)
        means = means / n_data
        aux = E * (means[1] * means[0]).sum()
    y = _route_group(cfg, xg, weights, idx, C, wi, p["wg"], p["wo"], e0=e0)
    return comm.reduce_from_model(y, split).reshape(B, S, d), aux
