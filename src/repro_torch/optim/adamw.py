"""AdamW with f32 moments over bf16 (or f32) params: the port's copy of
``repro/optim/adamw.py``, plain functions over the nested parameter dict.

The state is the reference's tree: ``m`` and ``v`` mirror the params in
f32, ``step`` is an int32 scalar. Weight decay applies to every leaf of
two or more dimensions, decided on the stacked leaf as the reference does:
a stacked norm scale (L, d) is decayed too. New tensors come back and
no input tensor is written, as in the reference; but ``adamw_update``
consumes the state's moment trees (each leaf's old m and v leave them as
its new ones are made), so that a step holds one copy of the moments and
not two: the f32 moments of jamba's two-layer stack at full width are
29 GB, and two copies beside its weights and gradients do not fit an
80 GB card. For the same reason a large leaf is updated in pieces of
``PIECE`` elements.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


# the elements a leaf is updated in at a time
PIECE = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm over every leaf."""
    return torch.sqrt(torch.stack(
        [g.float().square().sum() for g in tree_leaves(tree)]).sum())


def adamw_update(params, grads, state, lr, cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[dict, dict, dict]:
    """Returns (new_params, new_state, {"grad_norm", "clip_scale"}); the
    gradients are clipped to ``cfg.grad_clip`` in global norm first.
    ``state["m"]`` and ``state["v"]`` are emptied leaf by leaf (their
    tensors are not written); the new moments are in ``new_state``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v, p_new, m_new, v_new, decay: bool):
        g = g.float() * scale
        torch.add(cfg.b1 * m, (1 - cfg.b1) * g, out=m_new)
        torch.add(cfg.b2 * v, (1 - cfg.b2) * g.square(), out=v_new)
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if decay:  # decay matrices only (norms/scalars exempt)
            delta = delta + cfg.weight_decay * p.float()
        torch.sub(p.float(), lr * delta, out=p_new)   # cast to p's dtype

    def one(p, g, m, v):
        # elementwise, so the same bits piece by piece: a few f32
        # temporaries of a piece, not of the leaf (3.8 GB each for one of
        # jamba's expert stacks); each result written into its new leaf
        new = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        flat = [t.reshape(-1) for t in (p, g, m, v, *new)]
        for a in range(0, p.numel(), PIECE):
            upd(*(t[a:a + PIECE] for t in flat), decay=p.ndim >= 2)
        return new

    def walk(p, g, m, v):
        if not isinstance(p, dict):
            return one(p, g, m, v)
        new = ({}, {}, {})
        for k in list(p):
            # popped, the old moments die when their leaf is done
            for tree, leaf in zip(new, walk(p[k], g[k], m.pop(k), v.pop(k))):
                tree[k] = leaf
        return new

    new_p, new_m, new_v = walk(params, grads, state["m"], state["v"])
    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "clip_scale": scale}
