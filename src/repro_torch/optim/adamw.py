"""AdamW with f32 moments over bf16 (or f32) params: the port's copy of
``repro/optim/adamw.py``, plain functions over the nested parameter dict.

The state is the reference's tree: ``m`` and ``v`` mirror the params in
f32, ``step`` is an int32 scalar. Weight decay applies to every leaf of
two or more dimensions, decided on the stacked leaf as the reference does:
a stacked norm scale (L, d) is decayed too. Functional like the
reference: new tensors come back, the inputs are not written.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


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
    gradients are clipped to ``cfg.grad_clip`` in global norm first."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:  # decay matrices only (norms/scalars exempt)
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(lambda p, g, m, v: upd(p, g, m, v), params, grads,
                   state["m"], state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, {"grad_norm": gnorm, "clip_scale": scale}
