"""Adafactor (Shazeer & Stern, 2018): the port's copy of
``repro/optim/adafactor.py``, the optimizer of the lowered train step.

The second moment of a leaf of two or more dimensions is factored into
row and column statistics over its last two axes (``v_row``, ``v_col``),
of any other leaf kept whole (``v``); no first moment; ``step`` an int32
scalar. "Factored" is decided on the stacked leaf, as in the reference: a
stacked norm scale (L, d) is factored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models.params import ParamDef, tree_leaves, tree_map


@dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.8           # \hat{beta2}_t = 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_state_defs(param_defs) -> dict:
    """The optimizer state as a ParamDef tree mirroring a ParamDef tree
    (for the dry run: shapes and logical axes, no allocation)."""
    def one(pd: ParamDef):
        if _factored(pd.shape):
            return {
                "v_row": ParamDef(pd.shape[:-1], pd.logical_axes[:-1],
                                  "zeros", dtype="float32"),
                "v_col": ParamDef(pd.shape[:-2] + pd.shape[-1:],
                                  pd.logical_axes[:-2] + pd.logical_axes[-1:],
                                  "zeros", dtype="float32"),
            }
        return {"v": ParamDef(pd.shape, pd.logical_axes, "zeros",
                              dtype="float32")}

    return {"v": tree_map(one, param_defs),
            "step": ParamDef((), (), "zeros", dtype="int32")}


def adafactor_init(params) -> dict:
    def one(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"v_row": torch.zeros(p.shape[:-1], **z),
                    "v_col": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    dev = tree_leaves(params)[0].device
    return {"v": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.square().mean() + 1e-30)


def adafactor_update(params, grads, state, lr,
                     cfg: AdafactorConfig = AdafactorConfig()
                     ) -> Tuple[dict, dict, dict]:
    """Returns (new_params, new_state, {"beta2"})."""
    step = state["step"] + 1
    beta2 = 1.0 - step.float() ** (-cfg.decay)

    def upd(p, g, s):
        g = g.float()
        g2 = g.square() + cfg.eps
        if "v_row" in s:
            v_row = beta2 * s["v_row"] + (1 - beta2) * g2.mean(-1)
            v_col = beta2 * s["v_col"] + (1 - beta2) * g2.mean(-2)
            row_mean = v_row.mean(-1, keepdim=True)
            u = g * torch.rsqrt(
                (v_row / torch.clamp(row_mean, min=1e-30))[..., None]
                * v_col[..., None, :] + cfg.eps)
            new_s = {"v_row": v_row, "v_col": v_col}
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(v + cfg.eps)
            new_s = {"v": v}
        u = u / torch.clamp(_rms(u) / cfg.clip_threshold, min=1.0)
        new_p = p.float() - lr * u
        if cfg.weight_decay and p.ndim >= 2:
            new_p = new_p - lr * cfg.weight_decay * p.float()
        return new_p.to(p.dtype), new_s

    out = tree_map(lambda p, g, s: upd(p, g, s), params, grads, state["v"])
    new_params = tree_map(lambda o: o[0], out)
    new_v = tree_map(lambda o: o[1], out)
    return new_params, {"v": new_v, "step": step}, {"beta2": beta2}
