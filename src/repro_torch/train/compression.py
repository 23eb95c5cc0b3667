"""Gradient compression for the data-parallel all-reduce: the port's copy
of ``repro/train/compression.py``.

int8 quantization with error feedback (EF-SGD): each rank adds its error
buffer to its gradient, quantizes it against a scale shared by all ranks
(the max-reduced amax / 127), all-reduces the int8 payload as int32,
dequantizes the mean, and keeps the local residual for the next step.
Over a mesh's ``axis`` (``sharding/comm.py``) the leaves travel packed:
one collective takes every leaf's amax (reduced with MAX), one the int8
payload of every leaf (summed as int32 on each rank), so the payload is a
quarter of float32's bytes. With no mesh, or an axis of extent 1, the world
is one rank and nothing is sent, which is what the reference computes on
its 1 x 1 mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding import comm


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def compressed_psum_leaf(g: torch.Tensor, err: torch.Tensor, mesh=None,
                         axis: str = "data"):
    """One leaf: (the mean over the axis's ranks of the dequantized
    gradient, the new local error)."""
    (mean,), (new_err,) = _compressed([g], [err], mesh, axis)
    return mean, new_err


def _compressed(gs, errs, mesh, axis):
    n = comm.axis_size(mesh, axis)
    gs = [g.float() + e for g, e in zip(gs, errs)]
    amax = torch.stack([g.abs().max() for g in gs])
    if n > 1:
        parts = comm.gather_parts(amax, mesh, axis, "pmax", "all-reduce")
        amax = torch.stack(parts).amax(dim=0)
    scales = torch.clamp(amax / 127.0, min=1e-12)
    qs = [_quantize(g, scales[i]) for i, g in enumerate(gs)]
    if n > 1:
        flat = comm.psum_raw(torch.cat([q.reshape(-1) for q in qs]), mesh,
                             axis, out_dtype=torch.int32)
        totals = list(torch.split(flat, [q.numel() for q in qs]))
    else:
        totals = [q.to(torch.int32) for q in qs]
    means = [t.reshape(q.shape).float() * scales[i] / n
             for i, (t, q) in enumerate(zip(totals, qs))]
    new_errs = [g - q.float() * scales[i]        # local residual (EF)
                for i, (g, q) in enumerate(zip(gs, qs))]
    return means, new_errs


def compressed_grad_allreduce(grads, err_state, mesh=None,
                              axis: str = "data"):
    """Every leaf, over ``mesh``'s ``axis``: returns (the quantized mean
    gradients, the new error buffers), trees like ``grads``."""
    means, errs = _compressed(tree_leaves(grads), tree_leaves(err_state),
                              mesh, axis)
    it_m, it_e = iter(means), iter(errs)
    return (tree_map(lambda _: next(it_m), grads),
            tree_map(lambda _: next(it_e), grads))


def payload_bytes(params, compressed: bool) -> int:
    n = sum(int(np.prod(p.shape)) for p in tree_leaves(params))
    return n * (1 if compressed else 4)
