"""Gradient compression for the data-parallel all-reduce: the port's copy
of ``repro/train/compression.py``.

int8 quantization with error feedback (EF-SGD): each rank adds its error
buffer to its gradient, quantizes it against a scale shared by all ranks
(the max-reduced amax / 127), all-reduces the int8 payload as int32,
dequantizes the mean, and keeps the local residual for the next step.
Over a ``torch.distributed`` group the amax is a MAX all-reduce and the
payload a SUM all-reduce of int32; with no initialised process group the
world is one rank and no collective runs, which is what the reference
computes on its 1 x 1 mesh. The multi-rank path is ROADMAP queue 1 item
7's to test.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves, tree_map


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _world(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def compressed_psum_leaf(g: torch.Tensor, err: torch.Tensor, group=None):
    """One leaf: (the mean over ranks of the dequantized gradient, the new
    local error)."""
    n = _world(group)
    g = g.float() + err
    amax = g.abs().max()
    if n > 1:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    if n > 1:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    mean = total.float() * scale / n
    return mean, g - q.float() * scale   # local residual (EF)


def compressed_grad_allreduce(grads, err_state, group=None):
    """Every leaf: returns (the quantized mean gradients, the new error
    buffers), trees like ``grads``."""
    pairs = tree_map(lambda g, e: compressed_psum_leaf(g, e, group), grads,
                     err_state)
    return (tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs))


def payload_bytes(params, compressed: bool) -> int:
    n = sum(int(np.prod(p.shape)) for p in tree_leaves(params))
    return n * (1 if compressed else 4)
