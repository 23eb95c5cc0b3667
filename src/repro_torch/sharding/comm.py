"""Collectives over one axis of a mesh: what the reference's ``shard_map``
bodies call (``all_gather`` tiled along a dim, ``psum``, ``pmax``,
``axis_index``), as ``torch.autograd.Function``s over
``torch.distributed``.

Every collective is one ``all_gather`` over the axis's process group
(``launch/mesh.py``); a sum or a max then reduces the gathered parts on
each rank in rank order, in float32 for a floating type and int32 for an
integer one, before the cast back. So every rank gets the same bits, a
run repeats its own, and gloo runs every dtype, bf16 and int8 included.
A CUDA tensor is staged through a pinned host buffer, explicitly: the
payload is copied to the host, gathered there and copied back (gloo's
collectives run on host memory). ``STATS`` counts each collective, its
payload bytes, the bytes staged through the host and its time between
CUDA events before the copy out and after the copy back (host wall time
on the CPU); the transport of each kind is named there. On an axis of
extent 1 nothing is sent and nothing is counted.

Gradients. The convention: the global loss is the sum of the ranks'
losses, and a rank's loss counts a value replicated over k ranks by its
share, 1/k of it. Then the backward of a collective is fixed: ``psum``'s
is ``psum`` (each rank's input feeds every rank's output); ``all_gather``'s
sums the cotangents of every rank and keeps the rank's own part (a
reduce-scatter); ``pmax``'s sends the summed cotangent to the ranks that
hold the max. A leaf's gradient on a rank is its part of the global one:
complete for a leaf sharded over the axes its collectives ran on, and
summed over the ranks that replicate it otherwise (the train step does
that). These are the gradients ``jax.grad`` gives through the reference's
``shard_map``, whose transpose divides a replicated output's cotangent by
its replication the same way.
"""
from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist

from repro_torch.sharding.axes import axis_sizes

STATS = {"collectives": 0, "bytes": 0, "host_bytes": 0, "ms": 0.0,
         "by_kind": {}}
_PENDING: list = []   # CUDA event pairs not yet read


def reset_stats() -> None:
    _PENDING.clear()
    STATS.update(collectives=0, bytes=0, host_bytes=0, ms=0.0, by_kind={})


def stats() -> dict:
    """``STATS`` with the CUDA events read (this waits for them)."""
    for kind, start, end in _PENDING:
        end.synchronize()
        ms = start.elapsed_time(end)
        STATS["ms"] += ms
        STATS["by_kind"][kind]["ms"] += ms
    _PENDING.clear()
    return {**STATS, "by_kind": {k: dict(v) for k, v in
                                 STATS["by_kind"].items()}}


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else axis_sizes(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.axis_index(axis)


def _count(kind: str, x: torch.Tensor, staged: int, transport: str) -> None:
    nbytes = x.numel() * x.element_size()
    STATS["collectives"] += 1
    STATS["bytes"] += nbytes
    STATS["host_bytes"] += staged
    k = STATS["by_kind"].setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0,
                                           "transport": transport})
    k["calls"] += 1
    k["bytes"] += nbytes


def gather_parts(x: torch.Tensor, mesh, axis: str,
                 kind: str = "all_gather") -> List[torch.Tensor]:
    """Every rank's x along ``axis``, in rank order: one all-gather."""
    n = axis_size(mesh, axis)
    if n == 1:
        return [x]
    group = mesh.groups[axis]
    x = x.contiguous()
    if x.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        parts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                 for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        out = [p.to(x.device, non_blocking=True) for p in parts]
        end.record()
        _PENDING.append((kind, start, end))
        _count(kind, x, x.numel() * x.element_size() * (n + 1),
               "gloo over pinned host buffers")
        return out
    t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    _count(kind, x, 0, "gloo on host tensors")
    STATS["ms"] += 1e3 * (time.perf_counter() - t0)
    STATS["by_kind"][kind]["ms"] += 1e3 * (time.perf_counter() - t0)
    return parts


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else torch.int32


def _sum(parts: List[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    acc = parts[0].to(_acc_dtype(dtype))
    for p in parts[1:]:
        acc = acc + p.to(acc.dtype)
    return acc


def psum_raw(x: torch.Tensor, mesh, axis: str, out_dtype=None,
             kind: str = "psum") -> torch.Tensor:
    """The sum over ``axis`` without autograd; ``out_dtype`` None keeps
    x's dtype (an int8 payload can come back as its int32 sum); ``kind``
    is its name in ``STATS``."""
    if axis_size(mesh, axis) == 1:
        return x if out_dtype is None else x.to(out_dtype)
    total = _sum(gather_parts(x, mesh, axis, kind), x.dtype)
    return total.to(x.dtype if out_dtype is None else out_dtype)


def _own(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    size = t.shape[dim] // n
    return t.narrow(dim, axis_index(mesh, axis) * size, size)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return torch.cat(gather_parts(x, mesh, axis), dim=dim)

    @staticmethod
    def backward(ctx, dy):
        total = psum_raw(dy, ctx.mesh, ctx.axis)
        return _own(total, ctx.mesh, ctx.axis, ctx.dim).contiguous(), \
            None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return psum_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        return psum_raw(dy, ctx.mesh, ctx.axis), None, None


class _Pmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        parts = gather_parts(x, mesh, axis, "pmax")
        y = parts[0]
        for p in parts[1:]:
            y = torch.maximum(y, p)
        ctx.mesh, ctx.axis = mesh, axis
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        total = psum_raw(dy, ctx.mesh, ctx.axis)
        return torch.where(x == y, total, torch.zeros_like(total)), None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the ranks' x
    concatenated along ``dim`` in rank order."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.psum(x, axis)``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Psum.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.pmax(x, axis)``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Pmax.apply(x, mesh, axis)
