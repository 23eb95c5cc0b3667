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

On meta tensors (the dry run, ``launch/cost.py``) a collective needs no
group and sends nothing: it counts in ``STATS`` as a sent one would, and
returns the n ranks' parts as empty meta tensors. On every device each
collective is also recorded into the active ``cost.CostCounter`` under
the reference's opcode -- ``all-reduce`` for a sum or a max, whatever
its transport, ``all-gather`` for a gather -- with its per-device result
bytes (``launch/hlo.py``'s convention).

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

Tensor parallelism (the reference leaves it to GSPMD) takes two more
operators over 'model', a conjugate pair: ``copy_to_model`` at the input
of a column-parallel product and ``reduce_from_model`` at the output of a
row-parallel one. Their backwards follow from the convention above; the
derivation is ``_CopyToModel``'s docstring. The combines that merge the
ranks' parts (``merge_argmax``, ``decode_attention``'s merge, the
vocabulary-parallel loss's ``merge_xent`` in ``models/layers.py``) are
pure functions of the list of parts, so a test in one process can feed
them emulated shards.
"""
from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist

from repro_torch.launch import cost
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
                 kind: str = "all_gather", op: str = "all-gather"
                 ) -> List[torch.Tensor]:
    """Every rank's x along ``axis``, in rank order: one all-gather.
    ``op`` is the reference's opcode for what the caller makes of the
    parts (``all-reduce`` for a sum or max of them)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return [x]
    nbytes = x.numel() * x.element_size()
    cost.record_collective(op, nbytes * (n if op == "all-gather" else 1))
    if x.is_meta:
        _count(kind, x, 0, "none (meta)")
        return [torch.empty_like(x) for _ in range(n)]
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
    total = _sum(gather_parts(x, mesh, axis, kind, "all-reduce"), x.dtype)
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
        parts = gather_parts(x, mesh, axis, "pmax", "all-reduce")
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


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward: the mean of the ranks' cotangents.

    Why this pair. The train step seeds each rank's loss with 1 and, after
    summing a leaf over the axes that replicate it, divides every leaf by
    ``mesh.size`` (``train/step.py::_reduce_grads``); a leaf sharded over
    'model' is not summed over 'model'. On a (1, m) mesh every rank's loss
    is the one-rank loss L, so the step gives the one-rank gradient if and
    only if autograd gives each rank m dL/dw for a sharded leaf, and
    replicas of a replicated leaf whose gradients sum to m dL/dw. Both
    hold when every replicated activation's cotangent is dL/d(activation)
    on every rank, as it is at the loss (seed 1), and it stays so through
    replicated computation (the norms, the residual adds):

    * at a row-parallel output y = psum(partials): the partial's one-rank
      cotangent is y's, and its sharded weight must get m times it, so
      ``reduce_from_model``'s backward is m dy (no collective);
    * at a column-parallel input x: rank r's cotangent is c_r = m times
      the part of dL/dx that flows through its shard, so dL/dx is the
      mean (1/m) sum_r c_r: ``copy_to_model``'s backward is the mean over
      'model' (one psum), which hands every rank dL/dx again. A
      replicated leaf read between the two (the router, the KV weights of
      a layout-B model) gets c_r-shaped parts that sum to m dL/dw.

    Megatron's pair (psum backward here, identity backward there) counts
    the loss once over the ranks: under this step it leaves a sharded
    leaf m times short. The exact transposes (identity here, psum there)
    also satisfy the step but leave the replicated cotangents ranks'
    parts, which ``reduce_from_model``'s m dy cannot take. The mean is
    linear and maps any cotangents that sum to m dL/dx (the exact
    transposes' parts, the expert-parallel MoE's) to dL/dx on every rank,
    so the expert-parallel path takes this operator at its input too."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        n = axis_size(ctx.mesh, ctx.axis)
        total = psum_raw(dy, ctx.mesh, ctx.axis, out_dtype=torch.float32,
                         kind="psum_bwd")
        return (total / n).to(dy.dtype), None, None


class _ReduceFromModel(torch.autograd.Function):
    """psum forward; backward: m dy (``_CopyToModel``'s docstring)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return psum_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy * axis_size(ctx.mesh, ctx.axis), None, None


def copy_to_model(x: torch.Tensor, mesh, axis: str = "model"
                  ) -> torch.Tensor:
    """The input of a column-parallel product: x unchanged; its gradient
    the mean of the ranks' over ``axis``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyToModel.apply(x, mesh, axis)


def reduce_from_model(x: torch.Tensor, mesh, axis: str = "model"
                      ) -> torch.Tensor:
    """The output of a row-parallel product: the psum over ``axis``; its
    gradient ``axis``'s extent times the output's."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFromModel.apply(x, mesh, axis)


def merge_argmax(parts: List[torch.Tensor]) -> torch.Tensor:
    """The ranks' (..., 2) float64 (value, global index) pairs, in rank
    order, merged to the (...) int64 index of the largest value, the
    lowest global index on a tie (``torch.argmax``'s rule): a later rank
    replaces the pick only where its value is strictly larger, and its
    indices are all larger than an earlier rank's."""
    best = parts[0]
    for p in parts[1:]:
        best = torch.where((p[..., 0] > best[..., 0])[..., None], p, best)
    return best[..., 1].long()


def sharded_argmax(x: torch.Tensor, offset: int, mesh,
                   axis: str = "model") -> torch.Tensor:
    """``torch.argmax(full, -1)`` of the tensor whose last dim is sharded
    over ``axis``, x this rank's columns [offset, offset + x.shape[-1]):
    each rank's (max, global index), one all-gather, ``merge_argmax``.
    Every rank gets the same int64 indices."""
    idx = torch.argmax(x, dim=-1)
    if axis_size(mesh, axis) == 1:
        return idx + offset
    val = x.gather(-1, idx[..., None])[..., 0]
    pair = torch.stack([val.double(), (idx + offset).double()], dim=-1)
    return merge_argmax(gather_parts(pair, mesh, axis, "argmax"))


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
