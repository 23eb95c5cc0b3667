"""The dry run's cost analysis: the work, bytes and memory of one rank's
step, counted op by op while the step runs, on meta tensors (nothing is
computed or allocated) or on real ones.

``CostCounter`` is a ``TorchDispatchMode``. Under it every aten op the
step dispatches is classed and counted, and every wrapper of
``kernels/ops.py`` adds its kernel's formula (``KernelCost``) and mutes
the aten ops it runs inside (on the CPU its plain version, on the card
the launch's allocations, on meta the empty outputs), so a kernel counts
by its formula on every device. The counts:

* ``flops_dot`` -- the dot class: ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions (``torch.utils.flop_counter``'s formulas,
  2 x multiply-adds) and the kernels' dot terms, which count the
  products of the reference's formulation of the same function (both
  masked products of attention over the full score matrix, the wkv's and
  the scan's einsums once a step).
* ``flops`` -- ``flops_dot`` plus one per output element of each
  pointwise op (aten's ``pointwise`` tag: arithmetic, comparisons,
  selects, activations, not copies or dtype conversions) and one per
  input element of each reduction, softmax counted as its five passes:
  the reference's whole-count convention (``flops_hlo``).
* ``transcendentals`` -- one per element of exp, log, tanh, sigmoid,
  rsqrt and their kin.
* ``bytes`` -- every op's tensor inputs read once and its outputs written
  once, unfused (views and allocations move nothing; an in-place copy or
  an indexed write does not read its destination, an indexed write
  writes its values' bytes, an indexed read reads the rows it returns).
  This is above XLA's fused "bytes accessed", which keeps a fusion's
  intermediates on chip.
* memory -- each storage an op allocates, from its first output to the
  storage's release (``weakref`` on the storage): ``temp_bytes`` is the
  peak of the live ones that the step's outputs do not hold (XLA's
  temporaries), ``output_bytes`` the storages of the outputs that the
  step allocated or that alias its arguments.
* collectives -- ``sharding/comm.py`` records each one (beside its kind
  in ``comm.STATS``): the reference's opcode (``all-reduce``,
  ``all-gather``) and its per-device result bytes (``launch/hlo.py``
  turns these into ``collective_bytes``).

Use::

    with CostCounter(args=(params, batch)) as c:
        out = step(params, batch)
    c.finish(out); c.summary()
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# the active counters, innermost last (a module global, not a context
# variable: the autograd engine runs a CUDA backward on its own thread)
_ACTIVE: List["CostCounter"] = []

_TRANSCENDENTAL = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2,
    aten.tanh, aten.sigmoid, aten.rsqrt, aten.sqrt, aten.sin, aten.cos,
    aten.erf, aten.silu, aten.gelu, aten.softplus, aten.pow,
    aten.reciprocal}
_REDUCTION = {aten.cumsum, aten.cumprod, aten.logcumsumexp, aten.topk,
              aten.argmax, aten.argmin}
_SOFTMAX = {aten._softmax: 5, aten._log_softmax: 5,
            aten._softmax_backward_data: 4,
            aten._log_softmax_backward_data: 3}
# an indexed write: (the destination, the values written)
_INDEXED_WRITE = {aten.index_put_: 2, aten.index_put: 2,
                  aten._index_put_impl_: 2, aten.index_copy_: 3,
                  aten.index_copy: 3, aten.scatter_: 3, aten.scatter: 3,
                  aten.scatter_add_: 3, aten.scatter_add: 3,
                  aten.index_add_: 3, aten.index_add: 3,
                  aten.masked_scatter_: 2}
# an indexed read: it reads the rows it returns, not its whole source
_INDEXED_READ = {aten.embedding, aten.index_select, aten.index, aten.gather}
_MOVES_NOTHING = {aten.empty, aten.empty_like, aten.empty_strided,
                  aten.new_empty, aten.new_empty_strided, aten.detach,
                  aten.lift_fresh, aten.alias, aten._unsafe_view,
                  aten.set_, aten.resize_, aten.sym_size, aten.sym_stride,
                  aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
                  aten._local_scalar_dense}


@dataclasses.dataclass
class KernelCost:
    """A kernel's work by its formula: dot-class flops, the other flops
    (the whole count is their sum), transcendentals, and the bytes it
    reads and writes once."""
    dot: int = 0
    other: int = 0
    transcendentals: int = 0
    bytes: int = 0


def nbytes(*ts) -> int:
    """Bytes of tensors (None skipped), each counted once by its distinct
    elements: a broadcast dim (stride 0) holds one."""
    total = 0
    for t in ts:
        if isinstance(t, torch.Tensor):
            n = 1
            for s, st in zip(t.shape, t.stride()):
                if st != 0:
                    n *= s
            total += n * t.element_size()
    return total


def current() -> Optional["CostCounter"]:
    return _ACTIVE[-1] if _ACTIVE else None


def record_collective(op: str, result_bytes: int) -> None:
    """A collective of this rank into the active counter, if any."""
    c = current()
    if c is not None:
        c.collectives.append({"op": op, "result_bytes": int(result_bytes)})


class _Muted:
    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        self.counter._muted += 1

    def __exit__(self, *exc):
        self.counter._muted -= 1


_NOTHING = contextlib.nullcontext()


def kernel(name: str, cost_fn, *args, **kwargs):
    """A context for one kernel wrapper's call: with a counter active it
    adds ``cost_fn(*args, **kwargs)`` (a ``KernelCost``) under ``name``
    and mutes the aten ops run inside; without one it does nothing."""
    c = current()
    if c is None:
        return _NOTHING
    c.add_kernel(name, cost_fn(*args, **kwargs))
    return _Muted(c)


class CostCounter(TorchDispatchMode):
    """Counts one run of a step (module docstring). ``args``: the step's
    arguments, whose storages are not the step's allocations."""

    def __init__(self, args=()):
        super().__init__()
        self.flops_dot = 0
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.kernels: Dict[str, dict] = {}
        self.collectives: List[dict] = []
        self._muted = 0
        self._arg_storages = {self._key(t) for t in _tensors(args)}
        self._seen: Dict[int, int] = {}       # storage key -> allocation id
        self._alloc: List[int] = []           # bytes of each allocation
        self._events: List[int] = []          # +id allocated, -id-1 freed
        self.temp_bytes = 0
        self.output_bytes = 0

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    # ------------------------------------------------------------------ #
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def add_kernel(self, name: str, kc: KernelCost) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops_dot": 0,
                                           "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops_dot"] += kc.dot
        k["flops"] += kc.dot + kc.other
        k["bytes"] += kc.bytes
        self.flops_dot += kc.dot
        self.flops += kc.dot + kc.other
        self.transcendentals += kc.transcendentals
        self.bytes += kc.bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._track(outs)
        if not self._muted:
            self._count(func, args, kwargs, out, outs)
        return out

    # ------------------------------------------------------------------ #
    def _track(self, outs) -> None:
        for t in outs:
            key = self._key(t)
            if key in self._seen or key in self._arg_storages:
                continue
            st = t.untyped_storage()
            i = len(self._alloc)
            self._seen[key] = i
            self._alloc.append(st.nbytes())
            self._events.append(i)
            weakref.finalize(st, self._free, key, i)

    def _free(self, key: int, i: int) -> None:
        if self._seen.get(key) == i:
            del self._seen[key]
        self._events.append(-i - 1)

    def _count(self, func, args, kwargs, out, outs) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops_dot += n
            self.flops += n
        elif packet in _SOFTMAX:
            n = _tensors(args)[0].numel()
            self.flops += _SOFTMAX[packet] * n
            if packet in (aten._softmax, aten._log_softmax):
                self.transcendentals += n
        elif torch.Tag.pointwise in func.tags:
            n = sum(t.numel() for t in outs)
            self.flops += n
            if packet in _TRANSCENDENTAL:
                self.transcendentals += n
        elif torch.Tag.reduction in func.tags or packet in _REDUCTION:
            self.flops += _tensors(args)[0].numel()
        if func.is_view or packet in _MOVES_NOTHING:
            return
        ins = _tensors((args, kwargs))
        if packet in _INDEXED_WRITE:
            values = args[_INDEXED_WRITE[packet]] \
                if len(args) > _INDEXED_WRITE[packet] else None
            self.bytes += nbytes(*ins[1:]) + nbytes(values)
            return
        if packet in _INDEXED_READ:
            self.bytes += nbytes(*ins[1:]) + 2 * nbytes(*outs)
            return
        if packet in (aten.copy_, aten.fill_, aten.zero_):
            ins = ins[1:]
        self.bytes += nbytes(*_distinct(ins)) + nbytes(*outs)

    # ------------------------------------------------------------------ #
    def finish(self, out) -> None:
        """Close the count on the step's outputs: ``output_bytes`` and the
        peak of the temporaries that the outputs do not hold."""
        keep = set()
        seen = set()
        self.output_bytes = 0
        for t in _tensors(out):
            key = self._key(t)
            if key in seen:
                continue
            seen.add(key)
            self.output_bytes += t.untyped_storage().nbytes()
            if key in self._seen:
                keep.add(self._seen[key])
        live = peak = 0
        for e in list(self._events):
            if e >= 0:
                if e not in keep:
                    live += self._alloc[e]
                    peak = max(peak, live)
            elif -e - 1 not in keep:
                live -= self._alloc[-e - 1]
        self.temp_bytes = peak

    def summary(self) -> dict:
        return {"flops": self.flops, "flops_dot": self.flops_dot,
                "transcendentals": self.transcendentals,
                "bytes": self.bytes, "temp_bytes": self.temp_bytes,
                "output_bytes": self.output_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "collectives": list(self.collectives)}


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _distinct(ts) -> list:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out
