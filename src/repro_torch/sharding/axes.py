"""Logical-axis sharding rules of the port: the copy of
``repro/sharding/axes.py``.

Every tensor dimension is tagged with a *logical* axis name;
``logical_spec`` maps logical names to mesh axes through ``LOGICAL_RULES``,
dropping mesh axes that are absent from the mesh and demoting any mapping
whose dimension size is not divisible by the mapped mesh extent (e.g.
kv_heads=4 on a 16-way 'model' axis -> replicated). One rule table serves
the GEMM (prefill, train) path and the GEMV (decode) path, so nothing is
resharded between phases: the IANUS unified-memory property in its
distributed form.

A spec is a tuple with one entry per dim: ``None``, a mesh axis name, or a
tuple of names (``PartitionSpec``'s counterpart). Rules resolve on any
object with ``axis_names`` and sizes (a port ``Mesh``, or a stand-in whose
``devices`` array has the mesh's shape), so the 256- and 512-rank
production meshes resolve with no ranks at all.

Placement is the caller's. ``constrain`` returns its input unchanged (a
sharding constraint never changes values); what the port keeps sharded on
a rank, its *resident* layout, is ``resident_spec``'s: the sequence of a
layout-B KV cache and, under expert parallelism, the experts and their
ZeRO-3 d_ff slices. Every other dim is replicated: tensor parallelism of
the dense layers is not ported (ROADMAP). ``local_slice`` cuts a rank's
part of a full tensor by a spec and ``gather_slices`` puts the parts back.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

# logical axis -> candidate mesh axes (applied in order, all that fit)
LOGICAL_RULES: dict = {
    # data-parallel axes
    "batch": ("pod", "data"),
    # sequence: replicated by default
    "seq": (),
    # decode KV-cache sequence dim: falls back to 'model' when kv_heads could
    # not claim it (GQA with kv_heads < model extent) -- sequence-sharded cache
    "kv_seq": ("model",),
    # tensor-parallel axes
    "heads": ("model",),
    "kv_heads": ("model",),
    "d_ff": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "d_inner": ("model",),
    "rwkv_heads": ("model",),
    # ZeRO-3 weight dim: resident shards over 'data' (+ 'pod' when present)
    "fsdp": ("data", "pod"),
    # replicated axes
    "d_model": (),
    "head_dim": (),
    "d_state": (),
    "conv": (),
    "capacity": (),
    "layers": (),
    "stack": (),
    None: (),
}

# rule profiles: tp -- TP over 'model', DP over ('pod', 'data'); dp -- pure
# data parallelism over every axis
_DP_RULES = dict(LOGICAL_RULES)
_DP_RULES.update({
    "batch": ("pod", "data", "model"),
    "heads": (), "kv_heads": (), "d_ff": (), "vocab": (),
    "experts": (), "d_inner": (), "rwkv_heads": (), "fsdp": (),
    "kv_seq": (),
})

PROFILES = {"tp": LOGICAL_RULES, "dp": _DP_RULES}

_active_profile: contextvars.ContextVar = contextvars.ContextVar(
    "sharding_profile", default="tp")
_active_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "sharding_mesh", default=None)

# the logical axes a rank keeps sharded (see the module docstring)
RESIDENT = ("kv_seq", "experts", "fsdp")


def set_profile(name: str):
    assert name in PROFILES, name
    return _active_profile.set(name)


def active_rules() -> dict:
    return PROFILES[_active_profile.get()]


def axis_sizes(mesh) -> dict:
    """{axis name: extent} of a port ``Mesh`` or any object with
    ``axis_names`` and a ``devices`` array of the mesh's shape."""
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is not None:
        return dict(sizes)
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """A view of a mesh's axis sizes."""
    mesh: object

    @property
    def axis_sizes(self) -> dict:
        return axis_sizes(self.mesh)

    def extent(self, axes: Sequence[str]) -> int:
        s = 1
        for a in axes:
            s *= self.axis_sizes.get(a, 1)
        return s


def _resolve_dim(dim_size: int, logical: Optional[str], info: MeshInfo,
                 used: set, rules: Optional[dict] = None):
    """Mesh axes for one dimension, respecting presence, divisibility, and
    axes already claimed by earlier dims of the same tensor."""
    rules = rules or active_rules()
    sizes = info.axis_sizes
    cand = rules.get(logical, ())
    present = [a for a in cand
               if a in sizes and sizes[a] > 1 and a not in used]
    # the longest prefix of candidate axes whose product divides dim_size
    chosen: Tuple[str, ...] = ()
    ext = 1
    for a in present:
        if dim_size % (ext * sizes[a]) == 0:
            chosen = chosen + (a,)
            ext *= sizes[a]
        else:
            break
    used.update(chosen)
    if not chosen:
        return None
    return chosen if len(chosen) > 1 else chosen[0]


def logical_spec(shape: Sequence[int],
                 logical_axes: Sequence[Optional[str]], mesh,
                 rules: Optional[dict] = None) -> tuple:
    """The spec of ``shape`` whose dims carry ``logical_axes`` names.

    Dims are resolved left to right; a mesh axis claimed by an earlier dim
    is unavailable to later dims (a decode KV cache (batch, kv_heads,
    kv_seq, hd): batch claims 'data'; kv_heads claims 'model' when
    divisible, otherwise kv_seq claims 'model' -- the GQA-aware fallback)."""
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    info = MeshInfo(mesh)
    used: set = set()
    return tuple(_resolve_dim(s, a, info, used, rules)
                 for s, a in zip(shape, logical_axes))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec with its mesh (``NamedSharding``'s counterpart)."""
    mesh: object
    spec: tuple


def logical_sharding(shape, logical_axes, mesh, rules=None) -> Sharding:
    return Sharding(mesh, logical_spec(shape, logical_axes, mesh, rules))


def use_mesh(mesh):
    """``with use_mesh(mesh):`` -- the reference's ``with mesh:``: the model
    code reads the mesh through ``_current_mesh()``."""
    @contextlib.contextmanager
    def ctx():
        token = _active_mesh.set(mesh)
        try:
            yield mesh
        finally:
            _active_mesh.reset(token)
    return ctx()


def _current_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _active_mesh.get()


def model_extent(mesh) -> int:
    return 1 if mesh is None else axis_sizes(mesh).get("model", 1)


def constrain(x, logical_axes, mesh=None, rules=None):
    """The reference's ``with_sharding_constraint`` by logical names. A
    constraint changes placement, never values, and the port places its
    tensors itself (``resident_spec``): x comes back unchanged."""
    return x


def param_sharding_tree(abstract_params, mesh, rules=None):
    """A tree of ``Sharding`` for a tree of leaves that carry
    ``logical_axes`` (a ``ParamDef`` tree); a leaf without them is
    replicated."""
    if isinstance(abstract_params, dict):
        return {k: param_sharding_tree(v, mesh, rules)
                for k, v in abstract_params.items()}
    axes = getattr(abstract_params, "logical_axes", None)
    if axes is None:
        return Sharding(mesh, ())
    return logical_sharding(abstract_params.shape, axes, mesh, rules)


def resident_spec(shape, logical_axes, mesh, resident=RESIDENT,
                  rules=None) -> tuple:
    """``logical_spec`` with only the dims whose logical axis is in
    ``resident`` kept sharded: what a rank of the port holds."""
    spec = logical_spec(shape, logical_axes, mesh, rules)
    return tuple(s if a in resident else None
                 for s, a in zip(spec, logical_axes))


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_index(entry, mesh, coords: dict) -> Tuple[int, int]:
    """(the rank's index among the dim's shards, the number of shards) for
    one spec entry, the axes major to minor in the entry's order."""
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in _axes_of(entry):
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    sizes = axis_sizes(mesh)
    out = []
    for s, e in zip(shape, spec):
        n = int(np.prod([sizes[a] for a in _axes_of(e)])) if e else 1
        if s % n:
            raise ValueError(f"dim {s} does not split {n} ways ({spec})")
        out.append(s // n)
    return tuple(out)


def local_slice(x, spec, mesh, coords: dict):
    """The part of the full tensor x that a rank at mesh ``coords`` holds
    under ``spec`` (a view)."""
    for dim, e in enumerate(spec):
        if e is None:
            continue
        i, n = shard_index(e, mesh, coords)
        size = x.shape[dim] // n
        x = x.narrow(dim, i * size, size)
    return x


def gather_slices(parts: dict, spec, mesh):
    """The inverse of ``local_slice``: ``parts`` maps each rank's coords
    (a tuple in ``mesh.axis_names`` order) to its slice; returns the full
    tensor. Ranks that replicate a slice must hold the same values; the
    first one's is taken."""
    import torch
    names = tuple(mesh.axis_names)
    first = next(iter(parts.values()))
    full_shape = list(first.shape)
    for dim, e in enumerate(spec):
        full_shape[dim] *= shard_index(e, mesh, {a: 0 for a in names})[1]
    out = first.new_empty(full_shape)
    for key, part in parts.items():
        coords = dict(zip(names, key))
        local_slice(out, spec, mesh, coords).copy_(part)
    return out
