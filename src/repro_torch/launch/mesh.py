"""Meshes of the port: the copy of ``repro/launch/mesh.py``.

Single pod: 256 ranks as (data=16, model=16). Multi-pod: 2 x 256 as
(pod=2, data=16, model=16); the 'pod' axis carries only data parallelism.
``make_production_mesh`` gives these shapes and axis names with no ranks
behind them (rule resolution and the dry run read only the sizes).

``make_host_mesh`` covers the ranks of the initialised
``torch.distributed`` process group (one rank without one). It is the
port's own small mesh: the ranks laid out row-major in the mesh's shape,
and for each axis one ``dist.new_group`` per line of ranks along it (every
rank creates every group, in the same order, as ``new_group`` asks), of
which a rank keeps those it belongs to. ``sharding/comm.py`` runs its
collectives over these groups.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class Mesh:
    """Axis names, and the ranks laid out in the mesh's shape
    (``devices``, the reference's attribute name). ``rank`` is this
    process's rank (None for a mesh without ranks) and ``groups`` the
    process group of each axis that holds it."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 rank: Optional[int] = None, groups: Optional[Dict] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.rank = rank
        self.groups = dict(groups or {})

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def shape(self) -> dict:
        return self.axis_sizes

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def empty(self) -> bool:
        return self.size == 0

    def coords(self, rank: Optional[int] = None) -> dict:
        """{axis: index} of ``rank`` (this process's by default)."""
        rank = self.rank if rank is None else rank
        if rank is None:
            raise ValueError("a mesh without ranks has no coordinates")
        at = np.argwhere(self.devices == rank)[0]
        return dict(zip(self.axis_names, (int(i) for i in at)))

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on an absent axis)."""
        if axis not in self.axis_names:
            return 0
        return self.coords()[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.axis_sizes}, rank={self.rank})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(model: int = 1, data: int = 0) -> Mesh:
    """A (data, model) mesh over the ranks of the initialised process
    group, or over one rank without one; ``data`` 0 takes the rest."""
    import torch.distributed as dist
    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    if data <= 0:
        data = max(1, n // model)
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh over {n} ranks")
    mesh = Mesh((data, model), ("data", "model"),
                rank=dist.get_rank() if live else 0)
    if live and n > 1:
        for ax, axis in enumerate(mesh.axis_names):
            lines = np.moveaxis(mesh.devices, ax, -1).reshape(
                -1, mesh.devices.shape[ax])
            for line in lines:
                if len(line) < 2:
                    continue
                group = dist.new_group([int(r) for r in line])
                if mesh.rank in line:
                    mesh.groups[axis] = group
    return mesh
