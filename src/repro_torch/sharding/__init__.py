"""Sharding of the port: the logical-axis rules (``axes``) and the
collectives over a mesh's axes (``comm``)."""
from repro_torch.sharding.axes import (
    LOGICAL_RULES,
    MeshInfo,
    constrain,
    logical_sharding,
    logical_spec,
    param_sharding_tree,
    use_mesh,
)

__all__ = [
    "LOGICAL_RULES",
    "MeshInfo",
    "logical_spec",
    "logical_sharding",
    "constrain",
    "param_sharding_tree",
    "use_mesh",
]
