"""Parameter trees of the port.

A model describes its parameters as a nested dict of ``ParamDef`` leaves,
exactly as the reference package does, so the port's trees have the same
nesting, shapes and dtypes. Two ways to fill one:

  * ``init_params``   — a torch init from the ``ParamDef`` shapes, driven by
                        a ``torch.Generator`` on the target device (full-width
                        weights are made on the card, without JAX);
  * ``from_jax_tree`` — carry a reference param or cache tree (as numpy
                        arrays) across with the same nesting and shapes.

``abstract_params`` gives a tree's tensors on the ``meta`` device (no
allocation) and ``shardings_for`` its specs on a mesh. Under a mesh a rank
holds its resident part of a tree (``sharding/axes.py::resident_spec``):
``local_defs`` shrinks a ParamDef tree to those shapes, ``shard_tree``
cuts a full tree down to them and ``init_shard`` draws a rank's parts of
``init_params``' tree one leaf at a time.

As in the reference, ``ParamDef.dtype`` defaults to ``"bfloat16"`` whatever
``ModelConfig.dtype`` says; only the cache follows ``cfg.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "int8": torch.int8, "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"   # "normal" | "zeros" | "ones" | "small_normal" | "decay"
    scale: float = 1.0            # multiplies the distribution's natural scale
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} vs axes {self.logical_axes}")

    def fan_in(self) -> int:
        # last dim is fan-out; leading stacked 'layers' dims are not fan-in
        dims = [s for s, a in zip(self.shape[:-1], self.logical_axes[:-1])
                if a != "layers"]
        return int(np.prod(dims)) if dims else 1


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU:
    ``None`` means CUDA, and no CUDA device means an error, never a quiet
    CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain PyTorch path on the CPU")
    return dev


def _materialize(pd: ParamDef, gen: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    dt = DTYPES[pd.dtype]
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dt, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dt, device=device)
    if pd.init == "decay":
        # rwkv/mamba decay-style init: negative, spread log-uniformly
        u = torch.rand(pd.shape, generator=gen, device=device,
                       dtype=torch.float32) * (1.0 - 1e-3) + 1e-3
        return (torch.log(u) * pd.scale).to(dt)
    std = pd.scale * 0.02 if pd.init == "small_normal" \
        else pd.scale * pd.fan_in() ** -0.5
    # scaled in place: one float32 draw at a time (an expert leaf of
    # kimi-k2's is 22.5 GB in float32)
    return torch.randn(pd.shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(std).to(dt)


def tree_map(fn, tree, *rest):
    """Map the leaves of a nested dict, visiting keys in sorted order (the
    order of ``jax.tree.leaves`` over dicts). ``rest`` are trees of the
    same nesting whose corresponding subtrees are passed beside each leaf
    (an optimizer's per-leaf state dict, say)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_params(defs, generator: Optional[torch.Generator] = None, *,
                device=None, seed: int = 0):
    """Materialize a ParamDef tree on ``device`` (CUDA unless the caller
    passes ``device="cpu"``). Leaves are drawn in sorted-path order from
    ``generator`` (a new one seeded with ``seed`` when None), which must
    live on the same device. The draws differ from ``jax.random``'s; a
    test that needs the reference's weights carries them across with
    ``from_jax_tree``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    return tree_map(
        lambda pd: _materialize(pd, generator, dev) if is_def(pd) else pd,
        defs)


def _to_torch(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a dtype torch.from_numpy knows: carry
        # the bits across as uint16 and reinterpret them
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_jax_tree(tree, device="cpu"):
    """Carry a reference param or cache tree (leaves that convert to numpy,
    bf16 included) across as torch tensors with the same nesting, shapes
    and dtypes."""
    dev = torch.device(device)
    return tree_map(lambda a: _to_torch(a).to(dev), tree)


def abstract_params(defs):
    """The tree's tensors on the ``meta`` device: shapes and dtypes, no
    storage (the reference's ShapeDtypeStruct tree)."""
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=DTYPES[pd.dtype],
                                           device="meta")
                    if is_def(pd) else pd, defs)


def shardings_for(defs, mesh, rules=None):
    """Each leaf's ``Sharding`` (spec and mesh) by the logical rules."""
    from repro_torch.sharding.axes import logical_sharding
    return tree_map(lambda pd: logical_sharding(pd.shape, pd.logical_axes,
                                                mesh, rules), defs)


# the tensor-parallel axes: every logical axis the rule table puts on
# 'model' but a layout-B cache's sequence
TP_AXES = ("heads", "kv_heads", "d_ff", "vocab", "experts", "d_inner",
           "rwkv_heads")


def resident_axes(cfg) -> tuple:
    """The logical axes a rank of ``cfg``'s model keeps sharded, the same
    for every family: the tensor-parallel axes (attention heads and KV
    heads, d_ff, vocabulary, experts, Mamba's ``d_inner`` and RWKV's
    heads, each over 'model' where the rule table puts it there), a
    layout-B cache's sequence, and under the expert-parallel MoE the
    experts' ZeRO-3 d_ff slices. A leaf the rule table leaves whole
    (RWKV's ``wcr`` and ``w_lora_a``, a vocabulary that 'model' does not
    divide) stays whole on each rank."""
    ep = ("fsdp",) if cfg.moe_impl == "ep" else ()
    return TP_AXES + ("kv_seq",) + ep


def _resident(pd: ParamDef, mesh, resident) -> tuple:
    from repro_torch.sharding.axes import resident_spec
    return resident_spec(pd.shape, pd.logical_axes, mesh, resident)


def local_defs(defs, mesh, resident):
    """``defs`` with each leaf's shape cut to what a rank of ``mesh`` holds
    of it (the dims of ``resident`` logical axes split); no mesh: defs."""
    if mesh is None:
        return defs
    from repro_torch.sharding.axes import local_shape
    return tree_map(lambda pd: dataclasses.replace(
        pd, shape=local_shape(pd.shape, _resident(pd, mesh, resident), mesh))
        if is_def(pd) else pd, defs)


def shard_tree(tree, defs, mesh, resident):
    """A full tree (leaves shaped as ``defs``) cut to this rank's resident
    parts, each a contiguous copy; no mesh: the tree."""
    if mesh is None:
        return tree
    from repro_torch.sharding.axes import local_slice
    coords = mesh.coords()
    return tree_map(lambda x, pd: local_slice(
        x, _resident(pd, mesh, resident), mesh, coords).contiguous(),
        tree, defs)


def init_shard(defs, mesh, resident, *, device=None, seed: int = 0):
    """This rank's resident parts of ``init_params(defs, seed=seed)``: each
    leaf drawn whole, in ``init_params``'s order from its generator, and
    cut at once, so that a rank never holds more than one whole leaf
    beside its parts (two ranks of jamba's 26 GB period on one card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    coords = None if mesh is None else mesh.coords()

    def one(pd):
        if not is_def(pd):
            return pd
        full = _materialize(pd, gen, dev)
        if mesh is None:
            return full
        from repro_torch.sharding.axes import local_slice
        return local_slice(full, _resident(pd, mesh, resident), mesh,
                           coords).clone()
    return tree_map(one, defs)


def resident_specs(defs, mesh, resident):
    """Each leaf's resident spec (a tuple per leaf)."""
    return tree_map(lambda pd: _resident(pd, mesh, resident), defs)


def param_count(defs) -> int:
    """The parameters of a ParamDef tree (the reference's count)."""
    return sum(int(np.prod(pd.shape)) for pd in tree_leaves(defs)
               if is_def(pd))


def param_bytes(defs) -> int:
    """The bytes of a ParamDef tree in each leaf's own dtype."""
    return sum(int(np.prod(pd.shape)) * DTYPES[pd.dtype].itemsize
               for pd in tree_leaves(defs) if is_def(pd))
