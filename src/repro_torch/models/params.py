"""Parameter trees of the port.

A model describes its parameters as a nested dict of ``ParamDef`` leaves,
exactly as the reference package does, so the port's trees have the same
nesting, shapes and dtypes. Two ways to fill one:

  * ``init_params``   — a torch init from the ``ParamDef`` shapes, driven by
                        a ``torch.Generator`` on the target device (full-width
                        weights are made on the card, without JAX);
  * ``from_jax_tree`` — carry a reference param or cache tree (as numpy
                        arrays) across with the same nesting and shapes.

As in the reference, ``ParamDef.dtype`` defaults to ``"bfloat16"`` whatever
``ModelConfig.dtype`` says; only the cache follows ``cfg.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "int8": torch.int8}


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


def _map_tree(fn, tree):
    """Map the leaves of a nested dict, visiting keys in sorted order."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


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
    return _map_tree(
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
    return _map_tree(lambda a: _to_torch(a).to(dev), tree)

