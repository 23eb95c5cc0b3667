"""The served model's weights, drawn from the run's seed on the device.

The tree is the one ``repro_torch.models.transformer.param_defs`` lays out
(stacked layers under ``blocks/pos{j}``). Every layer's slice of every
leaf is drawn by its own generator, seeded from (seed, leaf path, layer),
in the dtype it is served in, in one ``randn`` call. So the reference can
draw any single layer again, bit for bit, without holding the program's
tree: it reads nothing the program made.

Scales: a projection's normal has std ``fan_in ** -0.5``, the embedding's
0.02; a norm's scale is 1 + 0.05 N(0, 1) and its bias 0.02 N(0, 1), so
that the comparison sees the norms' affine terms (zeros and ones would
hide a dropped scale or bias).
"""
from __future__ import annotations

import hashlib
from typing import Iterator, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def slice_seed(seed: int, path: str, layer: int) -> int:
    """A 63-bit generator seed for one layer of one leaf."""
    h = hashlib.blake2b(f"{int(seed)}/{path}/{int(layer)}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def _std(pd) -> float:
    if pd.init == "small_normal":
        return 0.02 * pd.scale
    if pd.init == "normal":
        return pd.scale * pd.fan_in() ** -0.5
    if pd.init == "ones":
        return 0.05
    if pd.init == "zeros":
        return 0.02
    raise ValueError(f"no draw for init {pd.init!r}")


def draw_slice(pd, seed: int, path: str, layer: int,
               device: torch.device) -> torch.Tensor:
    """Layer ``layer`` of leaf ``path`` (or the whole leaf, layer -1) in
    the leaf's dtype."""
    shape = pd.shape[1:] if layer >= 0 else pd.shape
    g = torch.Generator(device=device)
    g.manual_seed(slice_seed(seed, path, layer))
    t = torch.randn(shape, generator=g, device=device,
                    dtype=DTYPES[pd.dtype])
    t.mul_(_std(pd))
    if pd.init == "ones":
        t.add_(1.0)
    return t


def _stacked(pd) -> bool:
    return len(pd.logical_axes) > 0 and pd.logical_axes[0] == "layers"


def leaves(defs, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, ParamDef) of a def tree, in sorted-key order."""
    for k in sorted(defs):
        v = defs[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v


def draw_tree(defs, seed: int, device: torch.device) -> dict:
    """The whole tree: stacked leaves filled a layer at a time."""
    out: dict = {}
    for path, pd in leaves(defs):
        if _stacked(pd):
            t = torch.empty(pd.shape, dtype=DTYPES[pd.dtype], device=device)
            for i in range(pd.shape[0]):
                t[i].copy_(draw_slice(pd, seed, path, i, device))
        else:
            t = draw_slice(pd, seed, path, -1, device)
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return out


def draw_layer(defs, seed: int, device: torch.device, prefix: str,
               layer: int) -> dict:
    """Layer ``layer`` of the subtree at ``prefix`` (``blocks/pos0``) as
    a flat dict {relative path: tensor}, or a subtree without a layer axis
    (``embed``, ``final_norm``) with ``layer`` -1."""
    node = defs
    for p in prefix.split("/"):
        node = node[p]
    out = {}
    for rel, pd in leaves(node):
        path = f"{prefix}/{rel}"
        out[rel] = draw_slice(pd, seed, path, layer if _stacked(pd) else -1,
                              device)
    return out
