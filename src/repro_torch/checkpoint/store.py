"""Atomic array publishing: the numpy part of ``repro/checkpoint/store.py``
(the port's own copy) that the chaos ``SnapshotStore`` writes through.

``atomic_save_arrays`` writes a flat {key: array} dict to ``<final>.tmp/``
(uint8-view npz plus an fsynced JSON manifest of each leaf's shape and
dtype), then renames it to ``final``: a crash mid-save never corrupts a
previously published directory, and a torn ``.tmp`` is never visible
under ``final``. ``load_arrays`` views the raw bytes back through the
manifest. The arrays are numpy's own dtypes: a bf16 tensor crosses as its
16-bit patterns (``np.uint16``), which round-trip bit for bit.

``flatten_cache`` keys a nested dict of tensors by its "/"-joined path in
sorted order, the reference's ``flatten_tree`` scheme, so a KV snapshot's
leaves carry the same names on both sides. The training checkpointer
(``save_checkpoint`` / ``CheckpointManager``) waits for the port's
trainer.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np


def flatten_cache(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> flat {"a/b": leaf}, keys in sorted order."""
    flat = {}
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            flat.update(flatten_cache(v, key))
        else:
            flat[key] = v
    return flat


def atomic_save_arrays(final: str, arrays: Dict[str, np.ndarray], *,
                       metadata: Optional[dict] = None,
                       extra: Optional[dict] = None) -> None:
    """Publish a flat {key: array} dict at directory ``final`` atomically:
    uint8-view npz and an fsynced manifest in ``<final>.tmp/``, then a
    rename."""
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    raw = {k: np.ascontiguousarray(v).view(np.uint8)
           for k, v in arrays.items()}
    np.savez(os.path.join(tmp, "shard_0.npz"), **raw)
    manifest = dict(extra or {})
    manifest["leaves"] = {k: {"shape": list(np.shape(v)),
                              "dtype": str(np.asarray(v).dtype)}
                          for k, v in arrays.items()}
    manifest["metadata"] = metadata or {}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def load_arrays(path: str):
    """Read an ``atomic_save_arrays`` directory back: (flat arrays dict,
    metadata)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        flat = {}
        for k in z.files:
            info = manifest["leaves"][k]
            flat[k] = z[k].view(np.dtype(info["dtype"])) \
                          .reshape(info["shape"])
    return flat, manifest["metadata"]


__all__ = ["atomic_save_arrays", "flatten_cache", "load_arrays"]
