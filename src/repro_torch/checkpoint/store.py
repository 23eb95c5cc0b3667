"""Checkpointing: step-atomic npz shards with a JSON manifest, the port's
copy of ``repro/checkpoint/store.py``.

``atomic_save_arrays`` writes a flat {key: array} dict to ``<final>.tmp/``
(uint8-view npz plus an fsynced JSON manifest of each leaf's shape and
dtype), then renames it to ``final``: a crash mid-save never corrupts a
previously published directory, and a torn ``.tmp`` is never visible
under ``final``. ``load_arrays`` views the raw bytes back through the
manifest. The arrays are numpy's own dtypes: a bf16 tensor crosses as its
16-bit patterns (``np.uint16``), which round-trip bit for bit; the KV
snapshots name them ``uint16`` in the manifest, the training checkpoints
``bfloat16`` (the reference's name, so that either package loads the
other's checkpoints), and ``load_arrays`` reads a ``bfloat16`` leaf as
its ``uint16`` patterns without any bf16 numpy type.

``flatten_tree`` keys a nested dict by its "/"-joined path in sorted
order, the reference's scheme, so leaves carry the same names on both
sides. The training half: ``save_checkpoint`` (gather on the caller,
write on an executor), ``latest_step``, ``load_checkpoint`` and
``CheckpointManager`` (retention of the last ``keep`` steps).
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch


def flatten_tree(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> flat {"a/b": leaf}, keys in sorted order."""
    flat = {}
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = v
    return flat


def unflatten_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    """Rebuild ``template``'s nesting from a ``flatten_tree`` dict; each
    leaf's shape must match the template's (a checkpoint of another shape
    is an error, not a broadcast)."""
    out = {}
    for k in sorted(template):
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(template[k], dict):
            out[k] = unflatten_into(template[k], flat, key)
            continue
        arr = flat[key]
        if tuple(arr.shape) != tuple(template[k].shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} in the "
                             f"checkpoint, {tuple(template[k].shape)} "
                             f"expected")
        out[k] = arr
    return out


def atomic_save_arrays(final: str, arrays: Dict[str, np.ndarray], *,
                       metadata: Optional[dict] = None,
                       extra: Optional[dict] = None,
                       dtypes: Optional[Dict[str, str]] = None) -> None:
    """Publish a flat {key: array} dict at directory ``final`` atomically:
    uint8-view npz and an fsynced manifest in ``<final>.tmp/``, then a
    rename. ``dtypes`` names a leaf's dtype in the manifest where it is
    not the array's own (``bfloat16`` for 16-bit patterns)."""
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    raw = {k: np.ascontiguousarray(v).view(np.uint8)
           for k, v in arrays.items()}
    np.savez(os.path.join(tmp, "shard_0.npz"), **raw)
    manifest = dict(extra or {})
    manifest["leaves"] = {k: {"shape": list(np.shape(v)),
                              "dtype": (dtypes or {}).get(
                                  k, str(np.asarray(v).dtype))}
                          for k, v in arrays.items()}
    manifest["metadata"] = metadata or {}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def load_arrays(path: str):
    """Read an ``atomic_save_arrays`` directory back: (flat arrays dict,
    metadata); a ``bfloat16`` leaf comes back as its uint16 patterns."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        flat = {}
        for k in z.files:
            info = manifest["leaves"][k]
            flat[k] = z[k].view(_np_dtype(info["dtype"])) \
                          .reshape(info["shape"])
    return flat, manifest["metadata"]


def _to_host(t) -> np.ndarray:
    """A tensor (or array) as a numpy array; bf16 as its 16-bit
    patterns."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    metadata: Optional[dict] = None, keep: int = 3,
                    executor: Optional[ThreadPoolExecutor] = None
                    ) -> Optional[Future]:
    """Gather ``tree`` (a nested dict of tensors) to the host here, then
    write ``step_<step>`` and drop all but the last ``keep`` steps, on
    ``executor`` when one is given (the returned future)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = flatten_tree(tree)
    dtypes = {k: "bfloat16" for k, v in flat.items()
              if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16}
    host = {k: _to_host(v) for k, v in flat.items()}

    def _write():
        atomic_save_arrays(os.path.join(ckpt_dir, f"step_{step}"), host,
                           metadata=metadata, extra={"step": step},
                           dtypes=dtypes)
        _gc(ckpt_dir, keep)

    if executor is not None:
        return executor.submit(_write)
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(_all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def _all_steps(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _all_steps(ckpt_dir)
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    """A loaded leaf as a tensor of the template leaf's dtype and device;
    16-bit patterns become bf16 again bit for bit."""
    arr = np.array(arr, order="C")           # a copy, 0-d kept 0-d
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def load_checkpoint(ckpt_dir: str, step: int, template):
    """Restore ``step_<step>`` into the nesting of ``template`` (a nested
    dict of tensors), each leaf in the template leaf's dtype and on its
    device. Returns (tree, metadata)."""
    flat, meta = load_arrays(os.path.join(ckpt_dir, f"step_{step}"))
    tensors = {k: _to_tensor(flat[k], like)
               for k, like in flatten_tree(template).items()}
    return unflatten_into(template, tensors), meta


class CheckpointManager:
    """Background-saving manager: one write in flight at a time."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def save(self, step: int, tree, metadata: Optional[dict] = None):
        self.wait()
        self._pending = save_checkpoint(
            self.ckpt_dir, step, tree, metadata=metadata, keep=self.keep,
            executor=self._pool)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def restore_latest(self, template):
        s = latest_step(self.ckpt_dir)
        if s is None:
            return None
        tree, meta = load_checkpoint(self.ckpt_dir, s, template)
        return {"step": s, "tree": tree, "metadata": meta}


__all__ = ["atomic_save_arrays", "flatten_tree",
           "load_arrays", "unflatten_into", "save_checkpoint",
           "latest_step", "load_checkpoint", "CheckpointManager"]
