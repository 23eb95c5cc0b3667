"""The lowered step functions of the port, one per shape kind.

Counterpart of ``repro/launch/steps.py``: ``"train"`` is loss -> gradient
-> Adafactor at lr 1e-4, with gradient accumulation over microbatches,
for every family;
``"prefill"`` is the full-sequence forward with last-position logits (the
serving prefill of a whole prompt batch from a zero state), for every
family (MoE FFNs route the whole (B, S) batch as one group; a ``vlm``
batch carries ``patch_embeds``, an ``encdec`` one ``frame_embeds``);
every other kind (the dry run's ``decode`` cells) is the serve step, one
``decode_step`` token against the cache (the engine runs its own decode
dispatches, ``serve/engine.py``). The steps run on the card unless
``device="cpu"`` is given; they move the batch there (each array in its
own dtype), and the params (and the serve step's cache) must already be
there.

Under a mesh (``sharding.axes.use_mesh``) a step is one rank's program:
its params (and cache, and optimizer state) are the rank's resident
parts (``models/params.py::local_defs``) and its batch the rank's rows.
The train step then sums each gradient leaf over the mesh axes that
replicate it (``train/step.py::_reduce_grads``), updates the rank's
parts with Adafactor's sharded means, and returns the ranks' mean loss,
as the reference's step under GSPMD does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.params import (resident_axes, resident_specs,
                                       resolve_device)
from repro_torch.optim.adafactor import adafactor_update
from repro_torch.sharding import comm
from repro_torch.sharding.axes import _current_mesh
from repro_torch.train.step import DATA_AXES, _reduce_grads, accumulate


def _to(dev):
    def on_dev(a):
        return None if a is None else torch.as_tensor(a).to(dev)
    return on_dev


def make_train_step_fn(cfg: ModelConfig, microbatches: int = 1, device=None):
    """loss -> grad -> Adafactor update (the at-scale optimizer):
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"})``. microbatches > 1 splits the batch's leading dim and sums
    the parts' gradients in f32 (activation memory scales 1 / mb at the
    same math)."""
    on_dev = _to(resolve_device(device))

    def train_step(params, opt_state, batch):
        batch = {k: on_dev(v) for k, v in batch.items()}
        loss, _metrics, grads = accumulate(cfg, params, batch, microbatches)
        mesh, specs = _current_mesh(), None
        if mesh is not None and mesh.size > 1:
            specs = resident_specs(T.param_defs(cfg), mesh,
                                   resident_axes(cfg))
            grads = _reduce_grads(grads, specs, mesh, mesh.axis_names,
                                  mesh.size)
            n = 1
            for a in DATA_AXES:
                loss = comm.psum_raw(loss.float()[None], mesh, a,
                                     kind="metrics")[0]
                n *= comm.axis_size(mesh, a)
            loss = loss / n
        else:
            mesh = None
        params, opt_state, _ = adafactor_update(params, grads, opt_state,
                                                lr=1e-4, specs=specs,
                                                mesh=mesh)
        return params, opt_state, {"loss": loss}
    return train_step


def make_prefill_step_fn(cfg: ModelConfig, device=None):
    """Full-sequence forward, last-position logits (serving prefill):
    ``prefill_step(params, {"tokens": (B, S)[, "patch_embeds": (B, P, d)]
    [, "frame_embeds": (B, S_enc, d)]}) -> (B, V)``."""
    on_dev = _to(resolve_device(device))

    def prefill_step(params, batch):
        logits, _aux = T.forward_full(
            cfg, params, on_dev(batch["tokens"]),
            patch_embeds=on_dev(batch.get("patch_embeds")),
            frame_embeds=on_dev(batch.get("frame_embeds")),
            last_only=True)
        return logits[:, -1, :]
    return prefill_step


def make_serve_step_fn(cfg: ModelConfig, device=None):
    """One decode token against the KV cache (generation stage):
    ``serve_step(params, tokens (B, 1), cache, cur_len (B,)) -> (logits
    (B, V), cache)``, through ``T.decode_step``."""
    on_dev = _to(resolve_device(device))

    def serve_step(params, tokens, cache, cur_len):
        return T.decode_step(cfg, params, on_dev(tokens), cache,
                             on_dev(cur_len))
    return serve_step


def step_fn_for(cfg: ModelConfig, kind: str, device=None,
                microbatches: int = 1):
    """The step of a shape kind: ``"train"``, ``"prefill"``, and the serve
    step for any other, as the reference's ``step_fn_for``."""
    if kind == "train":
        return make_train_step_fn(cfg, microbatches, device)
    if kind == "prefill":
        return make_prefill_step_fn(cfg, device)
    return make_serve_step_fn(cfg, device)


# per-arch gradient-accumulation depth of the reference's train cells
TRAIN_MICROBATCHES = {
    "default": 2,
    "kimi-k2-1t-a32b": 16,
    "granite-20b": 4,
    "phi3-medium-14b": 4,
    "pixtral-12b": 4,
    "jamba-v0.1-52b": 4,
}


def train_microbatches(arch: str) -> int:
    return TRAIN_MICROBATCHES.get(arch, TRAIN_MICROBATCHES["default"])
