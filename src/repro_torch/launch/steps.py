"""The lowered step functions of the port, one per shape kind.

Counterpart of ``repro/launch/steps.py``: ``"train"`` is loss -> gradient
-> Adafactor at lr 1e-4, with gradient accumulation over microbatches,
for every family;
``"prefill"`` is the full-sequence forward with last-position logits (the
serving prefill of a whole prompt batch from a zero state), for every
family (MoE FFNs route the whole (B, S) batch as one group; a ``vlm``
batch carries ``patch_embeds``, an ``encdec`` one ``frame_embeds``). The
engine runs its decode step itself (``serve/engine.py``). The steps run
on the card unless ``device="cpu"`` is given; they move the batch there
(each array in its own dtype), and the params must already be there.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.params import resolve_device
from repro_torch.optim.adafactor import adafactor_update
from repro_torch.train.step import accumulate


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
        params, opt_state, _ = adafactor_update(params, grads, opt_state,
                                                lr=1e-4)
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


def step_fn_for(cfg: ModelConfig, kind: str, device=None,
                microbatches: int = 1):
    if kind == "train":
        return make_train_step_fn(cfg, microbatches, device)
    if kind != "prefill":
        raise ValueError(f"unknown step kind {kind!r}: the port has "
                         f"\"train\" and \"prefill\"")
    return make_prefill_step_fn(cfg, device)


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
