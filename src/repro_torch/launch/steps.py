"""The lowered step functions of the port, one per shape kind.

Counterpart of ``repro/launch/steps.py``: ``"prefill"`` is the
full-sequence forward with last-position logits (the serving prefill of a
whole prompt batch from a zero state), for every family the port serves
(MoE FFNs route the whole (B, S) batch as one group). ``"train"`` is not
ported yet (ROADMAP queue 1 item 6); the engine runs its decode step itself
(``serve/engine.py``). The step runs on the card unless ``device="cpu"``
is given; it moves the tokens there, and the params must already be
there.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.params import resolve_device


def make_prefill_step_fn(cfg: ModelConfig, device=None):
    """Full-sequence forward, last-position logits (serving prefill):
    ``prefill_step(params, {"tokens": (B, S)}) -> (B, V)``."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        logits, _aux = T.forward_full(cfg, params, tokens, last_only=True)
        return logits[:, -1, :]
    return prefill_step


def step_fn_for(cfg: ModelConfig, kind: str, device=None):
    if kind == "train":
        raise NotImplementedError("not ported yet: training (ROADMAP queue "
                                  "1 item 6)")
    if kind != "prefill":
        raise ValueError(f"unknown step kind {kind!r}: the port has "
                         f"\"prefill\"")
    return make_prefill_step_fn(cfg, device)
