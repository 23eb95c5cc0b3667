"""The train step: the port's copy of ``repro/train/step.py``.

``make_train_step`` returns ``step(params, opt_state, batch[, err_state])
-> (params, opt_state[, err_state], metrics)``: the loss and its gradient
(autograd through the model: on the card the flash, norm, wkv and
Mamba scan kernels and their backward kernels, ``cfg.remat`` for the
block loops), microbatches accumulated in f32, the optional int8
compressed all-reduce, and AdamW at the schedule's rate for the step
before it is counted (so a warmup's first step has rate 0, as in the
reference). Metrics: ``nll``, ``aux``,
``loss``, ``lr``, ``grad_norm``, ``clip_scale``. Every family trains, as
in the reference: on the card the recurrences run their backward kernels
(``rwkv_chunk_bwd``, ``mamba_chunk_bwd``) and the MoE FFN its plain
PyTorch gradient. Batches are numpy arrays or tensors and go to the
step's device, on the card unless ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.params import resolve_device, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.train import compression


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    learning_rate: Callable = staticmethod(lambda step: 3e-4)
    adamw: AdamWConfig = AdamWConfig()
    compress_grads: bool = False    # int8 EF all-reduce (compression.py)


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict):
    """(loss, metrics, grads) of ``T.loss_fn`` at ``params``, the
    gradients a tree like ``params`` in the params' dtypes; every tensor
    returned is detached."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = T.loss_fn(cfg, leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), leaves))


def accumulate(cfg: ModelConfig, params: dict, batch: dict, mb: int):
    """``loss_and_grads`` over ``mb`` microbatches: the batch's leading dim
    split into mb parts run one after another, their losses, metrics and
    f32 gradients summed and divided by mb (one part: the gradients stay
    in the params' dtypes, as in the reference)."""
    if mb == 1:
        return loss_and_grads(cfg, params, batch)
    parts = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
             for k, v in batch.items()}
    loss_a, metrics_a, grads_a = 0.0, {"nll": 0.0, "aux": 0.0}, tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    for i in range(mb):
        loss, metrics, grads = loss_and_grads(
            cfg, params, {k: v[i] for k, v in parts.items()})
        grads_a = tree_map(lambda a, g: a + g.float(), grads_a, grads)
        metrics_a = {k: metrics_a[k] + metrics[k] for k in metrics_a}
        loss_a = loss_a + loss
    inv = 1.0 / mb
    return (loss_a * inv, {k: m * inv for k, m in metrics_a.items()},
            tree_map(lambda g: g * inv, grads_a))


def make_train_step(cfg: ModelConfig,
                    tcfg: TrainStepConfig = TrainStepConfig(), device=None):
    """Returns step(params, opt_state, batch[, err_state]), its gradients
    ``accumulate``'s over ``tcfg.microbatches``."""
    dev = resolve_device(device)

    def step(params, opt_state, batch, err_state=None):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, metrics, grads = accumulate(cfg, params, batch,
                                          tcfg.microbatches)
        if tcfg.compress_grads:
            grads, err_state = compression.compressed_grad_allreduce(
                grads, err_state)
        lr = tcfg.learning_rate(opt_state["step"])
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, lr, tcfg.adamw)
        metrics = dict(metrics, loss=loss, lr=lr, **opt_metrics)
        if tcfg.compress_grads:
            return params, opt_state, err_state, metrics
        return params, opt_state, metrics

    return step
