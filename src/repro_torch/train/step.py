"""The train step: the port's copy of ``repro/train/step.py``.

``make_train_step`` returns ``step(params, opt_state, batch[, err_state])
-> (params, opt_state[, err_state], metrics)``: the loss and its gradient
(autograd through the model: on the card the flash, norm, wkv and
Mamba scan kernels and their backward kernels, ``cfg.remat`` for the
block loops), microbatches accumulated in f32, the optional int8
compressed all-reduce, and AdamW at the schedule's rate for the step
before it is counted (so a warmup's first step has rate 0, as in the
reference). Metrics: ``nll``, ``aux``,
``loss``, ``lr``, ``grad_norm``, ``clip_scale``.

With a ``mesh`` the step is data-parallel over its data axes: each rank
takes its share of the batch's rows and computes its loss, the mean over
its rows; each gradient leaf is summed over the mesh axes that replicate
it and divided by the mesh's size (``sharding/comm.py``'s convention: the
global loss is the ranks' mean, so a replicated leaf's gradient is the
ranks' mean and an EP leaf's is complete on its rank). Where every rank's
share counts as many tokens (no ``loss_mask``) that is the gradient of
the whole batch's mean loss. ``compress_grads`` then replaces the data
axes' sum with the int8 all-reduce; without a mesh nothing is
compressed, as in the reference. The metrics are the ranks' means. Every family trains, as
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
from repro_torch.models.params import (resident_axes, resident_specs,
                                       resolve_device, tree_leaves, tree_map)
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.sharding import comm
from repro_torch.sharding.axes import use_mesh
from repro_torch.train import compression

DATA_AXES = ("pod", "data")


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


def _data_share(mesh):
    """(this rank's index among the data shards, their number)."""
    i, n = 0, 1
    for a in DATA_AXES:
        size = comm.axis_size(mesh, a)
        i, n = i * size + comm.axis_index(mesh, a), n * size
    return i, n


def _sharded(spec) -> set:
    return {x for e in spec if e is not None
            for x in (e if isinstance(e, tuple) else (e,))}


def _reduce_grads(grads, specs, mesh, axes, divide: int):
    """Each leaf summed over those of ``axes`` that replicate it, then
    divided by ``divide``: one collective per (dtype, axis) over the
    leaves that need it, packed flat."""
    out = list(tree_leaves(grads))
    spec_leaves = tree_leaves(specs)
    for a in axes:
        if comm.axis_size(mesh, a) == 1:
            continue
        by_dtype: dict = {}
        for i, spec in enumerate(spec_leaves):
            if a not in _sharded(spec):
                by_dtype.setdefault(out[i].dtype, []).append(i)
        for idx in by_dtype.values():
            flat = comm.psum_raw(torch.cat([out[i].reshape(-1)
                                            for i in idx]), mesh, a)
            for i, part in zip(idx, torch.split(
                    flat, [out[i].numel() for i in idx])):
                out[i] = part.reshape(out[i].shape)
    out = [(g.float() / divide).to(g.dtype) for g in out]
    it = iter(out)
    return tree_map(lambda _: next(it), grads)


def make_train_step(cfg: ModelConfig,
                    tcfg: TrainStepConfig = TrainStepConfig(), mesh=None,
                    device=None):
    """Returns step(params, opt_state, batch[, err_state]), its gradients
    ``accumulate``'s over ``tcfg.microbatches``; data-parallel over
    ``mesh``'s data axes (params and state the rank's resident parts,
    the batch whole: each rank takes its rows)."""
    dev = resolve_device(device)
    ranks = mesh is not None and mesh.size > 1

    def step(params, opt_state, batch, err_state=None):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        specs = None
        if ranks:
            i, n = _data_share(mesh)
            batch = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                     for k, v in batch.items()}
            specs = resident_specs(T.param_defs(cfg), mesh,
                                   resident_axes(cfg))
            with use_mesh(mesh):
                loss, metrics, grads = accumulate(cfg, params, batch,
                                                  tcfg.microbatches)
            if tcfg.compress_grads:
                # the other axes summed plainly, then the data axes' mean
                # through the int8 all-reduce, which takes leaves that
                # every data shard holds whole
                if any(_sharded(sp) & set(DATA_AXES)
                       for sp in tree_leaves(specs)):
                    raise NotImplementedError(
                        "compress_grads needs every leaf replicated over "
                        "the data axes")
                grads = _reduce_grads(
                    grads, specs, mesh,
                    [a for a in mesh.axis_names if a not in DATA_AXES],
                    mesh.size // n)
                for a in DATA_AXES:
                    if comm.axis_size(mesh, a) > 1:
                        grads, err_state = compression.\
                            compressed_grad_allreduce(grads, err_state,
                                                      mesh, a)
            else:
                grads = _reduce_grads(grads, specs, mesh, mesh.axis_names,
                                      mesh.size)
            vals = torch.stack([loss.float()] + [metrics[k].float()
                                                 for k in sorted(metrics)])
            for a in DATA_AXES:
                vals = comm.psum_raw(vals, mesh, a, kind="metrics")
            vals = vals / n
            loss = vals[0]
            metrics = dict(zip(sorted(metrics), vals[1:]))
        else:
            loss, metrics, grads = accumulate(cfg, params, batch,
                                              tcfg.microbatches)
        lr = tcfg.learning_rate(opt_state["step"])
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, lr, tcfg.adamw, specs,
            mesh if ranks else None)
        metrics = dict(metrics, loss=loss, lr=lr, **opt_metrics)
        if tcfg.compress_grads:
            return params, opt_state, err_state, metrics
        return params, opt_state, metrics

    return step
