"""input_specs: ``meta``-device stand-ins for every model input, with the
matching ``Sharding``s -- shapes, dtypes and specs, nothing allocated. The
port's copy of ``repro/launch/specs.py``.

One function per assigned shape kind:
  train_4k    -> (params, opt_state, batch)                for train_step
  prefill_32k -> (params, batch)                           for prefill_step
  decode_32k / long_500k -> (params, tokens, cache, lens)  for serve_step
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.models.params import DTYPES, abstract_params, shardings_for
from repro_torch.optim.adafactor import adafactor_state_defs
from repro_torch.sharding.axes import logical_sharding


def _meta(shape, dtype):
    return torch.empty(shape, dtype=DTYPES[dtype], device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int, mesh,
                labels: bool = True) -> Tuple[Dict, Dict]:
    """A full-sequence pass's token batch as meta tensors, and their
    shardings."""
    specs, shards = {}, {}

    def add(name, shape, dtype, axes):
        specs[name] = _meta(shape, dtype)
        shards[name] = logical_sharding(shape, axes, mesh)

    if cfg.family == "vlm":
        s_text = seq - cfg.num_patches
        add("tokens", (batch, s_text), "int32", ("batch", "seq"))
        if labels:
            add("labels", (batch, s_text), "int32", ("batch", "seq"))
        add("patch_embeds", (batch, cfg.num_patches, cfg.d_model),
            cfg.dtype, ("batch", "seq", "d_model"))
    else:
        add("tokens", (batch, seq), "int32", ("batch", "seq"))
        if labels:
            add("labels", (batch, seq), "int32", ("batch", "seq"))
    if cfg.family == "encdec":
        add("frame_embeds", (batch, cfg.encoder_seq, cfg.d_model),
            cfg.dtype, ("batch", "seq", "d_model"))
    return specs, shards


def param_specs(cfg: ModelConfig, mesh):
    defs = T.param_defs(cfg)
    return abstract_params(defs), shardings_for(defs, mesh)


def opt_specs(cfg: ModelConfig, mesh):
    sdefs = adafactor_state_defs(T.param_defs(cfg))
    return abstract_params(sdefs), shardings_for(sdefs, mesh)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh):
    cdefs = T.cache_defs(cfg, batch, max_len)
    return abstract_params(cdefs), shardings_for(cdefs, mesh)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Everything the shape's step function takes, as (meta tensors,
    shardings): {"args": tuple, "shardings": tuple, "kind": str}."""
    p_abs, p_sh = param_specs(cfg, mesh)
    if shape.kind == "train":
        o_abs, o_sh = opt_specs(cfg, mesh)
        b_abs, b_sh = batch_specs(cfg, shape.global_batch, shape.seq_len,
                                  mesh, labels=True)
        return {"kind": "train",
                "args": (p_abs, o_abs, b_abs),
                "shardings": (p_sh, o_sh, b_sh)}
    if shape.kind == "prefill":
        b_abs, b_sh = batch_specs(cfg, shape.global_batch, shape.seq_len,
                                  mesh, labels=False)
        return {"kind": "prefill",
                "args": (p_abs, b_abs),
                "shardings": (p_sh, b_sh)}
    # decode: one new token against a cache of shape.seq_len
    B = shape.global_batch
    c_abs, c_sh = cache_specs(cfg, B, shape.seq_len, mesh)
    tok = _meta((B, 1), "int32")
    tok_sh = logical_sharding((B, 1), ("batch", None), mesh)
    lens = _meta((B,), "int32")
    lens_sh = logical_sharding((B,), ("batch",), mesh)
    return {"kind": "decode",
            "args": (p_abs, tok, c_abs, lens),
            "shardings": (p_sh, tok_sh, c_sh, lens_sh)}
