"""Multi-pod dry run of the port: the copy of ``repro/launch/dryrun.py``
that the port can fill.

For every (architecture x input shape x mesh) cell of ``cell_list``, each
rank's bytes of parameters, optimizer state (Adafactor's, as the
reference's train step), KV cache or recurrent state, and batch on the
production meshes -- (16, 16) single pod, (2, 16, 16) multi-pod -- from
``launch/specs.py``'s meta tensors and the logical rules' specs: nothing
is allocated and no rank is needed. A leaf's per-rank bytes are its shard
shape's, so the sum is what the reference's resident layout puts on one
device.

The keys the reference takes from XLA's compiler are counted on meta
tensors: rank 0 of the production mesh (``Mesh(shape, axes, rank=0)``)
runs its step (``launch/steps.py``: ``train_step``, ``prefill_step``,
``serve_step``, named in the record) under ``use_mesh`` on the port's own
layout -- the rank's resident parameters and optimizer state
(``local_defs`` with ``resident_axes``: the tensor-parallel shards), its
rows of the batch and of the cache -- inside ``launch/cost.py``'s
``CostCounter``. The kernels' wrappers give their outputs' shapes and
their formulas, the collectives record themselves; nothing is allocated
and no process group is needed. Each count of the rank is multiplied by
``chips``, as the reference scales its per-device SPMD module:

* ``flops_hlo``, ``flops_dot``, ``bytes_hlo`` and ``collective_bytes``
  (``launch/hlo.py``) -- the reference's loop-free twin
  (``_cost_variant``: remat off, no sequence chunking, one microbatch),
  the whole count of flops, the dot class alone (the kernels' terms by
  the reference's formulation), and every op's bytes unfused (above
  XLA's fused "bytes accessed");
* ``cost_raw`` -- the production config's step (remat, chunking, the
  microbatches), counted in full: remat's recomputation included, where
  the reference's ``cost_analysis`` counts a loop body once, so the two
  are not comparable;
* ``memory`` -- ``argument_bytes`` (the traced rank's resident
  arguments), ``alias_bytes`` (of those, the ones the reference donates:
  params and optimizer state of a train step, the cache of a decode
  step), ``output_bytes`` and ``temp_bytes`` (the peak of the step's
  live temporaries) of the production step.

A step is traced at 1 and 2 superblocks and extended to ``n_super``
(``hlo.extrapolate``, exact where the count is affine in depth). A
rank's rows that its microbatches do not divide run ``gcd(rows, mb)``
of them (``rank_microbatches``). ``memory.code_bytes`` is the one key no
PyTorch run produces (``not_filled``). ``bytes_per_rank`` stays the
reference's resident layout, from the rule table's specs; where the
port's layout keeps more on a rank (a vocabulary or KV heads that 'model'
does not divide stay whole), ``memory.argument_bytes`` shows the port's.

As in the reference, ``--set key=value`` (repeatable) overrides a field
of the config before the rules profile is set (``--set kv_dtype=int8``
changes the cache's bytes), ``--microbatches`` the train cells'
accumulation depth, ``--tag`` adds ``__{tag}`` to a single cell's file
name, which records its ``overrides``, and ``--all --skip-done`` skips a
cell whose file says ``ok``.

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
      [--set kv_dtype=int8 --tag int8] [--microbatches 4] [--out DIR]
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out DIR]
      [--skip-done]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.configs import ASSIGNED, applicable_shapes, get_arch, get_shape
from repro_torch.launch import hlo
from repro_torch.launch.cost import CostCounter, nbytes
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.specs import batch_specs, input_specs
from repro_torch.launch.steps import step_fn_for, train_microbatches
from repro_torch.models import transformer as T
from repro_torch.models.params import (abstract_params, local_defs,
                                       resident_axes, tree_leaves)
from repro_torch.optim.adafactor import adafactor_state_defs
from repro_torch.sharding.axes import (_active_profile, local_shape,
                                       set_profile, use_mesh)

NOT_FILLED = ("memory.code_bytes",)
# the arguments the reference's jit donates (``_compile_cell``)
DONATE = {"train": (0, 1), "prefill": (), "decode": (2,)}
_COUNTS = ("flops", "flops_dot", "bytes", "temp_bytes", "output_bytes")


def _mesh_for(name: str):
    return make_production_mesh(multi_pod=(name == "multi"))


def rank_bytes(abstract, shardings) -> int:
    """Bytes of one rank's shards of a tree of meta tensors."""
    total = 0
    for t, sh in zip(tree_leaves(abstract), tree_leaves(shardings)):
        shape = local_shape(tuple(t.shape), sh.spec, sh.mesh)
        total += int(np.prod(shape, dtype=np.int64)) * t.element_size()
    return total


def _apply_overrides(cfg, overrides):
    """--set key=value pairs -> ``dataclasses.replace``, each value parsed
    as the field's current type (a bool from 1/true/yes), as the
    reference's ``_apply_overrides``."""
    if not overrides:
        return cfg
    kw = {}
    for kv in overrides:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        kw[k] = v
    return dataclasses.replace(cfg, **kw)


def _cost_variant(cfg, kind: str):
    """Loop-free twin: layers unrolled; sequence scans single-iteration
    (the reference's ``_cost_variant``)."""
    kw = dict(scan_layers=False, remat="none")
    if kind in ("train", "prefill"):
        kw.update(chunk_q=10**9, chunk_kv=10**9, ssm_chunk=10**9)
    return dataclasses.replace(cfg, **kw)


def _rows(t: torch.Tensor, sharding) -> torch.Tensor:
    """A batch leaf's rows on one rank: dim 0 cut as its spec cuts it."""
    spec = (sharding.spec[0],) + (None,) * (t.dim() - 1)
    return t.new_empty(local_shape(tuple(t.shape), spec, sharding.mesh))


def rank_args(cfg, shape, mesh, kind: str) -> tuple:
    """Rank ``mesh.rank``'s step arguments as meta tensors, on the port's
    layout: params, optimizer state and cache cut to their resident
    shards (the cache's rows too), the batch, tokens and lengths to the
    rank's rows."""
    res = resident_axes(cfg)
    defs = T.param_defs(cfg)
    params = abstract_params(local_defs(defs, mesh, res))
    if kind == "train":
        b, sh = batch_specs(cfg, shape.global_batch, shape.seq_len, mesh,
                            labels=True)
        opt = abstract_params(local_defs(adafactor_state_defs(defs), mesh,
                                         res))
        return params, opt, {k: _rows(b[k], sh[k]) for k in b}
    if kind == "prefill":
        b, sh = batch_specs(cfg, shape.global_batch, shape.seq_len, mesh,
                            labels=False)
        return params, {k: _rows(b[k], sh[k]) for k in b}
    B = shape.global_batch
    cache = abstract_params(local_defs(T.cache_defs(cfg, B, shape.seq_len),
                                       mesh, res + ("batch",)))
    spec = input_specs(cfg, dataclasses.replace(shape, seq_len=1), mesh)
    _, tok, _, lens = spec["args"]
    _, tok_sh, _, lens_sh = spec["shardings"]
    return params, _rows(tok, tok_sh), cache, _rows(lens, lens_sh)


def count_step(cfg, shape, mesh, kind: str, microbatches: int = 1) -> dict:
    """One run of rank ``mesh.rank``'s step on meta tensors under a
    ``CostCounter``: its counts (``CostCounter.summary``)."""
    args = rank_args(cfg, shape, mesh, kind)
    step = step_fn_for(cfg, kind, device="meta", microbatches=microbatches)
    with use_mesh(mesh), CostCounter(args) as c:
        out = step(*args)
    c.finish(out)
    return c.summary()


def _at_depth(cfg, n: int):
    return dataclasses.replace(cfg,
                               num_layers=n * T.superblock_period(cfg))


def result_bytes(records) -> dict:
    """{opcode: the per-device result bytes of a rank's collectives}."""
    out: dict = {}
    for r in records:
        out[r["op"]] = out.get(r["op"], 0) + r["result_bytes"]
    return out


def count_cell(cfg, shape, mesh, kind: str, microbatches: int = 1) -> dict:
    """``count_step`` at ``cfg``'s depth, from traces at 1 and 2
    superblocks (``hlo.extrapolate``): the counts, and each collective
    op's per-device result bytes a step (``ops``)."""
    n_super = cfg.num_layers // T.superblock_period(cfg)
    one = count_step(_at_depth(cfg, 1), shape, mesh, kind, microbatches)
    two = one if n_super == 1 else count_step(_at_depth(cfg, 2), shape,
                                              mesh, kind, microbatches)
    out = {key: int(hlo.extrapolate(one[key], two[key], n_super))
           for key in _COUNTS}
    a, b = result_bytes(one["collectives"]), result_bytes(two["collectives"])
    out["ops"] = {op: hlo.extrapolate(a.get(op, 0), b.get(op, 0), n_super)
                  for op in {**a, **b}}
    return out


def run_cell(arch: str, shape_name: str, mesh_name: str, overrides=None,
             microbatches=None) -> dict:
    t0 = time.time()
    cfg = _apply_overrides(get_arch(arch), overrides)
    token = set_profile(cfg.rules_profile)
    try:
        shape = get_shape(shape_name)
        mesh = _mesh_for(mesh_name)
        p = T.superblock_period(cfg)
        spec = input_specs(cfg, shape, mesh)
        kind = spec["kind"]
        names = {"train": ("params", "opt_state", "batch"),
                 "prefill": ("params", "batch"),
                 "decode": ("params", "tokens", "cache", "lengths")}
        per = {n: rank_bytes(a, s) for n, a, s in zip(
            names[kind], spec["args"], spec["shardings"])}
        mb = train_microbatches(arch) if kind == "train" else 1
        if microbatches is not None:
            mb = microbatches
        rank = Mesh(mesh.devices.shape, mesh.axis_names, rank=0)
        args = rank_args(cfg, shape, rank, kind)
        rows = tree_leaves(args[-1])[0].shape[0] if kind == "train" else 1
        rank_mb = math.gcd(rows, mb)
        chips = mesh.size
        twin = count_cell(_cost_variant(cfg, kind), shape, rank, kind)
        # the port's step reads no chunk size and has no loops to unroll:
        # the production step differs from the twin only in a train step's
        # remat and microbatches
        proof = twin if kind != "train" or (
            cfg.remat == "none" and rank_mb == 1) else \
            count_cell(cfg, shape, rank, kind, rank_mb)
    finally:
        _active_profile.reset(token)
    step = step_fn_for(cfg, kind, device="meta", microbatches=mb)
    arg_bytes = [nbytes(*tree_leaves(a)) for a in args]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "n_super": cfg.num_layers // p, "period": p,
           "kind": kind, "step": step.__name__, "microbatches": mb,
           "rank_microbatches": rank_mb,
           "bytes_per_rank": dict(per, total=sum(per.values())),
           "memory": {"argument_bytes": sum(arg_bytes),
                      "output_bytes": proof["output_bytes"],
                      "temp_bytes": proof["temp_bytes"],
                      "alias_bytes": sum(arg_bytes[i]
                                         for i in DONATE[kind])},
           "cost_raw": {"flops": float(proof["flops"]) * chips,
                        "bytes": float(proof["bytes"]) * chips},
           "flops_hlo": float(twin["flops"]) * chips,
           "flops_dot": float(twin["flops_dot"]) * chips,
           "bytes_hlo": float(twin["bytes"]) * chips,
           "collective_bytes": hlo.collective_bytes(
               [{"op": op, "result_bytes": b}
                for op, b in twin["ops"].items()], chips),
           "not_filled": list(NOT_FILLED), "ok": True,
           "trace_s": round(time.time() - t0, 2)}
    return rec


def cell_list(mesh_mode: str):
    cells = []
    for arch in ASSIGNED:
        cfg = get_arch(arch)
        for shape in applicable_shapes(cfg):
            for mesh in (("single", "multi") if mesh_mode == "both"
                         else (mesh_mode,)):
                cells.append((arch, shape.name, mesh))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write one JSON a cell into this directory")
    ap.add_argument("--skip-done", action="store_true",
                    help="with --all: skip a cell whose file says ok")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="config override key=value (repeatable)")
    ap.add_argument("--tag", default="",
                    help="a single cell's file name suffix")
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args(argv)
    # the reference's --all runs each cell as it is: its overrides, tag
    # and microbatches reach a single cell only
    single = not args.all
    cells = cell_list(args.mesh) if args.all else [
        (args.arch, args.shape, m) for m in
        (("single", "multi") if args.mesh == "both" else (args.mesh,))]
    suffix = f"__{args.tag}" if args.tag and single else ""
    out = []
    for arch, shape, mesh in cells:
        path = None if not args.out else os.path.join(
            args.out, f"{arch}__{shape}__{mesh}{suffix}.json")
        if args.all and args.skip_done and path and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    print(f"[skip] {arch} {shape} {mesh}")
                    continue
        rec = run_cell(arch, shape, mesh,
                       args.overrides if single else None,
                       args.microbatches if single else None)
        if single:
            rec["overrides"] = args.overrides
        out.append(rec)
        b, mem = rec["bytes_per_rank"], rec["memory"]
        print(f"[{arch} {shape} {mesh}] kind={rec['kind']} chips="
              f"{rec['chips']} per rank: " + " ".join(
                  f"{k}={v / 2**30:.3f}GiB" for k, v in b.items()))
        print(f"  memory/rank: args={mem['argument_bytes'] / 2**30:.3f}GiB "
              f"temp={mem['temp_bytes'] / 2**30:.3f}GiB "
              f"out={mem['output_bytes'] / 2**30:.3f}GiB "
              f"alias={mem['alias_bytes'] / 2**30:.3f}GiB")
        print(f"  flops_hlo={rec['flops_hlo']:.3e} "
              f"flops_dot={rec['flops_dot']:.3e} "
              f"bytes_hlo={rec['bytes_hlo']:.3e} collective="
              f"{rec['collective_bytes']['total']:.3e}B "
              f"({rec['trace_s']} s)", flush=True)
        if path:
            os.makedirs(args.out, exist_ok=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    return out


if __name__ == "__main__":
    main()
