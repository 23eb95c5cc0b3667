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

The reference also fills keys that only XLA's compiler gives:
``memory`` (``memory_analysis``: temporaries, outputs, aliasing),
``cost_raw``, ``flops_hlo`` and ``bytes_hlo`` (``cost_analysis``) and
``collective_bytes`` (parsed from the optimized HLO by ``launch/hlo.py``).
Nothing in PyTorch produces them; each record names them under
``not_filled``. A record names the step function its kind lowers to
(``launch/steps.py``: ``train_step``, ``prefill_step``, ``serve_step``).

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
import os

import numpy as np

from repro_torch.configs import ASSIGNED, applicable_shapes, get_arch, get_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.steps import step_fn_for, train_microbatches
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves
from repro_torch.sharding.axes import _active_profile, local_shape, set_profile

NOT_FILLED = ("memory", "cost_raw", "flops_hlo", "bytes_hlo",
              "collective_bytes")


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


def run_cell(arch: str, shape_name: str, mesh_name: str, overrides=None,
             microbatches=None) -> dict:
    cfg = _apply_overrides(get_arch(arch), overrides)
    token = set_profile(cfg.rules_profile)
    try:
        shape = get_shape(shape_name)
        mesh = _mesh_for(mesh_name)
        p = T.superblock_period(cfg)
        spec = input_specs(cfg, shape, mesh)
        names = {"train": ("params", "opt_state", "batch"),
                 "prefill": ("params", "batch"),
                 "decode": ("params", "tokens", "cache", "lengths")}
        per = {n: rank_bytes(a, s) for n, a, s in zip(
            names[spec["kind"]], spec["args"], spec["shardings"])}
    finally:
        _active_profile.reset(token)
    mb = train_microbatches(arch) if spec["kind"] == "train" else 1
    if microbatches is not None:
        mb = microbatches
    step = step_fn_for(cfg, spec["kind"], device="meta", microbatches=mb)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": mesh.size, "n_super": cfg.num_layers // p, "period": p,
           "kind": spec["kind"], "step": step.__name__, "microbatches": mb,
           "bytes_per_rank": dict(per, total=sum(per.values())),
           "not_filled": list(NOT_FILLED), "ok": True}
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
        b = rec["bytes_per_rank"]
        print(f"[{arch} {shape} {mesh}] kind={rec['kind']} chips="
              f"{rec['chips']} per rank: " + " ".join(
                  f"{k}={v / 2**30:.3f}GiB" for k, v in b.items()))
        if path:
            os.makedirs(args.out, exist_ok=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    return out


if __name__ == "__main__":
    main()
