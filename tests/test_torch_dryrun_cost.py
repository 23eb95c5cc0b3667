"""The dry run's cost analysis (``launch/cost.py``, ``launch/hlo.py``, the
meta routes of ``kernels/ops.py`` and ``sharding/comm.py``) against the
reference, on the CPU.

* ``flops_dot``: for one config of each family at ``.reduced()`` size on
  a 1 x 1 mesh, each kind its shapes have (train, prefill, decode), the
  port's count of the loop-free twin's step on meta tensors equals the
  reference's: ``jax.make_jaxpr`` of its ``step_fn_for`` on its
  ``_cost_variant``, 2 x prod(out) x prod(contracting dims) summed over
  every ``dot_general``, a ``scan`` body times its length. One quirk of
  the count is held by its size: rwkv6-7b's decode step adds the bonus
  term r.(u k) v with a multiply and a sum, which the reference writes as
  a three-operand einsum that XLA lowers to two ``dot_general`` (2 B H
  (K + V) flops a layer).
* A run on the CPU (the kernels' plain versions, muted under their
  formulas) counts the meta trace's ``flops_dot``.
* Extrapolation: the count from 1 and 2 superblocks equals the trace at
  the whole reduced depth, flops, dot flops, bytes and collectives.
* Collectives: on 2 gloo ranks, a meta rank records the collectives of
  the executed step -- kinds, counts and payload bytes of ``comm.STATS``
  -- for a (1, 2) tensor-parallel decode step and a (2, 1) data-parallel
  train step of llama3.2-1b ``.reduced()``, and ``collective_bytes``
  applies the reference's ring factors to them.
* Memory: ``alias_bytes`` follows the reference's donate map and
  ``argument_bytes`` is the rank's resident bytes of ``local_defs``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import applicable_shapes, get_arch, get_shape
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, hlo
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.models.params import (DTYPES, local_defs, resident_axes,
                                       tree_leaves, tree_map)
from repro_torch.optim.adafactor import adafactor_state_defs
from repro_torch.sharding import comm
from repro_torch.sharding.axes import _active_profile, set_profile
from test_torch_multirank import _spawn

FAMILIES = ("llama3.2-1b", "qwen3-moe-30b-a3b", "rwkv6-7b",
            "jamba-v0.1-52b", "whisper-medium", "pixtral-12b")
B, S = 2, 64
ONE = Mesh((1, 1), ("data", "model"), rank=0)


def _kinds(arch):
    return sorted({s.kind for s in applicable_shapes(get_arch(arch))})


CASES = [(a, k) for a in FAMILIES for k in _kinds(a)]


# --------------------------------------------------------------------------- #
# the reference's dot_general count (jax is imported here only: the gloo
# ranks below import this module)
# --------------------------------------------------------------------------- #
def _subjaxprs(v):
    from jax.extend import core as jcore
    if isinstance(v, jcore.ClosedJaxpr):
        return [v.jaxpr]
    if isinstance(v, jcore.Jaxpr):
        return [v]
    if isinstance(v, (tuple, list)):
        return [j for x in v for j in _subjaxprs(x)]
    return []


def _dot_flops(jaxpr) -> int:
    total = 0
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            lhs = e.invars[0].aval.shape
            total += 2 * int(np.prod(e.outvars[0].aval.shape)) * int(
                np.prod([lhs[i] for i in lc]))
            continue
        subs = [j for v in e.params.values() for j in _subjaxprs(v)]
        assert e.primitive.name != "while", "a loop of unknown length"
        if e.primitive.name == "cond":
            total += max(_dot_flops(j) for j in subs)
            continue
        n = e.params["length"] if e.primitive.name == "scan" else 1
        total += n * sum(_dot_flops(j) for j in subs)
    return total


def _ref_dot_flops(arch: str, kind: str) -> int:
    """The reference's step on its loop-free twin at ``.reduced()`` size,
    on a 1 x 1 mesh: its jaxpr's dot flops."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from repro.configs import get_arch as jax_arch
    from repro.configs.base import ShapeSpec as JaxShape
    from repro.launch.specs import input_specs as jax_input_specs
    from repro.launch.steps import step_fn_for as jax_step_fn_for
    from repro.sharding import axes as JX
    cfg = jax_arch(arch).reduced()
    kw = dict(scan_layers=False, remat="none")
    if kind in ("train", "prefill"):
        kw.update(chunk_q=10**9, chunk_kv=10**9, ssm_chunk=10**9)
    cfg = dataclasses.replace(cfg, **kw)
    tok = JX.set_profile(cfg.rules_profile)
    try:
        mesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                       ("data", "model"))
        with mesh:
            spec = jax_input_specs(cfg, JaxShape("x", S, B, kind), mesh)
            jaxpr = jax.make_jaxpr(jax_step_fn_for(cfg, kind))(*spec["args"])
    finally:
        JX._active_profile.reset(tok)
    return _dot_flops(jaxpr.jaxpr)


def _port_count(cfg, kind: str, mesh=ONE, mb: int = 1) -> dict:
    tok = set_profile(cfg.rules_profile)
    try:
        return dryrun.count_step(cfg, ShapeSpec("x", S, B, kind), mesh, kind,
                                 mb)
    finally:
        _active_profile.reset(tok)


def _quirk(arch: str, kind: str) -> int:
    """rwkv6-7b's decode bonus: a multiply and a sum in the port, two
    ``dot_general`` in the reference (2 B H K and 2 B H V a layer)."""
    cfg = get_arch(arch).reduced()
    if cfg.family != "ssm" or kind != "decode":
        return 0
    K = V = cfg.rwkv_head_dim
    return 2 * B * cfg.num_heads * (K + V) * cfg.num_layers


@pytest.mark.parametrize("arch,kind", CASES)
def test_flops_dot_equals_the_references_dot_generals(arch, kind):
    cfg = dryrun._cost_variant(get_arch(arch).reduced(), kind)
    got = _port_count(cfg, kind)
    assert got["flops_dot"] == _ref_dot_flops(arch, kind) - _quirk(arch,
                                                                   kind)
    # the kernels' terms are part of it, one formula a call
    assert got["flops_dot"] > sum(k["flops_dot"]
                                  for k in got["kernels"].values()) > 0
    assert got["flops"] > got["flops_dot"] and got["bytes"] > 0


def _real(args, seed: int) -> tuple:
    """CPU tensors of the meta arguments' shapes and dtypes: small normal
    floats from a seed, zero integers."""
    gen = torch.Generator().manual_seed(seed)

    def one(t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    return tuple(tree_map(one, a) for a in args)


@pytest.mark.parametrize("arch,kind", [("llama3.2-1b", "train"),
                                       ("jamba-v0.1-52b", "prefill"),
                                       ("rwkv6-7b", "train")])
def test_a_cpu_run_counts_the_meta_traces_flops_dot(arch, kind):
    """The same step on CPU tensors (the plain versions run inside the
    wrappers, muted) counts what the meta trace counts, forward and
    backward."""
    cfg = get_arch(arch).reduced()
    meta = _port_count(cfg, kind)
    args = _real(dryrun.rank_args(cfg, ShapeSpec("x", S, B, kind), ONE,
                                  kind), 0)
    from repro_torch.launch.steps import step_fn_for
    with CostCounter(args) as c:
        out = step_fn_for(cfg, kind, device="cpu")(*args)
    c.finish(out)
    assert c.flops_dot == meta["flops_dot"]
    assert {k: v["calls"] for k, v in c.kernels.items()} == \
        {k: v["calls"] for k, v in meta["kernels"].items()}


@pytest.mark.parametrize("arch,kind,shape", [
    ("llama3.2-1b", "train", (1, 2)), ("jamba-v0.1-52b", "prefill", (1, 1)),
    ("rwkv6-7b", "decode", (2, 2)), ("qwen3-moe-30b-a3b", "train", (2, 1))])
def test_extrapolation_equals_the_whole_trace(arch, kind, shape):
    """``count_cell`` from 1 and 2 superblocks equals the trace at the
    whole depth (3 superblocks), on a meta rank of a small mesh."""
    base = get_arch(arch).reduced()
    cfg = dataclasses.replace(base,
                              num_layers=3 * T.superblock_period(base))
    mesh = Mesh(shape, ("data", "model"), rank=0)
    sh = ShapeSpec("x", S, 4, kind)
    tok = set_profile(cfg.rules_profile)
    try:
        whole = dryrun.count_step(cfg, sh, mesh, kind, 2 if kind == "train"
                                  else 1)
        ext = dryrun.count_cell(cfg, sh, mesh, kind, 2 if kind == "train"
                                else 1)
    finally:
        _active_profile.reset(tok)
    for key in ("flops", "flops_dot", "bytes", "output_bytes"):
        assert ext[key] == whole[key], key
    assert ext["ops"] == dryrun.result_bytes(whole["collectives"])
    assert bool(ext["ops"]) == (shape != (1, 1))


def test_hlo_helpers_follow_the_references():
    recs = [{"op": "all-reduce", "result_bytes": 10},
            {"op": "all-gather", "result_bytes": 6},
            {"op": "all-reduce", "result_bytes": 1}]
    assert hlo.collective_bytes(recs, 4) == {
        "all-reduce": 88.0, "all-gather": 24.0, "total": 112.0}
    assert hlo.extrapolate(3.0, 5.0, 4) == 9.0
    assert hlo.extrapolate(3.0, 2.0, 4) == 3.0


# --------------------------------------------------------------------------- #
# memory
# --------------------------------------------------------------------------- #
def _def_bytes(defs) -> int:
    return sum(int(np.prod(pd.shape)) * DTYPES[pd.dtype].itemsize
               for pd in tree_leaves(defs))


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_memory_follows_the_donate_map_and_local_defs(shape_name):
    """llama3.2-1b on the (16, 16) mesh: ``argument_bytes`` is rank 0's
    resident bytes (``local_defs`` of params, Adafactor's state and the
    cache with its rows; the batch's rows), ``alias_bytes`` the donated
    ones (train: params and state; decode: the cache; prefill: none)."""
    rec = dryrun.run_cell("llama3.2-1b", shape_name, "single")
    cfg, shape = get_arch("llama3.2-1b"), get_shape(shape_name)
    mesh = dryrun._mesh_for("single")
    res = resident_axes(cfg)
    tok = set_profile(cfg.rules_profile)
    try:
        params = _def_bytes(local_defs(T.param_defs(cfg), mesh, res))
        opt = _def_bytes(local_defs(adafactor_state_defs(T.param_defs(cfg)),
                                    mesh, res))
        cache = _def_bytes(local_defs(T.cache_defs(
            cfg, shape.global_batch, shape.seq_len), mesh, res + ("batch",)))
    finally:
        _active_profile.reset(tok)
    rows = shape.global_batch // 16
    mem = rec["memory"]
    want = {"train": (params + opt + 2 * rows * shape.seq_len * 4,
                      params + opt),
            "prefill": (params + rows * shape.seq_len * 4, 0),
            "decode": (params + cache + 2 * rows * 4, cache)}[rec["kind"]]
    assert (mem["argument_bytes"], mem["alias_bytes"]) == want
    # the step returns what it donates (and the loss, or the logits)
    if rec["kind"] == "train":
        assert mem["output_bytes"] == params + opt + 4
    if rec["kind"] == "decode":
        assert mem["output_bytes"] == cache + rows * (cfg.vocab_size // 16) * 2
    assert mem["temp_bytes"] > 0
    # llama's parameters lie on a rank of 16 as the reference's rules put
    # them (the 8 KV heads whole in both)
    assert params == rec["bytes_per_rank"]["params"]


# --------------------------------------------------------------------------- #
# collectives on 2 gloo ranks
# --------------------------------------------------------------------------- #
COLL_CASES = {"tp_decode": ((1, 2), "decode"), "dp_train": ((2, 1), "train")}


def _by_kind(stats) -> dict:
    return {k: (v["calls"], v["bytes"]) for k, v in stats["by_kind"].items()}


def _collective_rank(rank, world, tmp):
    import json

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import step_fn_for
    from repro_torch.sharding.axes import use_mesh
    cfg = get_arch("llama3.2-1b").reduced()
    out = {}
    for name, ((data, model), kind) in COLL_CASES.items():
        mesh = make_host_mesh(model=model, data=data)
        sh = ShapeSpec("x", S, 4, kind)
        args = _real(dryrun.rank_args(cfg, sh, mesh, kind), rank)
        if kind == "decode":
            args = args[:3] + (torch.full(args[3].shape, 5, dtype=torch.int32),)
        comm.reset_stats()
        with use_mesh(mesh):
            step_fn_for(cfg, kind, device="cpu")(*args)
        live = _by_kind(comm.stats())
        comm.reset_stats()
        meta = dryrun.count_step(cfg, sh, Mesh((data, model),
                                               ("data", "model"), rank=rank),
                                 kind)
        out[name] = json.dumps({"live": live, "meta": _by_kind(comm.stats()),
                                "records": meta["collectives"]})
    return out


def test_a_meta_rank_records_the_executed_steps_collectives(tmp_path):
    import json
    ranks = _spawn(_collective_rank, 2, tmp_path)
    for name in COLL_CASES:
        for r in ranks:
            got = json.loads(str(r[name]))
            assert got["meta"] == got["live"] and got["live"], name
            recs = got["records"]
            assert len(recs) == sum(n for n, _ in got["live"].values())
            # per-device result bytes: a sum's payload, a gather's n parts
            payload = {"all-reduce": 0, "all-gather": 0}
            for rec in recs:
                payload[rec["op"]] += rec["result_bytes"] // (
                    2 if rec["op"] == "all-gather" else 1)
            assert sum(payload.values()) == sum(
                b for _, b in got["live"].values())
            cb = hlo.collective_bytes(recs, 2)
            assert cb["total"] == 2 * (2.0 * payload["all-reduce"]
                                       + 2 * payload["all-gather"])
        kinds = set(json.loads(str(ranks[0][name]))["live"])
        assert kinds == ({"psum"} if name == "tp_decode"
                         else {"psum", "metrics"}), (name, kinds)
