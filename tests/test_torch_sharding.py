"""The port's sharding rules, meshes, shapes, specs and dry run against
the reference's, in one process on the CPU (no ranks: rules resolve on
the mesh's axis names and sizes alone, as the reference's tests resolve
them on ``_FakeMesh``): the dry run's per-rank bytes, its ``--set``
overrides (parsed as the reference parses them; ``kv_dtype=int8`` sets
the cache's bytes), ``--tag``, ``--microbatches`` and ``--skip-done``,
and the serve step its decode cells name against the reference's.

Also: ``local_slice`` / ``gather_slices``, ``assert_unified_layout``'s
stats at (1, 1), the decode kernel's plain version in its partial mode,
and the train step with ``compress_grads`` and no mesh (it compresses
nothing, as the reference's).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable_shapes as jax_applicable_shapes
from repro.configs import get_arch as jax_arch
from repro.models import transformer as RT
from repro.sharding import axes as JX
from repro_torch.configs import (ASSIGNED, SHAPES, applicable_shapes,
                                 get_arch, get_shape)
from repro_torch.kernels import ref
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.params import (abstract_params, init_params,
                                       is_def, local_defs, shard_tree,
                                       shardings_for, tree_leaves, tree_map)
from repro_torch.sharding import axes as X


class _FakeMesh:
    """Rule-resolution-only mesh stand-in (no devices needed), as the
    reference's ``tests/test_sharding.py`` builds it."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


PROD = {"single": {"data": 16, "model": 16},
        "multi": {"pod": 2, "data": 16, "model": 16}}


def _jax_leaves(tree):
    from repro.models.params import is_def as jax_is_def
    return [x for x in jax.tree.leaves(tree, is_leaf=jax_is_def)
            if jax_is_def(x)]


def _specs(defs_port, defs_ref, mesh):
    port = [X.logical_spec(pd.shape, pd.logical_axes, mesh)
            for pd in tree_leaves(defs_port) if is_def(pd)]
    want = [tuple(JX.logical_spec(pd.shape, pd.logical_axes, mesh))
            for pd in _jax_leaves(defs_ref)]
    return port, want


# --------------------------------------------------------------------------- #
# the rule table
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("profile", ["tp", "dp"])
@pytest.mark.parametrize("mesh_name", sorted(PROD))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_logical_spec_matches_the_reference_on_every_leaf(arch, mesh_name,
                                                          profile):
    """Every leaf of ``param_defs`` and of ``cache_defs`` at decode_32k's
    batch and length, on the production meshes, under both profiles."""
    mesh = _FakeMesh(PROD[mesh_name])
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    tok, jtok = X.set_profile(profile), JX.set_profile(profile)
    try:
        for port_defs, ref_defs in (
                (T.param_defs(cfg), RT.param_defs(jcfg)),
                (T.cache_defs(cfg, 128, 32768),
                 RT.cache_defs(jcfg, 128, 32768))):
            port, want = _specs(port_defs, ref_defs, mesh)
            assert len(port) == len(want) > 0
            assert port == want
    finally:
        X._active_profile.reset(tok)
        JX._active_profile.reset(jtok)


def test_rule_tables_and_profiles_are_the_references():
    assert X.LOGICAL_RULES == JX.LOGICAL_RULES
    assert X.PROFILES == JX.PROFILES
    assert X.active_rules() == JX.active_rules()


def test_extent1_axes_drop():
    spec = X.logical_spec((8, 16), ("batch", "heads"), make_host_mesh())
    assert spec == (None, None)   # extent-1 axes never shard


def test_divisibility_fallback():
    m = _FakeMesh({"data": 16, "model": 16})
    spec = X.logical_spec((128, 8, 32768, 64),
                          ("batch", "kv_heads", "kv_seq", "head_dim"), m)
    assert spec[1] is None
    assert spec[2] == "model"


def test_kv_heads_claim_model_when_divisible():
    m = _FakeMesh({"data": 16, "model": 16})
    spec = X.logical_spec((128, 16, 32768, 64),
                          ("batch", "kv_heads", "kv_seq", "head_dim"), m)
    assert spec[0] == "data" and spec[1] == "model"
    assert spec[2] is None


def test_batch_frees_data_for_seq_when_not_divisible():
    m = _FakeMesh({"data": 16, "model": 16})
    spec = X.logical_spec((1, 8, 524288, 64),
                          ("batch", "kv_heads", "kv_seq", "head_dim"), m)
    assert spec[0] is None
    assert spec[2] == "model"


def test_multipod_batch_uses_both_axes():
    m = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    spec = X.logical_spec((256, 4096), ("batch", "seq"), m)
    assert spec[0] == ("pod", "data")


def test_no_axis_used_twice():
    m = _FakeMesh({"data": 16, "model": 16})
    spec = X.logical_spec((256, 384, 7168, 2048),
                          ("batch", "experts", "fsdp", "d_ff"), m)
    used = []
    for s in spec:
        if s is None:
            continue
        used.extend(s if isinstance(s, tuple) else [s])
    assert len(used) == len(set(used))
    assert spec[1] == "model" and spec[0] == "data"
    assert spec[2] is None


def test_fsdp_weights_shard_both_axes():
    m = _FakeMesh({"data": 16, "model": 16})
    spec = X.logical_spec((384, 7168, 2048), ("experts", "fsdp", "d_ff"), m)
    assert spec[0] == "model" and spec[1] == "data"


def test_the_port_mesh_and_the_fake_mesh_resolve_alike():
    port, fake = make_production_mesh(multi_pod=True), \
        _FakeMesh(PROD["multi"])
    for shape, axes in (((256, 4096), ("batch", "seq")),
                        ((384, 7168, 2048), ("experts", "fsdp", "d_ff"))):
        assert X.logical_spec(shape, axes, port) == \
            X.logical_spec(shape, axes, fake)


def test_constrain_returns_its_input():
    x = torch.arange(6.0).reshape(2, 3)
    assert X.constrain(x, ("batch", "d_model"),
                       make_production_mesh()) is x


def test_use_mesh_sets_the_current_mesh():
    mesh = make_host_mesh()
    assert X._current_mesh() is None
    with X.use_mesh(mesh):
        assert X._current_mesh() is mesh
        with X.use_mesh(None):
            assert X._current_mesh() is None
        assert X._current_mesh() is mesh
    assert X._current_mesh() is None


# --------------------------------------------------------------------------- #
# meshes, parts and shapes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("multi,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model")),
])
def test_production_meshes_have_the_references_shapes(multi, shape, names):
    """The reference's ``launch/mesh.py``: (16, 16) as (data, model), or
    (2, 16, 16) with 'pod' in front; no ranks behind them."""
    m = make_production_mesh(multi_pod=multi)
    assert m.devices.shape == shape and m.axis_names == names
    assert m.rank is None and m.size == int(np.prod(shape))
    assert X.axis_sizes(m) == dict(zip(names, shape))


def test_host_mesh_without_a_process_group_is_one_rank():
    m = make_host_mesh()
    assert (m.devices.shape, m.axis_names, m.rank) == \
        ((1, 1), ("data", "model"), 0)
    assert m.coords() == {"data": 0, "model": 0}
    with pytest.raises(ValueError):
        make_host_mesh(model=2)


def test_local_slices_gather_back_to_the_full_tensor():
    mesh = Mesh((2, 3), ("data", "model"))
    x = torch.arange(4 * 6 * 5, dtype=torch.float32).reshape(4, 6, 5)
    for spec in (("data", "model", None), (None, ("data", "model"), None),
                 (None, "model", None)):
        parts = {}
        for r in range(mesh.size):
            c = mesh.coords(r)
            parts[(c["data"], c["model"])] = X.local_slice(x, spec, mesh, c)
        assert tuple(parts[0, 0].shape) == X.local_shape(x.shape, spec, mesh)
        assert torch.equal(X.gather_slices(parts, spec, mesh), x)


def test_resident_layout_keeps_only_the_ports_sharded_dims():
    """Under (data 1, model 2): granite's KH-1 cache shards its sequence,
    qwen3-moe's EP experts split over 'model'; every weight of a dense
    layer stays whole."""
    mesh = Mesh((1, 2), ("data", "model"))
    g = get_arch("granite-20b").reduced()
    cdefs = local_defs(T.cache_defs(g, 4, 64), mesh, ("kv_seq",))
    assert cdefs["pos0"]["k"].shape == (2, 4, 1, 32, 16)
    pdefs = local_defs(T.param_defs(g), mesh, ("kv_seq",))
    assert [pd.shape for pd in tree_leaves(pdefs)] == \
        [pd.shape for pd in tree_leaves(T.param_defs(g))]
    q = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(),
                            moe_impl="ep")
    defs = T.param_defs(q)
    local = local_defs(defs, mesh, ("experts", "fsdp"))
    wi = local["blocks"]["pos0"]["ffn"]["wi"]
    assert wi.shape[1] == q.num_experts // 2
    full = init_params(defs, device="cpu", seed=0)
    mesh.rank = 1
    part = shard_tree(full, defs, mesh, ("experts", "fsdp"))
    got = part["blocks"]["pos0"]["ffn"]["wi"]
    assert torch.equal(got, full["blocks"]["pos0"]["ffn"]["wi"][
        :, q.num_experts // 2:])


def test_shapes_match_the_reference_field_for_field():
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(JAX_SHAPES[name])
        assert s.is_decode == JAX_SHAPES[name].is_decode
        assert get_shape(name) == s
    with pytest.raises(KeyError):
        get_shape("train_1m")
    assert ASSIGNED == JAX_ASSIGNED
    for arch in ASSIGNED:
        assert [s.name for s in applicable_shapes(get_arch(arch))] == \
            [s.name for s in jax_applicable_shapes(jax_arch(arch))]


def test_unified_layout_stats_match_the_reference():
    """``assert_unified_layout`` on llama3.2-1b .reduced() at (1, 1): the
    reference's byte stats."""
    from repro.core.unified_memory import \
        assert_unified_layout as jax_unified
    from repro_torch.core.unified_memory import assert_unified_layout
    jmesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    for arch in ("llama3.2-1b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b"):
        got = assert_unified_layout(
            T.param_defs(get_arch(arch).reduced()), make_host_mesh())
        want = jax_unified(RT.param_defs(jax_arch(arch).reduced()), jmesh)
        assert got == want
        assert got["resharded_bytes"] == 0


# --------------------------------------------------------------------------- #
# specs and the dry run
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,shape", [
    ("llama3.2-1b", "train_4k"), ("whisper-medium", "prefill_32k"),
    ("pixtral-12b", "train_4k"), ("rwkv6-7b", "long_500k"),
    ("qwen3-moe-30b-a3b", "decode_32k"),
])
def test_input_specs_match_the_reference_at_one_by_one(arch, shape):
    """Shapes, dtypes and specs of every argument, at (1, 1); nothing is
    allocated (meta tensors)."""
    from repro.launch.specs import input_specs as jax_input_specs
    from repro_torch.launch.specs import input_specs
    jmesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    cfg, jcfg = get_arch(arch).reduced(), jax_arch(arch).reduced()
    got = input_specs(cfg, get_shape(shape), make_host_mesh())
    want = jax_input_specs(jcfg, JAX_SHAPES[shape], jmesh)
    assert got["kind"] == want["kind"]
    g_args = [t for a in got["args"] for t in tree_leaves(a)]
    w_args = jax.tree.leaves(want["args"])
    assert [tuple(t.shape) for t in g_args] == \
        [tuple(t.shape) for t in w_args]
    assert [str(t.dtype).replace("torch.", "") for t in g_args] == \
        [str(t.dtype) for t in w_args]
    assert all(t.device.type == "meta" for t in g_args)
    g_sh = [s.spec for a in got["shardings"] for s in tree_leaves(a)]
    w_sh = [tuple(s.spec) for s in jax.tree.leaves(want["shardings"])]
    assert len(g_sh) == len(w_sh)
    for g, w in zip(g_sh, w_sh):
        assert tuple(x for x in g if x is not None) == \
            tuple(x for x in w if x is not None)


def _shard_bytes(defs, mesh):
    """Bytes of one rank's shards of the reference's ParamDef tree under
    its own specs."""
    total = 0
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for pd in _jax_leaves(defs):
        spec = JX.logical_spec(pd.shape, pd.logical_axes, mesh)
        n = 1
        for shape_dim, e in zip(pd.shape, spec):
            div = 1
            for a in (() if e is None else (e,) if isinstance(e, str) else e):
                div *= sizes[a]
            n *= shape_dim // div
        total += n * jnp.dtype(pd.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape,mesh", [
    ("llama3.2-1b", "decode_32k", "single"),
    ("kimi-k2-1t-a32b", "train_4k", "multi"),
    ("jamba-v0.1-52b", "prefill_32k", "single"),
])
def test_dry_run_parameter_bytes_per_rank(arch, shape, mesh):
    """The dry run's per-rank parameter bytes against the sum of the shard
    shapes that the reference's specs imply, and the keys it names as
    unfilled."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape, mesh)
    tok = JX.set_profile(jax_arch(arch).rules_profile)
    try:
        want = _shard_bytes(RT.param_defs(jax_arch(arch)),
                            _FakeMesh(PROD[mesh]))
    finally:
        JX._active_profile.reset(tok)
    assert rec["bytes_per_rank"]["params"] == want
    assert rec["chips"] == (512 if mesh == "multi" else 256)
    assert set(rec["not_filled"]) >= {"memory", "flops_hlo",
                                      "collective_bytes"}


def test_dry_run_covers_every_cell():
    from repro_torch.launch import dryrun
    cells = dryrun.cell_list("both")
    assert len(cells) == 2 * sum(len(applicable_shapes(get_arch(a)))
                                 for a in ASSIGNED)
    rec = dryrun.run_cell("rwkv6-7b", "long_500k", "multi")
    assert rec["kind"] == "decode" and rec["bytes_per_rank"]["cache"] > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-20b"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_dry_run_overrides_set_the_cache_bytes(arch, kv_dtype):
    """``run_cell(..., overrides=["kv_dtype=..."])`` on a ``decode_32k``
    cell: a rank's cache bytes are the shard shapes of the reference's
    ``cache_defs`` on the overridden config (int8 codes and their f32
    scales), and its step is the serve step."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, "decode_32k", "single",
                          overrides=[f"kv_dtype={kv_dtype}"])
    shape = get_shape("decode_32k")
    jcfg = dataclasses.replace(jax_arch(arch), kv_dtype=kv_dtype)
    tok = JX.set_profile(jcfg.rules_profile)
    try:
        want = _shard_bytes(RT.cache_defs(jcfg, shape.global_batch,
                                          shape.seq_len),
                            _FakeMesh(PROD["single"]))
    finally:
        JX._active_profile.reset(tok)
    assert rec["bytes_per_rank"]["cache"] == want
    assert rec["kind"] == "decode" and rec["step"] == "serve_step"


def _jax_apply_overrides():
    """The reference's ``_apply_overrides``; its module sets XLA_FLAGS at
    import, so the backend comes up first and the variable is restored."""
    import os
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _apply_overrides
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _apply_overrides


@pytest.mark.parametrize("overrides", [
    ["scan_layers=false"], ["use_pallas=yes"], ["num_layers=3"],
    ["rope_theta=500000"], ["kv_dtype=int8"], ["remat=full"],
    ["kv_dtype=int8", "capacity_factor=2.0", "fsdp_params=1"]],
    ids=["bool", "bool_yes", "int", "float", "str", "remat", "several"])
def test_dry_run_override_parsing_matches_the_reference(overrides):
    """``--set`` of a bool, an int, a float and a string (and several at
    once) gives the reference's ``ModelConfig``, field for field."""
    from repro_torch.launch.dryrun import _apply_overrides
    got = _apply_overrides(get_arch("qwen3-moe-30b-a3b"), overrides)
    want = _jax_apply_overrides()(jax_arch("qwen3-moe-30b-a3b"), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _apply_overrides(get_arch("llama3.2-1b"), []) == \
        get_arch("llama3.2-1b")


def test_dry_run_command_line_tag_and_overrides(tmp_path):
    """``main`` with ``--tag`` and ``--set`` writes
    ``{arch}__{shape}__{mesh}__{tag}.json`` recording its overrides (the
    reference's name and key), ``--microbatches`` sets a train cell's
    depth, and the record without a tag has no suffix."""
    from repro_torch.launch import dryrun
    dryrun.main(["--arch", "granite-20b", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--tag", "t", "--set",
                 "kv_dtype=int8", "--set", "remat=full"])
    rec = json.loads((tmp_path / "granite-20b__decode_32k__single__t.json"
                      ).read_text())
    assert rec["overrides"] == ["kv_dtype=int8", "remat=full"]
    base = dryrun.run_cell("granite-20b", "decode_32k", "single")
    assert rec["bytes_per_rank"]["cache"] < base["bytes_per_rank"]["cache"]
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--out",
                 str(tmp_path), "--microbatches", "8"])
    rec = json.loads((tmp_path / "llama3.2-1b__train_4k__single.json"
                      ).read_text())
    assert rec["microbatches"] == 8 and rec["overrides"] == []
    assert rec["step"] == "train_step"


def test_dry_run_skip_done_skips_the_cells_that_are_ok(tmp_path):
    """``--all --skip-done`` runs only the cells whose file is missing or
    does not say ``ok``; the others' files stay as they were."""
    from repro_torch.launch import dryrun
    cells = dryrun.cell_list("single")
    for i, (arch, shape, mesh) in enumerate(cells[2:]):
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(
            json.dumps({"ok": True, "mark": i}))
    arch, shape, mesh = cells[1]
    (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(
        json.dumps({"ok": False}))
    out = dryrun.main(["--all", "--skip-done", "--out", str(tmp_path)])
    assert [(r["arch"], r["shape"], r["mesh"]) for r in out] == cells[:2]
    for i, (arch, shape, mesh) in enumerate(cells[2:]):
        assert json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json"
                           ).read_text()) == {"ok": True, "mark": i}
    arch, shape, mesh = cells[1]
    assert json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json"
                       ).read_text())["ok"]


def _np_trees(cfg, jcfg, seed):
    """The port's and the reference's trees of the same float32 leaves,
    drawn from a numpy seed in sorted-path order."""
    from repro.models.params import is_def as jax_is_def
    rng = np.random.default_rng(seed)
    leaves = []
    for pd in tree_leaves(T.param_defs(cfg)):
        if pd.init in ("ones", "zeros"):
            leaves.append(np.full(pd.shape, pd.init == "ones", np.float32))
        else:
            std = 0.5 if pd.init == "small_normal" else pd.fan_in() ** -0.5
            leaves.append((rng.standard_normal(pd.shape) * std
                           ).astype(np.float32))
    it = iter(leaves)
    port = tree_map(lambda pd: torch.from_numpy(next(it).copy()),
                    T.param_defs(cfg))
    _, treedef = jax.tree_util.tree_flatten(RT.param_defs(jcfg),
                                            is_leaf=jax_is_def)
    return port, jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in leaves])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-20b"])
def test_serve_step_matches_the_reference(arch):
    """``step_fn_for(cfg, "decode")``, the dry run's decode step: one
    token a row against a filled cache at ragged lengths, logits and every
    cache leaf against the reference's ``serve_step`` under ``jax.jit``,
    float32, within 1e-4."""
    from repro.launch.steps import step_fn_for as jax_step_fn_for
    from repro.models.params import is_def as jax_is_def
    from repro_torch.launch.steps import step_fn_for
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32")
    params, jparams = _np_trees(cfg, jcfg, 20)
    B, L = 3, 24
    rng = np.random.default_rng(21)
    cache_np = tree_map(lambda pd: rng.standard_normal(pd.shape).astype(
        np.float32), T.cache_defs(cfg, B, L))
    _, treedef = jax.tree_util.tree_flatten(RT.cache_defs(jcfg, B, L),
                                            is_leaf=jax_is_def)
    jcache = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in tree_leaves(cache_np)])
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    lens = np.array([0, 9, 23], np.int32)
    want, wcache = jax.jit(jax_step_fn_for(jcfg, "decode"))(
        jparams, jnp.asarray(tokens), jcache, jnp.asarray(lens))
    got, gcache = step_fn_for(cfg, "decode", device="cpu")(
        params, tokens, tree_map(lambda x: torch.from_numpy(x.copy()),
                                 cache_np), lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert len(tree_leaves(gcache)) == len(jax.tree.leaves(wcache)) > 0
    for g, w in zip(tree_leaves(gcache), jax.tree.leaves(wcache)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_abstract_params_allocate_nothing():
    defs = T.param_defs(get_arch("kimi-k2-1t-a32b"))
    tree = abstract_params(defs)
    leaves = tree_leaves(tree)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 10**12
    sh = shardings_for(defs, make_production_mesh())
    assert all(isinstance(s, X.Sharding) for s in tree_leaves(sh))


# --------------------------------------------------------------------------- #
# the decode kernel's plain version, partial mode
# --------------------------------------------------------------------------- #
def test_decode_plain_partial_mode():
    """lse is the log-sum-exp of the masked scaled scores; a row of length
    0 gives o = 0 and lse = -inf; o is the full mode's where rows are
    non-empty."""
    g = np.random.default_rng(0)
    B, H, KH, S, D = 4, 6, 2, 20, 16
    q = torch.from_numpy(g.standard_normal((B, H, D)).astype(np.float32))
    k = torch.from_numpy(g.standard_normal((B, KH, S, D)).astype(np.float32))
    v = torch.from_numpy(g.standard_normal((B, KH, S, D)).astype(np.float32))
    n = torch.tensor([0, 1, 13, 20], dtype=torch.int32)
    o, lse = ref.decode_attention_ref(q, k, v, n, return_lse=True)
    assert o.shape == (B, H, D) and lse.shape == (B, H)
    qg = q.reshape(B, KH, H // KH, D) / np.sqrt(D)
    s = torch.einsum("bkgd,bkcd->bkgc", qg, k).reshape(B, H, S)
    for b in range(B):
        if n[b] == 0:
            assert bool(torch.isneginf(lse[b]).all())
            assert bool((o[b] == 0).all())
            continue
        want = torch.logsumexp(s[b, :, :n[b]], dim=-1)
        torch.testing.assert_close(lse[b], want, rtol=1e-5, atol=1e-5)
    full = ref.decode_attention_ref(q, k, v, torch.clamp(n, min=1))
    torch.testing.assert_close(o[1:], full[1:], rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# compression without a mesh (a repair)
# --------------------------------------------------------------------------- #
def test_compress_grads_without_a_mesh_compresses_nothing():
    """The reference compresses only under a mesh: with ``compress_grads``
    and no mesh, the step equals the uncompressed step and hands the
    error buffers back untouched."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import (TrainStepConfig, compression,
                                   make_train_step)
    from repro_torch.data import SyntheticLM
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32")
    params = tree_map(lambda t: t.float(), init_params(
        T.param_defs(cfg), device="cpu", seed=2))
    batch = SyntheticLM(cfg.vocab_size, 16, 4).batch(0)
    plain = make_train_step(cfg, TrainStepConfig(
        learning_rate=lambda s: 1e-3), device="cpu")
    squeezed = make_train_step(cfg, TrainStepConfig(
        learning_rate=lambda s: 1e-3, compress_grads=True), device="cpu")
    want, _, mw = plain(params, adamw_init(params), batch)
    err = compression.init_error_state(params)
    got, _, err2, mg = squeezed(params, adamw_init(params), batch, err)
    assert err2 is err
    assert float(mg["grad_norm"]) == float(mw["grad_norm"])
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# tensor parallelism: the resident layout and the combines on emulated
# shards (one process: each rank's part computed here, then merged)
# --------------------------------------------------------------------------- #
TP_FAMILIES = {"llama3.2-1b": "dense", "granite-20b": "dense",
               "qwen3-moe-30b-a3b": "moe", "rwkv6-7b": "ssm",
               "jamba-v0.1-52b": "hybrid", "whisper-medium": "encdec",
               "pixtral-12b": "vlm"}


@pytest.mark.parametrize("arch", sorted(TP_FAMILIES))
@pytest.mark.parametrize("impl", ["gspmd", "ep"])
def test_resident_axes_by_family_and_profile(arch, impl):
    """Every family: the tensor-parallel axes (Mamba's ``d_inner`` and
    RWKV's heads among them), the cache's sequence and (EP) the ZeRO-3
    slices, every leaf's resident spec on (1, 2) the rule table's
    (``assert_unified_layout``), a rank holding less than the tree. Under
    ``dp`` a (1, 2) rank holds every leaf whole whatever the axes."""
    from repro_torch.core.unified_memory import assert_unified_layout
    from repro_torch.models.params import resident_axes
    cfg = dataclasses.replace(get_arch(arch), moe_impl=impl)
    got = resident_axes(cfg)
    assert cfg.family == TP_FAMILIES[arch]
    ep = ("fsdp",) if impl == "ep" else ()
    mesh = Mesh((1, 2), ("data", "model"))
    defs = T.param_defs(cfg.reduced())
    assert set(got) == {"heads", "kv_heads", "d_ff", "vocab", "experts",
                        "d_inner", "rwkv_heads", "kv_seq"} | set(ep)
    stats = assert_unified_layout(defs, mesh, cfg.reduced())
    assert stats["resident_param_bytes"] < stats["param_bytes"]
    token = X.set_profile("dp")
    try:
        local = local_defs(defs, mesh, got)
    finally:
        X._active_profile.reset(token)
    assert [pd.shape for pd in tree_leaves(local)] == \
        [pd.shape for pd in tree_leaves(defs)]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (16, 16)])
def test_llama_resident_bytes_are_the_rule_tables(mesh_shape):
    """llama3.2-1b's resident bytes a rank: its leaves cut by the
    reference's rule table (heads, KV heads where the extent divides them,
    d_ff and the vocabulary over 'model'); on (1, 2) at most 0.51 of the
    tree's 1,235,814,400 parameters, the norms alone whole.
    ``assert_unified_layout`` reports the same bytes."""
    from repro_torch.core.unified_memory import assert_unified_layout
    from repro_torch.models.params import (param_bytes, param_count,
                                           resident_axes)
    cfg = get_arch("llama3.2-1b")
    defs = T.param_defs(cfg)
    mesh = Mesh(mesh_shape, ("data", "model"))
    got = param_bytes(local_defs(defs, mesh, resident_axes(cfg)))
    want = 0
    for pd in _jax_leaves(RT.param_defs(jax_arch("llama3.2-1b"))):
        spec = tuple(JX.logical_spec(pd.shape, pd.logical_axes, mesh))
        want += int(np.prod(X.local_shape(pd.shape, spec, mesh))) * 2
    assert got == want
    assert param_count(defs) == 1_235_814_400
    if mesh_shape == (1, 2):
        assert got <= 0.51 * 2 * param_count(defs)
        whole = [pd for pd in tree_leaves(local_defs(
            defs, mesh, resident_axes(cfg))) if pd in tree_leaves(defs)]
        assert {pd.logical_axes[-1] for pd in whole} == {"d_model"}
        assert all(len(pd.shape) <= 2 for pd in whole)     # the norms
    stats = assert_unified_layout(defs, mesh, cfg)
    assert stats["resident_param_bytes"] == want


def test_vocab_parallel_cross_entropy_on_emulated_shards():
    """Four vocabulary shards' ``xent_stats`` merged by ``merge_xent``:
    the one-rank NLL, and through autograd the one-rank logits'
    gradient (the shards' in order), labels in every shard."""
    from repro_torch.models import layers as L
    g = np.random.default_rng(4)
    V, m = 64, 4
    full = torch.from_numpy(g.standard_normal((3, 5, V)).astype(np.float32)
                            * 4).requires_grad_()
    labels = torch.from_numpy(g.integers(0, V, (3, 5)))
    want = torch.logsumexp(full, -1) - full.gather(-1, labels[..., None])[
        ..., 0]
    (dwant,) = torch.autograd.grad(want.sum(), full)
    shards = [full.detach()[..., r * V // m:(r + 1) * V // m].clone()
              .requires_grad_() for r in range(m)]
    parts = [L.xent_stats(x, labels, r * V // m)
             for r, x in enumerate(shards)]
    got = L.merge_xent(parts)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    dgot = torch.autograd.grad(got.sum(), shards)
    torch.testing.assert_close(torch.cat(dgot, -1), dwant, rtol=1e-6,
                               atol=1e-6)


def test_sharded_argmax_takes_the_lowest_global_index_on_a_tie():
    """``merge_argmax`` over emulated shards equals ``torch.argmax`` of
    the whole row: ties within a shard, across shards and a max held by a
    later shard alone."""
    from repro_torch.sharding import comm
    rows = torch.tensor([[1., 5., 5., 0., 5., 5.],
                         [0., 1., 2., 7., 3., 7.],
                         [2., 2., 2., 2., 2., 2.],
                         [0., 0., 0., 0., 0., 9.]])
    for m in (1, 2, 3, 6):
        w = rows.shape[1] // m
        parts = []
        for r in range(m):
            x = rows[:, r * w:(r + 1) * w]
            idx = torch.argmax(x, -1)
            parts.append(torch.stack([x.gather(-1, idx[:, None])[:, 0].double(),
                                      (idx + r * w).double()], -1))
        assert torch.equal(comm.merge_argmax(parts), torch.argmax(rows, -1))


def test_global_index_gumbel_noise_is_the_whole_draws():
    """A vocabulary shard's noise hashes each cell's global index: the
    shards side by side are the unsharded draw, bit for bit."""
    draw = torch.tensor(11)
    whole = T.gumbel_noise(5, draw, (3, 48), "cpu")
    for m in (2, 3):
        w = 48 // m
        parts = [T.gumbel_noise(5, draw, (3, w), "cpu", r * w, 48)
                 for r in range(m)]
        assert torch.equal(torch.cat(parts, -1), whole)


def test_seq_shard_takes_kv_heads_equal_to_m_for_layout_a():
    """qwen3-moe .reduced() (KH 2) on (1, 2): a rank holds one KV head,
    and 1 % 2 != 0 must not read as layout B; granite-20b (KH 1) is
    layout B, the second rank's shard starting at S / 2."""
    from repro_torch.models import attention as A
    mesh = Mesh((1, 2), ("data", "model"), rank=1)
    qwen = get_arch("qwen3-moe-30b-a3b").reduced()
    granite = get_arch("granite-20b").reduced()
    one_head = torch.zeros(2, 1, 32, 16)
    assert A._seq_shard(qwen, one_head, mesh) == (None, 0)
    half = torch.zeros(2, 1, 16, 16)
    assert A._seq_shard(granite, half, mesh) == (mesh, 16)
    token = X.set_profile("dp")
    try:
        assert A._seq_shard(granite, half, mesh) == (None, 0)
    finally:
        X._active_profile.reset(token)
