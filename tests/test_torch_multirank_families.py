"""Tensor parallelism of the recurrent, hybrid, encoder-decoder and VLM
families on two CPU gloo ranks, against the reference under GSPMD and the
port's one rank.

rwkv6-7b, jamba-v0.1-52b, whisper-medium (also with a vocabulary of 257,
which 'model' does not divide, so the rule table keeps its embedding and
head whole) and pixtral-12b, each ``.reduced()`` in float32 on a (1, 2)
mesh: RWKV's heads, Mamba's ``d_inner``, every attention layer's heads and
KV heads (whisper's encoder, self and cross attention among them), d_ff,
the experts and the vocabulary where it divides over 'model'. The ranks
are spawned once (``test_torch_multirank._spawn``); the reference runs in
ONE subprocess with 4 forced host devices while they do. Weights come
from numpy seeds, every leaf drawn (the ones- and zeros-initialized too,
so the token-shift mixes, the decay LoRA's B and the norms' biases are not
0), and go to both sides through a file. Float32 results agree within
1e-4.

What they hold: the gathered logits, the loss and every gradient leaf
after the train step's reduction (the replicated ``mu_*``, ``w_lora_a``,
``wcr`` and Mamba's low-rank weights among them); teacher-forced decode
logits through the wkv, conv, ssm and cross caches (whisper's filled by
``prefill_with_cache`` from the frames); each family's engine against
one rank's (greedy tokens, dispatches, host syncs) and its collectives
against the plan; AdamW and Adafactor on the ranks' parts against the
full tree's update; each rank's parameter bytes against ``local_defs``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, tree_leaves, tree_map
from test_torch_multirank import _full_leaves, _serve, _spawn

# the collective plan chip_smoke.py's phase 23 holds the card to
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import tp_layer_collectives, tp_vocab_split  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
REF_S = 300            # the reference's subprocess

# tag -> (arch, config overrides, numpy seed of the weights)
FAMILIES = {"rwkv": ("rwkv6-7b", {}, 80),
            "jamba": ("jamba-v0.1-52b", {}, 81),
            "whisper": ("whisper-medium", {}, 82),
            "whisper257": ("whisper-medium", {"vocab_size": 257}, 83),
            "pixtral": ("pixtral-12b", {}, 84)}
B, S = 2, 16           # the loss's batch (pixtral's S counts its patches)
STEPS, CACHE = 6, 16   # teacher-forced decode steps, the cache's length


def _cfg(tag):
    name, kw, _ = FAMILIES[tag]
    return dataclasses.replace(get_arch(name).reduced(), dtype="float32",
                               **kw)


def _leaf(pd, rng):
    """A float32 leaf from ``rng``: a normal one at its fan-in scale, a
    small-normal one at 0.1, a decay as ``init_params`` draws it, and a
    ones or zeros one moved off its constant by 0.1 normal noise."""
    if pd.init == "decay":
        return (np.log(rng.uniform(1e-3, 1.0, pd.shape)) * pd.scale
                ).astype(np.float32)
    noise = rng.standard_normal(pd.shape)
    if pd.init in ("ones", "zeros"):
        return (float(pd.init == "ones") + 0.1 * noise).astype(np.float32)
    std = 0.1 if pd.init == "small_normal" else pd.fan_in() ** -0.5
    return (noise * std).astype(np.float32)


def _weights(cfg, seed):
    rng = np.random.default_rng(seed)
    return [_leaf(pd, rng) for pd in tree_leaves(T.param_defs(cfg))]


def _tree_of(cfg, a, tag):
    """The port's tree of the arrays ``{tag}_w{i}``."""
    it = iter(range(10 ** 6))
    return tree_map(lambda pd: torch.from_numpy(a[f"{tag}_w{next(it)}"]),
                    T.param_defs(cfg))


def _batch(cfg, a, tag):
    """The loss's batch of numpy arrays (``data.batch_for``'s keys)."""
    return {k[len(tag) + 3:]: v for k, v in a.items()
            if k.startswith(f"{tag}_b_")}


def _stub(batch):
    return {k: batch[k] for k in ("patch_embeds", "frame_embeds")
            if k in batch}


def _write_inputs(path):
    from repro_torch.data import batch_for
    arrays = {}
    for tag, (_, _, seed) in FAMILIES.items():
        cfg = _cfg(tag)
        for i, w in enumerate(_weights(cfg, seed)):
            arrays[f"{tag}_w{i}"] = w
        for k, v in batch_for(cfg, B, S, seed=seed).items():
            arrays[f"{tag}_b_{k}"] = v
        rng = np.random.default_rng(seed + 100)
        arrays[f"{tag}_dec"] = rng.integers(
            0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    np.savez(path, **arrays)


# --------------------------------------------------------------------------- #
# the reference, in one subprocess with 4 forced host devices
# --------------------------------------------------------------------------- #
def reference_main(inp: str, out: str) -> None:
    """Each family's logits, loss, gradients and decode logits under GSPMD
    on a (1, 2) mesh of forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_arch as jax_arch
    from repro.models import transformer as JT
    from repro.models.params import is_def as jax_is_def
    from repro.models.params import shardings_for as jax_shardings

    a = dict(np.load(inp))
    mesh = Mesh(np.array(jax.devices())[:2].reshape(1, 2), ("data", "model"))
    res = {}
    for tag, (name, kw, _) in FAMILIES.items():
        cfg = dataclasses.replace(jax_arch(name).reduced(), dtype="float32",
                                  **kw)
        defs = JT.param_defs(cfg)
        leaves, treedef = jax.tree_util.tree_flatten(defs, is_leaf=jax_is_def)
        p = jax.device_put(jax.tree_util.tree_unflatten(
            treedef, [a[f"{tag}_w{i}"] for i in range(len(leaves))]),
            jax_shardings(defs, mesh))
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg, a, tag).items()}
        stub = _stub(batch)

        def loss(p, b, cfg=cfg, stub=stub):
            logits, _ = JT.forward_full(cfg, p, b["tokens"], **stub)
            return JT.loss_fn(cfg, p, b)[0], logits

        cdefs = JT.cache_defs(cfg, B, CACHE)
        cache = jax.device_put(
            jax.tree.map(lambda pd: jnp.zeros(pd.shape, pd.dtype), cdefs,
                         is_leaf=jax_is_def), jax_shardings(cdefs, mesh))
        toks = jnp.asarray(a[f"{tag}_dec"])
        with mesh:
            (lv, logits), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(p, batch)
            # the first token through prefill_with_cache (whisper's cross
            # cache filled from the frames), then decode steps
            first, cache, lens = jax.jit(
                lambda p, t, c, f, cfg=cfg: JT.prefill_with_cache(
                    cfg, p, t, c, frame_embeds=f))(
                p, toks[:, :1], cache, stub.get("frame_embeds"))
            step = jax.jit(lambda p, t, c, n, cfg=cfg: JT.decode_step(
                cfg, p, t, c, n))
            steps = [np.asarray(first)]
            for t in range(1, STEPS):
                out_t, cache = step(p, toks[:, t:t + 1], cache, lens)
                lens = lens + 1
                steps.append(np.asarray(out_t))
        res[f"{tag}_logits"], res[f"{tag}_loss"] = (np.asarray(logits),
                                                    float(lv))
        for i, g in enumerate(jax.tree.leaves(grads)):
            res[f"{tag}_g{i}"] = np.asarray(g)
        res[f"{tag}_dec"] = np.stack(steps)
    np.savez(out, **res)


def _start_reference(tmp: Path):
    inp, out = tmp / "ref_in.npz", tmp / "ref_out.npz"
    _write_inputs(inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]))
    code = ("import test_torch_multirank_families as m; "
            f"m.reference_main({str(inp)!r}, {str(out)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, out


def _finish_reference(proc, out):
    try:
        log, _ = proc.communicate(timeout=REF_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, log.decode()[-4000:]
    return dict(np.load(out))


# --------------------------------------------------------------------------- #
# the port: one rank, and each rank of (1, 2)
# --------------------------------------------------------------------------- #
def _gather_vocab(logits, params, cfg, mesh):
    """Full logits from a rank's: its vocabulary columns gathered when the
    vocabulary is split, else its own."""
    from repro_torch.models import layers as L
    from repro_torch.sharding import comm
    split, _ = L.vocab_shard(params["embed"], cfg.vocab_size)
    if split is None:
        return logits
    return torch.cat(comm.gather_parts(logits.contiguous(), mesh, "model"),
                     -1)


def _decode(cfg, params, a, tag, mesh=None):
    """The first token through ``prefill_with_cache`` (with the frames),
    then STEPS - 1 teacher-forced decode steps from that cache (the
    rank's part of it under ``mesh``): (every step's full logits, the
    collectives the steps made, counted from 0)."""
    from repro_torch.models.params import local_defs, resident_axes
    from repro_torch.sharding import comm
    cache = init_params(local_defs(T.cache_defs(cfg, B, CACHE), mesh,
                                   resident_axes(cfg)), device="cpu")
    toks = torch.from_numpy(a[f"{tag}_dec"].astype(np.int64))
    stub = {k: torch.from_numpy(v) for k, v in
            _stub(_batch(cfg, a, tag)).items()}
    comm.reset_stats()
    first, cache, lens = T.prefill_with_cache(
        cfg, params, toks[:, :1], cache,
        frame_embeds=stub.get("frame_embeds"))
    out = [first]
    for t in range(1, STEPS):
        logits, cache = T.decode_step(cfg, params, toks[:, t:t + 1], cache,
                                      lens)
        lens = lens + 1
        out.append(logits)
    made = comm.stats()["collectives"]
    return torch.stack([_gather_vocab(x, params, cfg, mesh)
                        for x in out]).numpy(), made


def _forward(cfg, params, a, tag):
    """(logits, loss, gradients) of the loss's batch."""
    from repro_torch.train import loss_and_grads
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, a, tag).items()}
    batch["tokens"] = batch["tokens"].long()
    stub = _stub(batch)
    logits, _ = T.forward_full(cfg, params, batch["tokens"], **stub)
    loss, _, grads = loss_and_grads(cfg, params, batch)
    return logits, loss, grads


def _optim(cfg, mesh):
    """AdamW and Adafactor on the ranks' parts against the full tree's
    update: the worst difference of any leaf, and the least a leaf
    moved."""
    from repro_torch.models.params import (resident_axes, resident_specs,
                                           shard_tree)
    from repro_torch.optim import (AdafactorConfig, AdamWConfig,
                                   adafactor_init, adafactor_update,
                                   adamw_init, adamw_update)
    defs, resident = T.param_defs(cfg), resident_axes(cfg)
    full = tree_map(lambda t: t.float(), init_params(defs, device="cpu",
                                                     seed=9))
    rng = np.random.default_rng(10)
    grads = tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)), full)
    specs = resident_specs(defs, mesh, resident)
    part = lambda tree: shard_tree(tree, defs, mesh, resident)  # noqa: E731
    out = {}
    for name, init, update, ocfg in (
            ("adamw", adamw_init, adamw_update, AdamWConfig()),
            ("adafactor", adafactor_init, adafactor_update,
             AdafactorConfig(weight_decay=0.1))):
        want = update(full, grads, init(full), 1e-2, ocfg)[0]
        got = update(part(full), part(grads), init(part(full)), 1e-2, ocfg,
                     specs, mesh)[0]
        out[name] = max(float((g - w).abs().max()) for g, w in zip(
            tree_leaves(got), tree_leaves(part(want))))
        out[f"{name}_moved"] = min(float((g - w).abs().max()) for g, w in zip(
            tree_leaves(got), tree_leaves(part(full))))
    return out


def _serve_params(cfg):
    return tree_map(lambda t: t.float(), init_params(
        T.param_defs(cfg), device="cpu", seed=8))


def _two_ranks(rank, world, tmp):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import (local_defs, param_bytes,
                                           resident_axes, resident_specs,
                                           shard_tree)
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh
    from repro_torch.train.step import _reduce_grads
    a = dict(np.load(tmp.parent / "ref_in.npz"))
    mesh = make_host_mesh(model=2)
    out = {}
    for tag in FAMILIES:
        cfg = _cfg(tag)
        defs, resident = T.param_defs(cfg), resident_axes(cfg)
        local = shard_tree(_tree_of(cfg, a, tag), defs, mesh, resident)
        specs = resident_specs(defs, mesh, resident)
        out[f"{tag}_held"] = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(local))
        out[f"{tag}_local_defs"] = param_bytes(local_defs(defs, mesh,
                                                          resident)) * 2
        with use_mesh(mesh):
            logits, loss, grads = _forward(cfg, local, a, tag)
            out[f"{tag}_logits"] = _gather_vocab(logits, local, cfg,
                                                 mesh).detach().numpy()
            out[f"{tag}_loss"] = float(loss)
            # the train step's reduction: a replicated leaf summed over
            # 'model', every leaf divided by the mesh's size
            grads = _reduce_grads(grads, specs, mesh, mesh.axis_names,
                                  mesh.size)
            for i, g in enumerate(_full_leaves(grads, specs, mesh)):
                out[f"{tag}_g{i}"] = g.numpy()
            out[f"{tag}_dec"], out[f"{tag}_dec_comm"] = _decode(
                cfg, local, a, tag, mesh)
            params = shard_tree(_serve_params(cfg), defs, mesh, resident)
            comm.reset_stats()
            serve = _serve(cfg, params)
            out[f"{tag}_serve"] = json.dumps(
                dict(serve, comm=comm.stats()["collectives"]))
        for k, v in _optim(cfg, mesh).items():
            out[f"{tag}_opt_{k}"] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank_families")
    proc, out = _start_reference(tmp)
    try:
        two_dir = tmp / "two"
        two_dir.mkdir()
        two = _spawn(_two_ranks, 2, two_dir)
    except BaseException:
        proc.kill()
        raise
    ref = _finish_reference(proc, out)
    return dict(ref=ref, two=two, inputs=dict(np.load(tmp / "ref_in.npz")))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# the tests
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tag", list(FAMILIES))
def test_tensor_parallel_family_logits_loss_and_gradients(runs, tag):
    """The gathered logits, the loss and every gradient leaf after the
    train step's reduction against the reference under GSPMD on the same
    weights and the port's one rank."""
    a, ref = runs["inputs"], runs["ref"]
    cfg = _cfg(tag)
    logits, loss, grads = _forward(cfg, _tree_of(cfg, a, tag), a, tag)
    grads = [g.numpy() for g in tree_leaves(grads)]
    for r in runs["two"]:
        for want in (ref[f"{tag}_logits"], logits.detach().numpy()):
            np.testing.assert_allclose(r[f"{tag}_logits"], want, **TOL)
        for want in (ref[f"{tag}_loss"], float(loss)):
            np.testing.assert_allclose(float(r[f"{tag}_loss"]), float(want),
                                       **TOL)
        for i, g in enumerate(grads):
            np.testing.assert_allclose(r[f"{tag}_g{i}"], ref[f"{tag}_g{i}"],
                                       **TOL, err_msg=f"leaf {i}")
            np.testing.assert_allclose(r[f"{tag}_g{i}"], g, **TOL,
                                       err_msg=f"leaf {i}")


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_tensor_parallel_family_decode_logits(runs, tag):
    """``prefill_with_cache`` of one token (whisper's cross cache filled
    from the frames at the rank's heads) and 5 decode steps through the
    rank's wkv heads, conv and ssm channels and KV heads, against the
    reference under GSPMD and the port's one rank; both ranks' logits are
    the same bits, and a step makes the plan's collectives
    (``tp_layer_collectives``, and the embedding's where the vocabulary is
    split)."""
    a, ref = runs["inputs"], runs["ref"]
    cfg = _cfg(tag)
    one = _decode(cfg, _tree_of(cfg, a, tag), a, tag)[0]
    for r in runs["two"]:
        np.testing.assert_allclose(r[f"{tag}_dec"], ref[f"{tag}_dec"], **TOL)
        np.testing.assert_allclose(r[f"{tag}_dec"], one, **TOL)
        # whisper's encoder once: a block's attention and MLP psums
        assert int(r[f"{tag}_dec_comm"]) == STEPS * (
            tp_vocab_split(cfg) + tp_layer_collectives(cfg)) \
            + 2 * cfg.encoder_layers * (cfg.family == "encdec")
    np.testing.assert_array_equal(runs["two"][0][f"{tag}_dec"],
                                  runs["two"][1][f"{tag}_dec"])


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_tensor_parallel_family_engines_match_one_rank(runs, tag):
    """Each family's engine on (1, 2) against the one-rank engine: greedy
    tokens, dispatches and host syncs (RWKV, Mamba and whisper prefill
    sequentially, pixtral in chunks). A prefill dispatch makes the
    embedding's psum and the layers' (``tp_layer_collectives``), a decode
    step the same and the sampled argmax's gather; with the vocabulary whole
    neither the embedding nor the argmax makes one."""
    cfg = _cfg(tag)
    want = _serve(cfg, _serve_params(cfg))
    v = tp_vocab_split(cfg)
    for r in runs["two"]:
        got = json.loads(str(r[f"{tag}_serve"]))
        comm = got.pop("comm")
        assert got == want
        dc = want["dispatches"]
        assert dc.get("fused", 0) == 0
        assert comm == dc["prefill"] * (v + tp_layer_collectives(cfg)) \
            + dc["decode"] * (2 * v + tp_layer_collectives(cfg))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("tag", ["rwkv", "jamba", "whisper257", "pixtral"])
def test_tensor_parallel_family_optimizers_update_the_full_tree(runs, tag,
                                                                name):
    """AdamW (its clip norm over the ranks' parts) and Adafactor (its row
    and column means and its RMS over sharded dims, RWKV's 3-D head
    leaves among them) on the ranks' parts give each rank its part of the
    full tree's update; every leaf moves."""
    for r in runs["two"]:
        assert float(r[f"{tag}_opt_{name}"]) <= 1e-6
        assert float(r[f"{tag}_opt_{name}_moved"]) > 1e-6


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_tensor_parallel_family_ranks_hold_the_rule_tables_part(runs, tag):
    """A rank holds ``local_defs``'s bytes, less than the tree's, and the
    rule table's resident spec of every leaf (``assert_unified_layout``
    on (1, 2)); whisper's odd vocabulary stays whole on both ranks."""
    from repro_torch.core.unified_memory import assert_unified_layout
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.params import param_bytes
    cfg = _cfg(tag)
    defs = T.param_defs(cfg)
    stats = assert_unified_layout(defs, Mesh((1, 2), ("data", "model")), cfg)
    for r in runs["two"]:
        assert int(r[f"{tag}_held"]) == int(r[f"{tag}_local_defs"])
        assert int(r[f"{tag}_held"]) == stats["resident_param_bytes"] * 2
        assert int(r[f"{tag}_held"]) < param_bytes(defs) * 2
    whole = [pd.shape for pd in tree_leaves(defs["embed"])]
    if not tp_vocab_split(cfg):
        from repro_torch.models.params import local_defs, resident_axes
        local = local_defs(defs, Mesh((1, 2), ("data", "model")),
                           resident_axes(cfg))
        assert [pd.shape for pd in tree_leaves(local["embed"])] == whole


@pytest.mark.parametrize("tag", ["rwkv", "jamba", "whisper257", "pixtral"])
def test_init_shard_draws_init_params_cut_to_each_rank(tag):
    """``init_shard`` (a rank's parts drawn one leaf at a time, as the
    card phases build full-width weights) gives each rank of (1, 2)
    exactly ``shard_tree`` of ``init_params``' tree."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.params import (init_shard, resident_axes,
                                           shard_tree)
    cfg = _cfg(tag)
    defs = T.param_defs(cfg)
    full = init_params(defs, device="cpu", seed=3)
    for rank in range(2):
        mesh = Mesh((1, 2), ("data", "model"), rank=rank)
        got = init_shard(defs, mesh, resident_axes(cfg), device="cpu",
                         seed=3)
        want = shard_tree(full, defs, mesh, resident_axes(cfg))
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.shape == b.shape and torch.equal(a, b)


# --------------------------------------------------------------------------- #
# chip_smoke.py's count of launches by shape, on fake kernels
# --------------------------------------------------------------------------- #
@pytest.fixture
def fake_kernels(monkeypatch):
    """Every kernel wrapper of the dispatch layer replaced by its plain
    version counting one launch (the GEMV one per 8 rows), taken on CPU
    tensors, and chip_smoke's tally switched on."""
    import chip_smoke
    from repro_torch.kernels import ops, ref

    def fake(name, fn, per=lambda *a, **k: 1):
        def kernel(*a, **k):
            kernel.launches += per(*a, **k)
            return fn(*a, **k)
        kernel.launches = 0
        monkeypatch.setitem(ops.KERNELS, name, kernel)
        return kernel
    fakes = {
        "_flash": fake("flash_attention", lambda q, k, v, causal=True,
                       q_offset=0, return_lse=False: ref.flash_attention_ref(
                           q, k, v, causal=causal, q_offset=q_offset,
                           return_lse=return_lse)),
        "_decode": fake("decode_attention", ref.decode_attention_ref),
        "_matvec": fake("pim_matvec", ref.matvec_ref,
                        lambda x, *a, **k: -(-x.shape[0] // 8)),
        "_norm": fake("layernorm", ref.norm_ref),
        "_rwkv_chunk": fake("rwkv_chunk", lambda r, k, v, w, u, out_dtype=None:
                            ref.rwkv_chunk_ref(r, k, v, w, u.repeat(
                                r.shape[0] // u.shape[0], 1), out_dtype)),
    }
    for name, fn in fakes.items():
        monkeypatch.setattr(ops, name, fn)
    monkeypatch.setattr(ops, "_use_kernel", lambda t: True)
    shapes = chip_smoke.launch_shapes
    monkeypatch.setattr(chip_smoke, "launch_shapes",
                        lambda ops_, on: shapes(ops_, True))
    return chip_smoke


def test_launch_shapes_counts_each_launch_at_its_shape(fake_kernels):
    """A GEMV of 8 rows is one launch, one of 16 two; flash is keyed by
    its heads, lengths, offset and mode; ``check_shapes`` holds the tally
    to a plan kernel by kernel and names what differs."""
    from repro_torch.kernels import ops
    cs = fake_kernels
    q, kv = torch.ones(1, 4, 8, 16), torch.ones(1, 2, 24, 16)
    with cs.launch_shapes(ops, True) as tally:
        ops.fused_matvec(torch.ones(8, 4), torch.ones(4, 2))
        ops.fused_matvec(torch.ones(16, 4), torch.ones(4, 2),
                         activation="silu")
        ops.flash_attention(q, kv, kv, q_offset=16)
    want = {cs.gemv_key("n8 4->2 none"): 1, cs.gemv_key("n16 4->2 silu"): 2,
            cs.flash_key(1, 4, 2, 8, 24, 16, True, 16): 1}
    assert dict(tally) == want
    assert cs.check_shapes("t", tally, {cs.gemv_key("n8 4->2 none"): 1,
                                        cs.gemv_key("n16 4->2 silu"): 2})
    with pytest.raises(RuntimeError, match="n16 4->2 silu"):
        cs.check_shapes("t", tally, {cs.gemv_key("n8 4->2 none"): 1})
    assert cs.check_shapes("t", None, want) is None


@pytest.mark.parametrize("tag", ["rwkv", "pixtral"])
def test_serve_launches_by_shape_follow_the_plan(fake_kernels, tag):
    """One rank's serve (``mesh_serve``, no mesh) launches what
    ``tp_serve_shapes`` plans at m = 1: rwkv6-7b's GEMVs a sequential
    dispatch and a decode step, pixtral-12b's flash a prefill chunk at its
    offset and span, its GEMVs and decode attention a decode step."""
    cs = fake_kernels
    cfg = _cfg(tag)
    params = init_params(T.param_defs(cfg), device="cpu", seed=0)
    prompts = (cs.tp_recurrent_prompts(cfg.vocab_size) if tag == "rwkv"
               else cs.serve_prompts(cfg.vocab_size))
    run = cs.mesh_serve(torch, cfg, params, None, "cpu", prompts, 4)
    plan = cs.tp_serve_shapes(cfg, run["dispatches"], m=1)
    assert cs.check_shapes(tag, run["by_shape"], plan)
