"""The port's multi-rank slice on CPU gloo ranks, against the reference's
multi-device paths under forced host devices.

Ranks: ``torch.multiprocessing`` spawns 2 and 4 gloo ranks once each
(``init_method=file://`` under the test's temporary directory, so
parallel test workers never share a port), each spawn and join with a
limit of its own; every rank writes its results to an ``.npz`` file.
The reference runs in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, its functions
under ``jax.jit``, and writes its arrays to an ``.npz`` file; it runs
while the ranks do. Inputs come from numpy seeds and go to both sides
through files. Float32 results agree within 1e-4.

What they hold: ``apply_moe_ep``'s output, balance loss and gradients
(router, wi, wg, wo, x) on 4 ranks at (data 2, model 2) with
``fsdp_params`` on and off and at (1, 4), against the reference's and
the port's one-rank ``apply_moe``; tensor parallelism on (1, 2):
llama3.2-1b's logits, loss and every gathered gradient leaf, and the
decode logits of granite-20b (KH 1, layout B) and qwen3-moe (KH 2 = m,
non-EP and EP) against the reference under GSPMD on the same weights and
the port's one rank, four llama engines (batched, packed, fused with
superstep 4, int8 cache) and three granite-20b ones in layout B (packed,
int8, both) against the one-rank engine with their collective plans, and
AdamW and Adafactor on the ranks' parts against the full tree's update;
decode layout B on 2 and 4 ranks against the reference's layout B and
the port's layout A (a row ends inside the first shard); the layout-B
prefill on 2 and 4 ranks (``attention_prefill_packed`` in float32 and
int8, with and without a prefix, and the int8 ``attention_prefill_cached``)
against the reference under GSPMD and the port's one rank, outputs,
cache shards and collective counts; a granite-20b ``.reduced()`` (KH 1)
engine on 2 ranks against the port's one-rank engine (the greedy tokens,
dispatches and host syncs; the one-rank engine is held against the
reference engine by ``test_torch_configs.py``); MoE routing under a
(2, 1) mesh with capacity drops against the reference's two routing
groups; the compressed all-reduce on 2 and 4 ranks against a one-process
emulation, its error-feedback identity, and equal per-rank gradients
against the reference's replicated input; the data-parallel step on 2
ranks against the one-rank step on the whole batch; the clip norm of a
sharded EP tree against the full tree's; ``launch.train --smoke`` on 2
ranks.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_arch
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, tree_map

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
SPAWN_S = 240          # each spawn's join
REF_S = 300            # the reference's subprocess


# --------------------------------------------------------------------------- #
# inputs (numpy, from seeds)
# --------------------------------------------------------------------------- #
def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _moe_cfg(name="qwen3-moe-30b-a3b", **kw):
    return dataclasses.replace(get_arch(name).reduced(), dtype="float32",
                               **kw)


def _moe_inputs(cfg, B, S):
    """f32 MoE leaves (router skewed so that experts overflow), tokens and
    the loss's cotangent weights."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    router = _x((d, E), 11, 0.3)
    router[:, :2] += 0.4
    return {"router": router, "wi": _x((E, d, f), 12, d ** -0.5),
            "wg": _x((E, d, f), 13, d ** -0.5),
            "wo": _x((E, f, d), 14, f ** -0.5),
            "x": _x((B, S, d), 15), "c": _x((B, S, d), 16)}


EP_CASES = (("dp2_mp2_fsdp", 2, 2, True), ("dp2_mp2", 2, 2, False),
            ("dp1_mp4", 1, 4, False))
EP_B, EP_S = 4, 3
DEC = dict(B=3, H=4, KH=1, S=32, hd=16)
DEC_LENS = (5, 17, 32)          # the first ends inside the first shard
GROUP_B, GROUP_S, GROUP_CF = 4, 4, 0.5


def _decode_inputs():
    B, H, KH, S, hd = (DEC[k] for k in ("B", "H", "KH", "S", "hd"))
    return dict(q=_x((B, H, 1, hd), 21), k=_x((B, KH, S, hd), 22),
                v=_x((B, KH, S, hd), 23),
                lens=np.array(DEC_LENS, np.int32))


# layout-B prefill at function level (granite-20b .reduced(), KH 1): a
# packed chunk whose lane 0 continues slot 1 at positions 20-27 over a
# prefix of 20 (a shard boundary inside both, at m = 2 and 4), lane 1 two
# whole prompts (slot 0 at 0-4, slot 2 at 0-1) and a padding column; the
# same chunk's lane 1 alone (no prefix); a batched int8 chunk at 12-23
PF = dict(B=3, L=32, C=8, span=24, CC=12, off=12)
PF_CASES = ("packed", "packed_int8", "packed_no_prefix", "cached_int8")


def _pf_layout():
    C = PF["C"]
    slot = np.array([[1] * C, [0] * 5 + [2] * 2 + [0]], np.int32)
    pos = np.array([list(range(20, 28)), list(range(5)) + [0, 1, 0]],
                   np.int32)
    ids = np.array([[0] * C, [1] * 5 + [2] * 2 + [-1]], np.int32)
    return dict(seg_slot=slot, seg_pos=pos, seg_ids=ids, valid=ids >= 0,
                row_slot=np.array([1, 0], np.int32),
                prefix_len=np.array([20, 0], np.int32))


def _pf_inputs():
    cfg = get_arch("granite-20b").reduced()
    d, H, hd, B, L = cfg.d_model, cfg.num_heads, cfg.head_dim, PF["B"], \
        PF["L"]
    rng = np.random.default_rng(80)
    out = {"wq": _x((d, H, hd), 81, d ** -0.5),
           "wk": _x((d, 1, hd), 82, d ** -0.5),
           "wv": _x((d, 1, hd), 83, d ** -0.5),
           "wo": _x((H, hd, d), 84, (H * hd) ** -0.5),
           "x": _x((2, PF["C"], d), 85), "xc": _x((B, PF["CC"], d), 86),
           "k": _x((B, 1, L, hd), 87), "v": _x((B, 1, L, hd), 88),
           "k8": rng.integers(-127, 128, (B, 1, L, hd)).astype(np.int8),
           "v8": rng.integers(-127, 128, (B, 1, L, hd)).astype(np.int8),
           "ks": (rng.random((B, 1, L)) * 0.05).astype(np.float32),
           "vs": (rng.random((B, 1, L)) * 0.05).astype(np.float32),
           "cvalid": np.array([[True] * 12, [True] * 5 + [False] * 7,
                               [False] * 12])}
    out.update(_pf_layout())
    return out


def _pf_case(case, a):
    """(kv_dtype, the cache's leaves, the call's inputs) of a case, from
    the arrays ``a`` (numpy, ``pf_`` prefix stripped)."""
    int8 = case.endswith("int8")
    cache = ({"k": a["k8"], "v": a["v8"], "k_scale": a["ks"],
              "v_scale": a["vs"]} if int8 else {"k": a["k"], "v": a["v"]})
    if case == "cached_int8":
        return "int8", cache, dict(x=a["xc"], tok_valid=a["cvalid"])
    lanes = slice(1, 2) if case == "packed_no_prefix" else slice(0, 2)
    lay = {k: a[k][lanes] for k in ("seg_slot", "seg_pos", "seg_ids",
                                     "valid", "row_slot", "prefix_len")}
    return ("int8" if int8 else "bf16"), cache, dict(
        x=a["x"][lanes], span=0 if case == "packed_no_prefix" else PF["span"],
        **lay)


def _pf_valid(case, a):
    """The valid query rows of a case's output."""
    if case == "cached_int8":
        return a["cvalid"]
    return a["valid"][1:2] if case == "packed_no_prefix" else a["valid"]


def _pf_port(cfg, case, a, mesh=None, rank=0):
    """The port's call of a case on a rank's part (its query heads and its
    shard of the cache) or, without ``mesh``, on the whole: (out, cache)."""
    from repro_torch.models import attention as A
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh
    kv, cache, inp = _pf_case(case, a)
    cfg = dataclasses.replace(cfg, kv_dtype=kv)
    m = comm.axis_size(mesh, "model")
    h = cfg.num_heads // m
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731  (a copy)
    p = {"wq": t(a["wq"][:, rank * h:(rank + 1) * h]), "wk": t(a["wk"]),
         "wv": t(a["wv"]), "wo": t(a["wo"][rank * h:(rank + 1) * h])}
    S = PF["L"] // m
    cache = {k: t(v[:, :, rank * S:(rank + 1) * S]) for k, v in cache.items()}
    scope = use_mesh(mesh) if mesh is not None else \
        contextlib.nullcontext()
    with scope:
        if case == "cached_int8":
            out, new = A.attention_prefill_cached(
                cfg, p, t(inp["x"]), cache, t(inp["tok_valid"]), PF["off"])
        else:
            out, new = A.attention_prefill_packed(
                cfg, p, t(inp["x"]), cache, *(t(inp[k]) for k in (
                    "seg_slot", "seg_pos", "seg_ids", "valid", "row_slot",
                    "prefix_len")), prefix_span=inp["span"])
    return out.numpy(), {k: v.numpy() for k, v in new.items()}


def _prefill_b_on_ranks(mesh, a, out):
    """Each case of ``PF_CASES`` on this rank: its output, its cache shard
    and its collectives."""
    from repro_torch.sharding import comm
    cfg = dataclasses.replace(get_arch("granite-20b").reduced(),
                              dtype="float32")
    m, i = comm.axis_size(mesh, "model"), comm.axis_index(mesh, "model")
    pf = {k[3:]: v for k, v in a.items() if k.startswith("pf_")}
    for case in PF_CASES:
        comm.reset_stats()
        o, new = _pf_port(cfg, case, pf, mesh, i)
        out[f"pf{m}_{case}_out"] = o
        out[f"pf{m}_{case}_comm"] = comm.stats()["collectives"]
        for k, v in new.items():
            out[f"pf{m}_{case}_{k}"] = v


def _grad_inputs(rank, equal=False):
    r = 0 if equal else rank
    return {"w": _x((16, 24), 30 + r), "b": {"s": _x((24,), 40 + r, 3.0)}}


def _err_inputs(rank):
    return {"w": _x((16, 24), 50 + rank, 0.01),
            "b": {"s": _x((24,), 60 + rank, 0.01)}}


# tensor parallelism on (1, 2): the configs, the weights' numpy seeds
TP_ARCHS = {"llama": ("llama3.2-1b", {}), "granite": ("granite-20b", {}),
            "qwen": ("qwen3-moe-30b-a3b", {}),
            "qwen_ep": ("qwen3-moe-30b-a3b", {"moe_impl": "ep"})}
TP_B, TP_S, TP_STEPS, TP_LEN = 2, 16, 10, 16


def _tp_cfg(tag):
    name, kw = TP_ARCHS[tag]
    return dataclasses.replace(get_arch(name).reduced(), dtype="float32",
                               **kw)


def _np_weights(cfg, seed):
    """float32 leaves of ``cfg``'s tree in sorted-path order (the order of
    ``jax.tree.leaves`` too), drawn from a numpy seed."""
    from repro_torch.models.params import is_def, tree_leaves
    rng = np.random.default_rng(seed)
    out = []
    for pd in tree_leaves(T.param_defs(cfg)):
        assert is_def(pd)
        if pd.init in ("ones", "zeros"):
            out.append(np.full(pd.shape, pd.init == "ones", np.float32))
            continue
        std = 0.5 if pd.init == "small_normal" else pd.fan_in() ** -0.5
        out.append((rng.standard_normal(pd.shape) * std).astype(np.float32))
    return out


def _tree_of(cfg, a, tag):
    """The port's tree of the arrays ``{tag}_w{i}``."""
    from repro_torch.models.params import tree_map
    it = iter(range(10 ** 6))
    return tree_map(lambda pd: torch.from_numpy(a[f"{tag}_w{next(it)}"]),
                    T.param_defs(cfg))


def _write_inputs(path):
    cfg = _moe_cfg()
    arrays = {f"moe_{k}": v for k, v in _moe_inputs(cfg, EP_B, EP_S).items()}
    arrays.update({f"dec_{k}": v for k, v in _decode_inputs().items()})
    arrays.update({f"pf_{k}": v for k, v in _pf_inputs().items()})
    g = _moe_inputs(_moe_cfg(capacity_factor=GROUP_CF), GROUP_B, GROUP_S)
    arrays.update({f"grp_{k}": v for k, v in g.items()})
    for tag, seed in (("llama", 70), ("granite", 71), ("qwen", 72)):
        for i, w in enumerate(_np_weights(_tp_cfg(tag), seed)):
            arrays[f"tp_{tag}_w{i}"] = w
    rng = np.random.default_rng(73)
    arrays["tp_tokens"] = rng.integers(0, 256, (TP_B, TP_S + 1)).astype(
        np.int32)
    arrays["tp_dec"] = rng.integers(0, 256, (TP_B, TP_STEPS)).astype(
        np.int32)
    np.savez(path, **arrays)


# --------------------------------------------------------------------------- #
# the reference, in one subprocess with 4 forced host devices
# --------------------------------------------------------------------------- #
def reference_main(inp: str, out: str) -> None:
    """The reference's multi-device results (run by ``_start_reference``
    in a process of its own)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_arch as jax_arch
    from repro.models import attention as JA
    from repro.models import moe as JM
    from repro.train import compression as JC

    a = dict(np.load(inp))
    devs = np.array(jax.devices())
    res = {}

    def jcfg(**kw):
        return dataclasses.replace(jax_arch("qwen3-moe-30b-a3b").reduced(),
                                   dtype="float32", **kw)

    names = ("router", "wi", "wg", "wo")
    for tag, dp, mp_, fsdp in EP_CASES:
        cfg = jcfg(moe_impl="ep", fsdp_params=fsdp)
        mesh = Mesh(devs[:dp * mp_].reshape(dp, mp_), ("data", "model"))

        def loss(p, x, cfg=cfg, mesh=mesh):
            y, aux = JM.apply_moe_ep(cfg, p, x, mesh)
            return jnp.sum(y * a["moe_c"]) + aux, (y, aux)

        p = {k: jnp.asarray(a[f"moe_{k}"]) for k in names}
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(a["moe_x"]))
        res[f"{tag}_y"], res[f"{tag}_aux"] = np.asarray(y), np.asarray(aux)
        res[f"{tag}_gx"] = np.asarray(gx)
        for k in names:
            res[f"{tag}_g{k}"] = np.asarray(gp[k])

    from repro.models import transformer as JT
    from repro.models.params import is_def as jax_is_def
    from repro.models.params import shardings_for as jax_shardings
    tp_mesh = Mesh(devs[:2].reshape(1, 2), ("data", "model"))

    def tp_tree(cfg, tag):
        defs = JT.param_defs(cfg)
        leaves, treedef = jax.tree_util.tree_flatten(defs, is_leaf=jax_is_def)
        tree = jax.tree_util.tree_unflatten(
            treedef, [a[f"tp_{tag}_w{i}"] for i in range(len(leaves))])
        return jax.device_put(tree, jax_shardings(defs, tp_mesh))

    def tp_jcfg(tag):
        name, kw = TP_ARCHS[tag]
        return dataclasses.replace(jax_arch(name).reduced(),
                                   dtype="float32", **kw)

    cfg = tp_jcfg("llama")
    p = tp_tree(cfg, "llama")
    toks = a["tp_tokens"]
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    with tp_mesh:
        logits, _ = jax.jit(lambda p, t: JT.forward_full(cfg, p, t))(
            p, batch["tokens"])
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(cfg, p, b), has_aux=True))(p, batch)
    res["tp_logits"], res["tp_loss"] = np.asarray(logits), float(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        res[f"tp_g{i}"] = np.asarray(g)
    for tag in ("granite", "qwen", "qwen_ep"):
        cfg = tp_jcfg(tag)
        p = tp_tree(cfg, tag.split("_")[0])
        cdefs = JT.cache_defs(cfg, TP_B, TP_LEN)
        cache = jax.device_put(
            jax.tree.map(lambda pd: jnp.zeros(pd.shape, pd.dtype), cdefs,
                         is_leaf=jax_is_def), jax_shardings(cdefs, tp_mesh))
        step = jax.jit(lambda p, t, c, n, cfg=cfg: JT.decode_step(
            cfg, p, t, c, n))
        lens, steps = jnp.zeros((TP_B,), jnp.int32), []
        with tp_mesh:
            for t in range(TP_STEPS):
                logits, cache = step(p, jnp.asarray(a["tp_dec"][:, t:t + 1]),
                                     cache, lens)
                lens = lens + 1
                steps.append(np.asarray(logits))
        res[f"tpdec_{tag}"] = np.stack(steps)

    cfg = dataclasses.replace(jax_arch("granite-20b").reduced(),
                              dtype="float32")
    for m in (2, 4):
        mesh = Mesh(devs[:m].reshape(1, m), ("data", "model"))
        fn = jax.jit(lambda q, k, v, n, mesh=mesh: JA.decode_attention(
            cfg, q, k, v, n, mesh))
        res[f"dec{m}"] = np.asarray(fn(a["dec_q"], a["dec_k"], a["dec_v"],
                                       a["dec_lens"]))

    from repro.sharding.axes import logical_sharding as jax_sharding
    pf = {k[3:]: v for k, v in a.items() if k.startswith("pf_")}
    cache_axes = ("batch", "kv_heads", "kv_seq", "head_dim")
    for m in (2, 4):
        mesh = Mesh(devs[:m].reshape(1, m), ("data", "model"))
        for case in PF_CASES:
            kv, cache, inp = _pf_case(case, pf)
            cfg = dataclasses.replace(jax_arch("granite-20b").reduced(),
                                      dtype="float32", kv_dtype=kv)
            cache = {k: jax.device_put(v, jax_sharding(
                v.shape, cache_axes[:v.ndim], mesh)) for k, v in cache.items()}
            p = {k: jnp.asarray(pf[k]) for k in ("wq", "wk", "wv", "wo")}
            if case == "cached_int8":
                fn = jax.jit(lambda p, x, c, v, cfg=cfg:
                             JA.attention_prefill_cached(cfg, p, x, c, v,
                                                         PF["off"]))
                args = (inp["x"], cache, inp["tok_valid"])
            else:
                fn = jax.jit(lambda p, x, c, *lay, cfg=cfg, span=inp["span"]:
                             JA.attention_prefill_packed(
                                 cfg, p, x, c, *lay, prefix_span=span))
                args = (inp["x"], cache) + tuple(inp[k] for k in (
                    "seg_slot", "seg_pos", "seg_ids", "valid", "row_slot",
                    "prefix_len"))
            with mesh:
                o, new = fn(p, *args)
            res[f"pf{m}_{case}_out"] = np.asarray(o)
            for k, v in new.items():
                res[f"pf{m}_{case}_{k}"] = np.asarray(v)

    cfg = jcfg(capacity_factor=GROUP_CF)
    mesh = Mesh(devs[:2].reshape(2, 1), ("data", "model"))
    p = {k: jnp.asarray(a[f"grp_{k}"]) for k in names}
    with mesh:
        y, aux = jax.jit(lambda p, x: JM.apply_moe(cfg, p, x))(
            p, jnp.asarray(a["grp_x"]))
    res["grp_y"], res["grp_aux"] = np.asarray(y), np.asarray(aux)

    for n in (2, 4):
        mesh = Mesh(devs[:n].reshape(n, 1), ("data", "model"))
        g = jax.tree.map(jnp.asarray, _grad_inputs(0, equal=True))
        e = jax.tree.map(jnp.asarray, _err_inputs(0))
        mean, err = jax.jit(lambda g, e, mesh=mesh:
                            JC.compressed_grad_allreduce(g, e, mesh))(g, e)
        res[f"cmp{n}_w"], res[f"cmp{n}_s"] = (np.asarray(mean["w"]),
                                              np.asarray(mean["b"]["s"]))
        res[f"cmp{n}_ew"] = np.asarray(err["w"])
    np.savez(out, **res)


def _start_reference(tmp: Path):
    inp, out = tmp / "ref_in.npz", tmp / "ref_out.npz"
    _write_inputs(inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]))
    code = ("import test_torch_multirank as m; "
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
# ranks
# --------------------------------------------------------------------------- #
def _spawn(fn, world: int, tmp: Path):
    """Run ``fn(rank, world, tmp)`` on ``world`` gloo ranks; each rank
    saves ``tmp/rank<r>.npz``. Returns the ranks' dicts."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(SPAWN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"ranks outlived {SPAWN_S} s"
    assert [p.exitcode for p in procs] == [0] * world, \
        (tmp / "errors.txt").read_text() if (tmp / "errors.txt").exists() \
        else [p.exitcode for p in procs]
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=True))
            for r in range(world)]


def _rank_entry(fn, rank, world, tmp):
    import datetime
    import traceback

    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        out = fn(rank, world, Path(tmp))
        np.savez(Path(tmp) / f"rank{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(Path(tmp) / "errors.txt", "a") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}\n")
        os._exit(1)


def _parts(tree, specs, mesh):
    """A rank's parts made complete: each leaf summed over the mesh axes
    that replicate it."""
    from repro_torch.sharding import comm
    from repro_torch.train.step import _sharded

    def one(g, spec):
        for a in mesh.axis_names:
            if a not in _sharded(spec):
                g = comm.psum_raw(g, mesh, a)
        return g
    return tree_map(one, tree, specs)


def _ep_on_ranks(mesh, cfg, a, out, tag):
    """apply_moe_ep's loss share, output and gradients on this rank."""
    from repro_torch.models.params import resident_specs, shard_tree
    from repro_torch.sharding import comm

    defs = M.moe_defs(cfg)
    full = {k: torch.from_numpy(a[f"moe_{k}"])
            for k in ("router", "wi", "wg", "wo")}
    specs = resident_specs(defs, mesh, ("experts", "fsdp"))
    p = tree_map(lambda t: t.clone().requires_grad_(),
                 shard_tree(full, defs, mesh, ("experts", "fsdp")))
    di, dn = comm.axis_index(mesh, "data"), comm.axis_size(mesh, "data")
    rows = slice(di * EP_B // dn, (di + 1) * EP_B // dn)
    x = torch.from_numpy(a["moe_x"][rows]).requires_grad_()
    c = torch.from_numpy(a["moe_c"][rows])
    y, aux = M.apply_moe_ep(cfg, p, x, mesh)
    # the rank's share: its tokens' term over their model replicas, the
    # replicated balance loss over every rank
    share = (y * c).sum() / comm.axis_size(mesh, "model") + aux / mesh.size
    share.backward()
    grads = _parts({k: v.grad for k, v in p.items()}, specs, mesh)
    gx = comm.psum_raw(x.grad, mesh, "model")
    out[f"{tag}_y"], out[f"{tag}_aux"] = y.detach().numpy(), float(aux)
    out[f"{tag}_gx"] = gx.numpy()
    for k, g in grads.items():
        out[f"{tag}_g{k}"] = g.numpy()
    out[f"{tag}_coords"] = json.dumps(mesh.coords())


def _decode_on_ranks(mesh, a, out, tag):
    from repro_torch.models import attention as A
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh
    cfg = dataclasses.replace(get_arch("granite-20b").reduced(),
                              dtype="float32")
    comm.reset_stats()
    m, i = comm.axis_size(mesh, "model"), comm.axis_index(mesh, "model")
    S_loc = DEC["S"] // m
    k = torch.from_numpy(a["dec_k"][:, :, i * S_loc:(i + 1) * S_loc].copy())
    v = torch.from_numpy(a["dec_v"][:, :, i * S_loc:(i + 1) * S_loc].copy())
    with use_mesh(mesh):
        o = A.decode_attention(cfg, torch.from_numpy(a["dec_q"]), k, v,
                               torch.from_numpy(a["dec_lens"]))
    out[tag] = o.numpy()
    out[f"{tag}_collectives"] = comm.stats()["collectives"]


def _compression_on_ranks(mesh, rank, out, tag):
    from repro_torch.train import compression
    for equal in (False, True):
        g = tree_map(torch.from_numpy, _grad_inputs(rank, equal))
        e = tree_map(torch.from_numpy, _err_inputs(0 if equal else rank))
        mean, err = compression.compressed_grad_allreduce(g, e, mesh)
        key = f"{tag}_{'eq' if equal else 'rk'}"
        out[f"{key}_w"], out[f"{key}_s"] = (mean["w"].numpy(),
                                            mean["b"]["s"].numpy())
        out[f"{key}_ew"], out[f"{key}_es"] = (err["w"].numpy(),
                                              err["b"]["s"].numpy())


def _four_ranks(rank, world, tmp):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import resident_specs, shard_tree
    from repro_torch.optim.adamw import global_norm
    a = dict(np.load(tmp.parent / "ref_in.npz"))
    out = {}
    meshes = {(2, 2): make_host_mesh(model=2), (1, 4): make_host_mesh(model=4),
              (4, 1): make_host_mesh(model=1)}
    for tag, dp, mp_, fsdp in EP_CASES:
        cfg = _moe_cfg(moe_impl="ep", fsdp_params=fsdp)
        _ep_on_ranks(meshes[dp, mp_], cfg, a, out, tag)
    _decode_on_ranks(meshes[1, 4], a, out, "dec4")
    _prefill_b_on_ranks(meshes[1, 4], a, out)
    _compression_on_ranks(meshes[4, 1], rank, out, "cmp4")
    # the clip norm of an EP tree held in parts, fsdp on
    cfg = _moe_cfg(moe_impl="ep", fsdp_params=True)
    defs = T.param_defs(cfg)
    full = init_params(defs, device="cpu", seed=3)
    mesh = meshes[2, 2]
    local = shard_tree(full, defs, mesh, ("experts", "fsdp"))
    out["norm_parts"] = float(global_norm(
        local, resident_specs(defs, mesh, ("experts", "fsdp")), mesh))
    out["norm_full"] = float(global_norm(full))
    return out


def _full_leaves(tree, specs, mesh):
    """Every leaf of a rank's tree made whole: the ranks' parts gathered
    over 'model' and put together by each leaf's spec."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import gather_slices
    out = []
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        parts = comm.gather_parts(leaf.contiguous(), mesh, "model")
        out.append(gather_slices({(0, r): p for r, p in enumerate(parts)},
                                 spec, mesh))
    return out


def _tp_decode(cfg, params, a, mesh=None):
    """TP_STEPS teacher-forced decode steps from an empty cache (the
    rank's part of it under ``mesh``): every step's full logits."""
    from repro_torch.models.params import local_defs, resident_axes
    from repro_torch.sharding import comm
    cache = init_params(local_defs(T.cache_defs(cfg, TP_B, TP_LEN), mesh,
                                   resident_axes(cfg)), device="cpu")
    lens, out = torch.zeros((TP_B,), dtype=torch.int32), []
    for t in range(TP_STEPS):
        logits, cache = T.decode_step(
            cfg, params, torch.from_numpy(a["tp_dec"][:, t:t + 1].copy()),
            cache, lens)
        lens = lens + 1
        out.append(torch.cat(comm.gather_parts(logits, mesh, "model"), -1))
    return torch.stack(out).numpy()


def _tp_batch(a):
    toks = torch.from_numpy(a["tp_tokens"].astype(np.int64))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tp_on_ranks(mesh, a, out):
    """llama3.2-1b's logits, loss and gradients, and the decode logits of
    granite-20b and qwen3-moe, each rank on its tensor-parallel part."""
    from repro_torch.models.params import (resident_axes, resident_specs,
                                           shard_tree)
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh
    from repro_torch.train import loss_and_grads
    from repro_torch.train.step import _reduce_grads
    cfg = _tp_cfg("llama")
    defs, resident = T.param_defs(cfg), resident_axes(cfg)
    local = shard_tree(_tree_of(cfg, a, "tp_llama"), defs, mesh, resident)
    specs = resident_specs(defs, mesh, resident)
    batch = _tp_batch(a)
    with use_mesh(mesh):
        logits, _ = T.forward_full(cfg, local, batch["tokens"])
        loss, _, grads = loss_and_grads(cfg, local, batch)
    out["tp_logits"] = torch.cat(comm.gather_parts(logits, mesh, "model"),
                                 -1).numpy()
    out["tp_loss"] = float(loss)
    # the train step's reduction: a replicated leaf summed over 'model',
    # every leaf divided by the mesh's size
    grads = _reduce_grads(grads, specs, mesh, mesh.axis_names, mesh.size)
    for i, g in enumerate(_full_leaves(grads, specs, mesh)):
        out[f"tp_g{i}"] = g.numpy()
    for tag in ("granite", "qwen", "qwen_ep"):
        cfg = _tp_cfg(tag)
        defs = T.param_defs(cfg)
        local = shard_tree(_tree_of(cfg, a, f"tp_{tag.split('_')[0]}"), defs,
                           mesh, resident_axes(cfg))
        comm.reset_stats()
        with use_mesh(mesh):
            out[f"tpdec_{tag}"] = _tp_decode(cfg, local, a, mesh)
        out[f"tpdec_{tag}_comm"] = comm.stats()["collectives"]


# the engines on (1, 2): llama3.2-1b's (layout A) and granite-20b's
# (layout B) packed, int8 and both
TP_SERVES = {"batched": ("llama", {}, {}),
             "packed": ("llama", {}, {"pack": True}),
             "fused": ("llama", {}, {"policy": "interleaved", "fuse": True,
                                     "superstep": 4}),
             "int8": ("llama", {"kv_dtype": "int8"}, {}),
             "granite_packed": ("granite", {}, {"pack": True}),
             "granite_int8": ("granite", {"kv_dtype": "int8"}, {}),
             "granite_packed_int8": ("granite", {"kv_dtype": "int8"},
                                     {"pack": True})}


def _tp_serve_params(kind):
    arch, cfg_kw, scfg_kw = TP_SERVES[kind]
    cfg = dataclasses.replace(_tp_cfg(arch), **cfg_kw)
    return cfg, tree_map(lambda t: t.float(), init_params(
        T.param_defs(cfg), device="cpu", seed=8)), scfg_kw


def _tp_serves(mesh, out):
    """The ``TP_SERVES`` engines on the rank's tensor-parallel part."""
    from repro_torch.models.params import resident_axes, shard_tree
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh
    for kind in TP_SERVES:
        cfg, params, scfg_kw = _tp_serve_params(kind)
        local = shard_tree(params, T.param_defs(cfg), mesh,
                           resident_axes(cfg))
        comm.reset_stats()
        with use_mesh(mesh):
            serve = _serve(cfg, local, **scfg_kw)
        out[f"tpserve_{kind}"] = json.dumps(
            dict(serve, comm=comm.stats()["collectives"]))


def _tp_optim(mesh, out):
    """AdamW and Adafactor on the ranks' parts of llama3.2-1b against the
    full tree's update, the worst difference of any leaf."""
    from repro_torch.models.params import (resident_axes, resident_specs,
                                           shard_tree, tree_leaves)
    from repro_torch.optim import (AdafactorConfig, AdamWConfig,
                                   adafactor_init, adafactor_update,
                                   adamw_init, adamw_update)
    cfg = _tp_cfg("llama")
    defs, resident = T.param_defs(cfg), resident_axes(cfg)
    full = tree_map(lambda t: t.float(), init_params(defs, device="cpu",
                                                     seed=9))
    rng = np.random.default_rng(10)
    grads = tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)), full)
    specs = resident_specs(defs, mesh, resident)
    part = lambda tree: shard_tree(tree, defs, mesh, resident)  # noqa: E731
    for name, init, update, ocfg in (
            ("adamw", adamw_init, adamw_update, AdamWConfig()),
            ("adafactor", adafactor_init, adafactor_update,
             AdafactorConfig(weight_decay=0.1))):
        want = update(full, grads, init(full), 1e-2, ocfg)[0]
        got = update(part(full), part(grads), init(part(full)), 1e-2, ocfg,
                     specs, mesh)[0]
        out[f"tpopt_{name}"] = max(
            float((g - w).abs().max()) for g, w in zip(
                tree_leaves(got), tree_leaves(part(want))))
        out[f"tpopt_{name}_moved"] = max(
            float((g - w).abs().max()) for g, w in zip(
                tree_leaves(got), tree_leaves(part(full))))


def _two_ranks(rank, world, tmp):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import resident_axes, shard_tree
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import comm
    from repro_torch.sharding.axes import use_mesh
    from repro_torch.train import TrainStepConfig, make_train_step
    a = dict(np.load(tmp.parent / "ref_in.npz"))
    out = {}
    model2, data2 = make_host_mesh(model=2), make_host_mesh(model=1)
    # the collectives and their backwards (the sum convention)
    w = torch.arange(1.0, 5.0)
    for name, fn in (("max", comm.pmax), ("sum", comm.psum)):
        x = torch.tensor([float(rank), 5.0 - rank], requires_grad=True)
        y = fn(x, model2, "model")
        (y * w[:2]).sum().backward()
        out[f"c_{name}_y"], out[f"c_{name}_dx"] = (y.detach().numpy(),
                                                   x.grad.numpy())
    x = torch.tensor([float(rank), 5.0 - rank], requires_grad=True)
    y = comm.all_gather(x, model2, "model", dim=0)
    (y * w).sum().backward()
    out["c_gather_y"], out["c_gather_dx"] = y.detach().numpy(), \
        x.grad.numpy()
    out["c_index"] = comm.axis_index(model2, "model")
    _decode_on_ranks(model2, a, out, "dec2")
    _prefill_b_on_ranks(model2, a, out)
    _compression_on_ranks(data2, rank, out, "cmp2")
    # MoE routing under (2, 1): each rank its half of the batch
    cfg = _moe_cfg(capacity_factor=GROUP_CF)
    p = {k: torch.from_numpy(a[f"grp_{k}"])
         for k in ("router", "wi", "wg", "wo")}
    half = GROUP_B // 2
    with use_mesh(data2):
        y, aux = M.apply_moe(cfg, p, torch.from_numpy(
            a["grp_x"][rank * half:(rank + 1) * half]))
    out["grp_y"], out["grp_aux"] = y.numpy(), float(aux)
    # granite-20b .reduced() (KH 1) served on (1, 2): layout B
    gcfg = dataclasses.replace(get_arch("granite-20b").reduced(),
                               dtype="float32")
    params = tree_map(lambda t: t.float(), init_params(
        T.param_defs(gcfg), device="cpu", seed=5))
    comm.reset_stats()
    with use_mesh(model2):
        serve = _serve(gcfg, shard_tree(params, T.param_defs(gcfg), model2,
                                        resident_axes(gcfg)))
    out["serve"] = json.dumps(dict(serve, comm=comm.stats()["collectives"]))
    # the data-parallel step on (2, 1)
    lcfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               dtype="float32")
    params = tree_map(lambda t: t.float(), init_params(
        T.param_defs(lcfg), device="cpu", seed=6))
    step = make_train_step(lcfg, TrainStepConfig(
        learning_rate=lambda s: 1e-3), data2, device="cpu")
    new, _, m = step(params, adamw_init(params), _dp_batch(lcfg))
    for k, v in m.items():
        out[f"dp_{k}"] = float(v)
    for i, leaf in enumerate(_leaves(new)):
        out[f"dp_p{i}"] = leaf.numpy()
    _tp_on_ranks(model2, a, out)
    _tp_serves(model2, out)
    _tp_optim(model2, out)
    return out


def _leaves(tree):
    from repro_torch.models.params import tree_leaves
    return tree_leaves(tree)


def _dp_batch(cfg):
    from repro_torch.data import SyntheticLM
    return SyntheticLM(cfg.vocab_size, 16, 4, seed=0).batch(0)


SERVE_PROMPTS = (9, 40, 23)


class _PrefixCount:
    """Recorder hooks that count the packed prefill dispatches with a
    prefix (``prefix_span`` > 0: a layout-B cache gathers it)."""

    def __init__(self):
        self.n = 0

    def bind(self, engine) -> None:
        pass

    def on_prefill(self, step, *, kv, chunk, packed=False, **_):
        self.n += int(packed and kv > chunk)

    def __getattr__(self, hook):
        return lambda *a, **k: None


def _serve(cfg, params, **scfg_kw):
    from repro_torch.serve import ServeConfig, ServeEngine
    count = _PrefixCount()
    eng = ServeEngine(cfg, params, ServeConfig(
        max_slots=4, max_len=64, prefill_chunk=16, **scfg_kw),
        recorder=count, device="cpu")
    rng = np.random.default_rng(7)
    for n in SERVE_PROMPTS:
        eng.add_request(rng.integers(0, cfg.vocab_size, n),
                        max_new_tokens=12)
    res = eng.run_until_done()
    return dict(tokens={str(k): [int(t) for t in v] for k, v in res.items()},
                dispatches=dict(eng.dispatch_counts),
                host_syncs=eng.host_syncs, prefix_dispatches=count.n)


# --------------------------------------------------------------------------- #
# fixtures: the reference's subprocess runs while the ranks do
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank")
    proc, out = _start_reference(tmp)
    try:
        four_dir, two_dir = tmp / "four", tmp / "two"
        four_dir.mkdir()
        two_dir.mkdir()
        four = _spawn(_four_ranks, 4, four_dir)
        two = _spawn(_two_ranks, 2, two_dir)
    except BaseException:
        proc.kill()
        raise
    ref = _finish_reference(proc, out)
    return dict(ref=ref, four=four, two=two,
                inputs=dict(np.load(tmp / "ref_in.npz")))


# --------------------------------------------------------------------------- #
# the collectives
# --------------------------------------------------------------------------- #
def test_collectives_and_their_gradients_on_two_ranks(runs):
    """pmax, psum and a tiled all_gather over 'model' on 2 ranks, each
    rank's x = (rank, 5 - rank) and loss sum(y * w): every rank gets the
    same y; psum's backward sums the ranks' cotangents, all_gather's keeps
    the rank's part of their sum, pmax's sends it where x is the max."""
    w = np.arange(1.0, 5.0)
    for r, res in enumerate(runs["two"]):
        assert int(res["c_index"]) == r
        np.testing.assert_array_equal(res["c_max_y"], [1.0, 5.0])
        np.testing.assert_array_equal(res["c_sum_y"], [1.0, 9.0])
        np.testing.assert_array_equal(res["c_gather_y"], [0, 5, 1, 4])
        np.testing.assert_array_equal(res["c_sum_dx"], 2 * w[:2])
        np.testing.assert_array_equal(res["c_gather_dx"],
                                      2 * w[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            res["c_max_dx"], [0.0, 4.0] if r == 0 else [2.0, 0.0])


# --------------------------------------------------------------------------- #
# expert parallelism
# --------------------------------------------------------------------------- #
def _one_rank_moe(a, cfg):
    """The port's one-rank apply_moe: output, aux and the gradients of
    sum(y * c) + aux."""
    p = {k: torch.from_numpy(a[f"moe_{k}"]).requires_grad_()
         for k in ("router", "wi", "wg", "wo")}
    x = torch.from_numpy(a["moe_x"]).requires_grad_()
    y, aux = M.apply_moe(cfg, p, x)
    ((y * torch.from_numpy(a["moe_c"])).sum() + aux).backward()
    out = {"y": y.detach().numpy(), "aux": float(aux.detach()),
           "gx": x.grad.numpy()}
    out.update({f"g{k}": v.grad.numpy() for k, v in p.items()})
    return out


def _assemble(ranks, tag, key, cfg, mesh_shape):
    """A leaf's full value from the ranks' parts (the spec of the EP
    resident layout)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.axes import gather_slices, resident_spec
    mesh = Mesh(mesh_shape, ("data", "model"))
    defs = M.moe_defs(cfg)
    if key == "gx":
        spec = ("data", None, None) if mesh_shape[0] > 1 else (None,) * 3
    elif key == "y":
        spec = ("data", None, None) if mesh_shape[0] > 1 else (None,) * 3
    else:
        pd = defs[key[1:]]
        spec = resident_spec(pd.shape, pd.logical_axes, mesh,
                             ("experts", "fsdp"))
    parts = {}
    for r in ranks:
        c = json.loads(str(r[f"{tag}_coords"]))
        parts[(c["data"], c["model"])] = torch.from_numpy(r[f"{tag}_{key}"])
    return gather_slices(parts, spec, mesh).numpy()


@pytest.mark.parametrize("tag,dp,mp_,fsdp", EP_CASES,
                         ids=[c[0] for c in EP_CASES])
def test_expert_parallel_moe_on_four_ranks(runs, tag, dp, mp_, fsdp):
    """Output, balance loss and every gradient against the reference's
    apply_moe_ep under the same mesh of forced host devices and against
    the port's one-rank apply_moe."""
    cfg = _moe_cfg(moe_impl="ep", fsdp_params=fsdp)
    ref, four = runs["ref"], runs["four"]
    one = _one_rank_moe(runs["inputs"], cfg)
    for key in ("y", "gx", "grouter", "gwi", "gwg", "gwo"):
        got = _assemble(four, tag, key, cfg, (dp, mp_))
        np.testing.assert_allclose(got, ref[f"{tag}_{key}"], **TOL,
                                   err_msg=key)
        np.testing.assert_allclose(got, one[key], **TOL, err_msg=key)
    for r in four:
        np.testing.assert_allclose(float(r[f"{tag}_aux"]),
                                   float(ref[f"{tag}_aux"]), **TOL)
        np.testing.assert_allclose(float(r[f"{tag}_aux"]), one["aux"], **TOL)


def test_clip_norm_of_a_sharded_ep_tree_is_the_full_trees(runs):
    for r in runs["four"]:
        np.testing.assert_allclose(float(r["norm_parts"]),
                                   float(r["norm_full"]), rtol=1e-5)


# --------------------------------------------------------------------------- #
# decode layout B
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("m", [2, 4])
def test_layout_b_decode_matches_the_reference_and_layout_a(runs, m):
    """Each rank's combined output against the reference's layout B and
    the port's layout A on the whole cache; one collective a call."""
    from repro_torch.models import attention as A
    a = runs["inputs"]
    cfg = dataclasses.replace(get_arch("granite-20b").reduced(),
                              dtype="float32")
    layout_a = A.decode_attention(
        cfg, *(torch.from_numpy(a[f"dec_{k}"]) for k in
               ("q", "k", "v", "lens"))).numpy()
    ranks = runs["four"] if m == 4 else runs["two"]
    for r in ranks:
        np.testing.assert_allclose(r[f"dec{m}"], runs["ref"][f"dec{m}"],
                                   **TOL)
        np.testing.assert_allclose(r[f"dec{m}"], layout_a, **TOL)
        assert int(r[f"dec{m}_collectives"]) == 1
    np.testing.assert_array_equal(ranks[0][f"dec{m}"], ranks[-1][f"dec{m}"])


def _assert_shard(got, want, key):
    """A cache shard's cells: float within 1e-5; int8 codes equal, or one
    quantum apart at a rounding tie (at most 1 cell in 1000)."""
    if got.dtype == np.int8:
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, \
            (key, int(diff.max()), int((diff > 0).sum()))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("case", PF_CASES)
@pytest.mark.parametrize("m", [2, 4])
def test_layout_b_prefill_matches_the_reference_and_one_rank(runs, m, case):
    """granite-20b .reduced() (KH 1) in layout B on m ranks, each with its
    share of the query heads: ``attention_prefill_packed`` (a continuation
    lane whose prefix and writes cross shard boundaries, two whole
    prompts, padding; bf16 path in float32 and int8; the whole prompts
    alone, no prefix) and the int8 ``attention_prefill_cached`` (a chunk
    across a boundary, a short row and an idle one). Each rank's output on
    the valid rows against the reference under GSPMD (its cache sharded by
    ``cache_defs``' axes) and the port's one rank; each rank's cache
    shard against the reference's slice of it. The collectives are the
    plan on every rank: the prefix's all-gather (scales included) and
    ``wo``'s psum, or the psum alone without a prefix."""
    a, ref = runs["inputs"], runs["ref"]
    pf = {k[3:]: v for k, v in a.items() if k.startswith("pf_")}
    cfg = dataclasses.replace(get_arch("granite-20b").reduced(),
                              dtype="float32")
    one, one_cache = _pf_port(cfg, case, pf)
    valid = _pf_valid(case, pf)
    want = ref[f"pf{m}_{case}_out"]
    np.testing.assert_allclose(one[valid], want[valid], **TOL)
    S = PF["L"] // m
    plan = 1 if case == "packed_no_prefix" else 2
    ranks = runs["four"] if m == 4 else runs["two"]
    for i, r in enumerate(ranks):
        got = r[f"pf{m}_{case}_out"]
        np.testing.assert_allclose(got[valid], want[valid], **TOL)
        np.testing.assert_allclose(got[valid], one[valid], **TOL)
        for key in one_cache:
            shard = r[f"pf{m}_{case}_{key}"]
            _assert_shard(shard, ref[f"pf{m}_{case}_{key}"][
                :, :, i * S:(i + 1) * S], key)
            _assert_shard(shard, one_cache[key][:, :, i * S:(i + 1) * S],
                          key)
        assert int(r[f"pf{m}_{case}_comm"]) == plan


def test_layout_b_engine_serve_on_two_ranks_matches_one_rank(runs):
    """granite-20b .reduced() (KH 1) on (1, 2), tensor-parallel with its
    cache in layout B: each rank holds 32 of the 64 positions and half the
    heads, d_ff and vocabulary; greedy tokens, dispatches and host syncs
    equal the one-rank engine's. The collectives: a prefill chunk psums
    the embedding, and a layer gathers the prefix and psums ``wo`` and the
    MLP; a decode step also gathers the query heads and combines the
    partials a layer, and merges the sampled argmax."""
    cfg = dataclasses.replace(get_arch("granite-20b").reduced(),
                              dtype="float32")
    params = tree_map(lambda t: t.float(), init_params(
        T.param_defs(cfg), device="cpu", seed=5))
    want = _serve(cfg, params)
    for r in runs["two"]:
        got = json.loads(str(r["serve"]))
        comm = got.pop("comm")
        assert got == want
        dc, n = want["dispatches"], cfg.num_layers
        assert dc.get("fused", 0) == 0
        assert comm == dc["prefill"] * (1 + 3 * n) + dc["decode"] * (2 + 4 * n)


# --------------------------------------------------------------------------- #
# tensor parallelism on (1, 2)
# --------------------------------------------------------------------------- #
def test_tensor_parallel_llama_logits_loss_and_gradients(runs):
    """llama3.2-1b .reduced() with heads, KV heads, d_ff and the tied
    vocabulary split over 'model': the gathered logits, the loss and
    every gradient leaf (after the train step's reduction) against the
    reference under GSPMD on the same weights and the port's one rank."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import loss_and_grads
    a, ref = runs["inputs"], runs["ref"]
    cfg = _tp_cfg("llama")
    full = _tree_of(cfg, a, "tp_llama")
    batch = _tp_batch(a)
    logits, _ = T.forward_full(cfg, full, batch["tokens"])
    loss, _, grads = loss_and_grads(cfg, full, batch)
    grads = [g.numpy() for g in tree_leaves(grads)]
    for r in runs["two"]:
        for want in (ref["tp_logits"], logits.numpy()):
            np.testing.assert_allclose(r["tp_logits"], want, **TOL)
        for want in (ref["tp_loss"], float(loss)):
            np.testing.assert_allclose(float(r["tp_loss"]), float(want),
                                       **TOL)
        for i, g in enumerate(grads):
            np.testing.assert_allclose(r[f"tp_g{i}"], ref[f"tp_g{i}"], **TOL,
                                       err_msg=f"leaf {i}")
            np.testing.assert_allclose(r[f"tp_g{i}"], g, **TOL,
                                       err_msg=f"leaf {i}")


@pytest.mark.parametrize("tag", ["granite", "qwen", "qwen_ep"])
def test_tensor_parallel_decode_logits(runs, tag):
    """10 teacher-forced decode steps on (1, 2): granite-20b (KH 1:
    layout B, the cache's 16 positions over the ranks, the steps crossing
    into the second shard) and qwen3-moe (KH 2 = m: layout A, one KV head
    a rank; its experts split over 'model' by the non-EP path and by
    expert parallelism) against the reference under GSPMD and the port's
    one rank. Both ranks' logits are the same bits."""
    a, ref = runs["inputs"], runs["ref"]
    cfg = _tp_cfg(tag)
    one = _tp_decode(cfg, _tree_of(cfg, a, f"tp_{tag.split('_')[0]}"), a)
    for r in runs["two"]:
        np.testing.assert_allclose(r[f"tpdec_{tag}"], ref[f"tpdec_{tag}"],
                                   **TOL)
        np.testing.assert_allclose(r[f"tpdec_{tag}"], one, **TOL)
        assert int(r[f"tpdec_{tag}_comm"]) > 0
    np.testing.assert_array_equal(runs["two"][0][f"tpdec_{tag}"],
                                  runs["two"][1][f"tpdec_{tag}"])


@pytest.mark.parametrize("kind", list(TP_SERVES))
def test_tensor_parallel_engines_match_one_rank(runs, kind):
    """llama3.2-1b .reduced() served on (1, 2) against the one-rank
    engine: greedy tokens, dispatches and host syncs, batched, packed,
    fused with supersteps of 4 and with the int8 cache; granite-20b
    .reduced() (KH 1, its cache in layout B) packed, with the int8 cache
    and both. The collectives are the plan. llama's batched serve: a
    prefill chunk psums the embedding and two a layer (attention's and the
    MLP's ``wo``), a decode step the same and the sampled argmax's gather.
    granite's: a chunk also gathers the prefix a layer (a packed one only
    where it has one, ``prefix_span`` > 0), a decode step also gathers the
    query heads and combines the partials a layer; int8 costs no more
    collectives than bf16."""
    cfg, params, scfg_kw = _tp_serve_params(kind)
    want = _serve(cfg, params, **scfg_kw)
    dc, n, pack = want["dispatches"], cfg.num_layers, bool(
        scfg_kw.get("pack"))
    for r in runs["two"]:
        got = json.loads(str(r[f"tpserve_{kind}"]))
        comm = got.pop("comm")
        assert got == want
        if kind == "batched":
            assert comm == dc["prefill"] * (1 + 2 * n) \
                + dc["decode"] * (2 + 2 * n)
        elif kind.startswith("granite"):
            assert dc.get("fused", 0) == 0
            assert comm == dc["prefill"] * (1 + (2 if pack else 3) * n) \
                + pack * want["prefix_dispatches"] * n \
                + dc["decode"] * (2 + 4 * n)
    if kind.startswith("granite") and pack:
        assert 0 < want["prefix_dispatches"] <= dc["prefill"]


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_tensor_parallel_optimizers_update_the_full_tree(runs, name):
    """AdamW (its clip norm over the ranks' parts) and Adafactor (its row
    and column means and its RMS over sharded dims) on the ranks' parts
    give each rank its part of the full tree's update."""
    for r in runs["two"]:
        assert float(r[f"tpopt_{name}"]) <= 1e-6
        assert float(r[f"tpopt_{name}_moved"]) > 1e-4


# --------------------------------------------------------------------------- #
# MoE routing groups under a mesh (a repair)
# --------------------------------------------------------------------------- #
def test_moe_routes_one_group_per_data_shard(runs):
    """Under a (2, 1) mesh each rank routes its half of the batch: the
    reference's two groups, capacity drops included; one group over the
    whole batch gives another result."""
    a, ref = runs["inputs"], runs["ref"]
    got = np.concatenate([r["grp_y"] for r in runs["two"]])
    np.testing.assert_allclose(got, ref["grp_y"], **TOL)
    for r in runs["two"]:
        np.testing.assert_allclose(float(r["grp_aux"]), float(ref["grp_aux"]),
                                   **TOL)
    cfg = _moe_cfg(capacity_factor=GROUP_CF)
    p = {k: torch.from_numpy(a[f"grp_{k}"])
         for k in ("router", "wi", "wg", "wo")}
    one, _ = M.apply_moe(cfg, p, torch.from_numpy(a["grp_x"]))
    assert np.abs(one.numpy() - ref["grp_y"]).max() > 1e-2


# --------------------------------------------------------------------------- #
# the compressed all-reduce
# --------------------------------------------------------------------------- #
def _emulate(n):
    """One process, the same arithmetic: amax over ranks, int8 shares
    summed in int32, the mean and each rank's residual."""
    out = {}
    for name, leaf in (("w", lambda t: t["w"]), ("s", lambda t: t["b"]["s"])):
        gs = [leaf(_grad_inputs(r)) + leaf(_err_inputs(r)) for r in range(n)]
        gs = [torch.from_numpy(g) for g in gs]
        amax = torch.stack([g.abs().max() for g in gs]).max()
        scale = torch.clamp(amax / 127.0, min=1e-12)
        qs = [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
              for g in gs]
        total = sum(q.to(torch.int32) for q in qs)
        out[name] = (total.float() * scale / n).numpy()
        out[f"e{name}"] = [(g - q.float() * scale).numpy()
                           for g, q in zip(gs, qs)]
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_allreduce_matches_its_emulation(runs, n):
    ranks = runs["four"] if n == 4 else runs["two"]
    want = _emulate(n)
    for r, res in enumerate(ranks):
        for name in ("w", "s"):
            np.testing.assert_allclose(res[f"cmp{n}_rk_{name}"], want[name],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(res[f"cmp{n}_rk_e{name}"],
                                       want[f"e{name}"][r], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_allreduce_keeps_the_error_feedback_identity(runs, n):
    """Sum over ranks of (dequantized share + new error) equals the sum of
    (gradient + old error): n * mean + sum of residuals."""
    ranks = runs["four"] if n == 4 else runs["two"]
    for name, leaf in (("w", lambda t: t["w"]), ("s", lambda t: t["b"]["s"])):
        lhs = n * ranks[0][f"cmp{n}_rk_{name}"] + sum(
            r[f"cmp{n}_rk_e{name}"] for r in ranks)
        rhs = sum(leaf(_grad_inputs(r)) + leaf(_err_inputs(r))
                  for r in range(n))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_equal_gradients_give_the_references_replicated_result(runs, n):
    ranks = runs["four"] if n == 4 else runs["two"]
    ref = runs["ref"]
    for r in ranks:
        np.testing.assert_allclose(r[f"cmp{n}_eq_w"], ref[f"cmp{n}_w"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r[f"cmp{n}_eq_s"], ref[f"cmp{n}_s"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r[f"cmp{n}_eq_ew"], ref[f"cmp{n}_ew"],
                                   rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# data-parallel training
# --------------------------------------------------------------------------- #
def test_data_parallel_step_on_two_ranks_is_the_whole_batch_step(runs):
    """One AdamW step on (2, 1), each rank 2 of the 4 rows, against the
    one-rank step on all 4: loss, gradient norm and every parameter."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainStepConfig, make_train_step
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32")
    params = tree_map(lambda t: t.float(), init_params(
        T.param_defs(cfg), device="cpu", seed=6))
    step = make_train_step(cfg, TrainStepConfig(
        learning_rate=lambda s: 1e-3), device="cpu")
    new, _, m = step(params, adamw_init(params), _dp_batch(cfg))
    for r in runs["two"]:
        for k in ("loss", "nll", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(r[f"dp_{k}"]), float(m[k]),
                                       **TOL, err_msg=k)
        for i, leaf in enumerate(_leaves(new)):
            np.testing.assert_allclose(r[f"dp_p{i}"], leaf.numpy(), **TOL)


def _launcher_rank(rank, world, tmp, port):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from repro_torch.launch import train
    losses = train.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                         "cpu", "--steps", "3", "--batch", "4", "--seq",
                         "16", "--ckpt-dir", str(tmp / f"ckpt{rank}"),
                         "--ckpt-every", "1", "--log-every", "1"])
    (tmp / f"losses{rank}.json").write_text(json.dumps(losses))


def test_launcher_trains_on_two_ranks(tmp_path):
    """``launch.train --smoke`` as ``torchrun --nproc-per-node 2`` starts
    it: both ranks see the same losses; only rank 0 writes checkpoints
    (each rank was given a directory of its own)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_launcher_rank, args=(r, 2, tmp_path, port))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(SPAWN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    l0, l1 = (json.loads((tmp_path / f"losses{r}.json").read_text())
              for r in range(2))
    assert len(l0) == 3 and l0 == l1
    assert any((tmp_path / "ckpt0").iterdir())
    assert not (tmp_path / "ckpt1").exists() or \
        not any((tmp_path / "ckpt1").iterdir())
