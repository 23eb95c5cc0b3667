"""Port parity for the ``hybrid`` family: the Mamba half of
``repro_torch.models.ssm`` and the jamba-v0.1-52b stack of
``repro_torch.models.transformer`` against the reference on the CPU, at
jamba ``.reduced()`` (layers mamba/dense, attn/moe, mamba/dense, attn/moe:
superblock period 2), with float32 weights and ``dtype="float32"``.

Weights are drawn from a numpy seed, so that they are the same in every
process (the reference's ``init_params`` folds ``hash()`` of each leaf's
path into its key), with the reference's zero-initialized conv bias drawn
too, so that it counts. Modules agree within 1e-4 (f32: the frameworks sum
in another order, and the full-sequence scan runs the plain version of the
``mamba_chunk`` kernel, a sequential scan, where the reference runs an
associative one). The engines give identical greedy tokens and counters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import params as JP
from repro.models import ssm as JS
from repro.models import transformer as RT
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.trace import TraceRecorder
from repro.verify import lint_trace
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch.steps import step_fn_for
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_tree
from repro_torch.serve import ServeConfig, ServeEngine

NAME = "jamba-v0.1-52b"
TOL = dict(rtol=1e-4, atol=1e-4)
# leaves the reference initializes to zero, drawn here so that they count
DRAWN = {"conv_b": 0.5}


def _cfgs(**kw):
    ref = dataclasses.replace(jax_arch(NAME).reduced(), dtype="float32",
                              **kw)
    port = dataclasses.replace(get_arch(NAME).reduced(), dtype="float32",
                               **kw)
    return ref, port


def _np_leaf(name, pd, rng):
    """A float32 leaf drawn as the reference's ``_materialize`` draws it,
    or from ``DRAWN`` for the zero-initialized leaves."""
    if name in DRAWN:
        return (rng.standard_normal(pd.shape) * DRAWN[name]
                ).astype(np.float32)
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    if pd.init == "decay":
        return (np.log(rng.uniform(1e-3, 1.0, pd.shape)) * pd.scale
                ).astype(np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


def _params(seed=0):
    ref, _ = _cfgs()
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        RT.param_defs(ref), is_leaf=lambda x: hasattr(x, "fan_in"))
    p = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(_np_leaf(path[-1].key, pd, rng)) for path, pd in leaves])
    return p, from_jax_tree(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def params():
    return _params()


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _mamba0(p, tp):
    """Layer 0's Mamba leaves of both trees (position 0 is mamba/dense)."""
    return ({k: v[0] for k, v in p["blocks"]["pos0"]["mamba"].items()},
            {k: v[0] for k, v in tp["blocks"]["pos0"]["mamba"].items()})


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_tree(got, want):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)


@pytest.mark.parametrize("T_,stateful", [(16, False), (1, True), (3, True)])
def test_causal_depthwise_conv_matches_reference(params, T_, stateful):
    _, cfg = _cfgs()
    pj, pt = _mamba0(*params)
    B, di, cw = 2, cfg.d_inner, cfg.ssm_conv
    x = _x((B, T_, di), 1)
    st = _x((B, cw - 1, di), 2) if stateful else None
    want, wst = JS._causal_depthwise_conv(
        jnp.asarray(x), pj["conv_w"], pj["conv_b"],
        None if st is None else jnp.asarray(st))
    got, gst = S._causal_depthwise_conv(
        torch.from_numpy(x), pt["conv_w"], pt["conv_b"],
        None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), **TOL)


@pytest.mark.parametrize("T_,stateful", [(16, False), (1, False), (1, True),
                                         (16, True)])
def test_mamba_mix_matches_reference(params, T_, stateful):
    """From a zero state over a sequence or one token (the mamba_chunk
    path), and from a carried state one token at a time (the decode path,
    GEMV products) or over a sequence."""
    ref, cfg = _cfgs()
    pj, pt = _mamba0(*params)
    B, d = 2, cfg.d_model
    x = _x((B, T_, d), 3)
    st = {"conv": _x((B, cfg.ssm_conv - 1, cfg.d_inner), 4, 0.5),
          "ssm": _x((B, cfg.d_inner, cfg.ssm_d_state), 5, 0.5)} \
        if stateful else None
    want, wst = JS.mamba_mix(
        ref, pj, jnp.asarray(x),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    got, gst = S.mamba_mix(
        cfg, pt, torch.from_numpy(x),
        None if st is None else {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_tree(gst, wst)


def test_mamba_mix_keeps_the_chunk_shape_rule(params):
    """T % min(ssm_chunk, T) == 0, as the reference's scan asserts."""
    _, cfg = _cfgs()
    _, pt = _mamba0(*params)
    with pytest.raises(ValueError, match="ssm_chunk"):
        S.mamba_mix(cfg, pt, torch.zeros((1, cfg.ssm_chunk + 5,
                                          cfg.d_model)))


def test_mamba_mix_sends_its_zero_state_scan_to_mamba_chunk(params,
                                                             monkeypatch):
    """The stateless scan goes to ops.mamba_chunk once, with the
    discretized (B, T, d_inner, d_state) f32 operands; the stateful scan
    never does."""
    _, cfg = _cfgs()
    _, pt = _mamba0(*params)
    calls = []
    orig = ops.mamba_chunk
    monkeypatch.setattr(ops, "mamba_chunk", lambda a, u, C: calls.append(
        (tuple(a.shape), a.dtype, tuple(C.shape))) or orig(a, u, C))
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 6))
    S.mamba_mix(cfg, pt, x)
    di, n = cfg.d_inner, cfg.ssm_d_state
    assert calls == [((2, 16, di, n), torch.float32, (2, 16, n))]
    S.mamba_mix(cfg, pt, x[:, :1], state={
        "conv": torch.zeros((2, cfg.ssm_conv - 1, di)),
        "ssm": torch.zeros((2, di, n))})
    assert len(calls) == 1


@pytest.mark.parametrize("last_only", [True, False])
def test_forward_full_matches_reference(params, last_only):
    """The full-sequence forward (the serving prefill step): logits and the
    summed MoE aux loss, and the port's step function for
    ``last_only=True``."""
    ref, cfg = _cfgs()
    p, tp = params
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16))
    want, want_aux = RT.forward_full(ref, p, jnp.asarray(tokens),
                                     last_only=last_only)
    got, got_aux = T.forward_full(cfg, tp, torch.from_numpy(tokens),
                                  last_only=last_only)
    assert got.shape == want.shape and float(got_aux) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    if last_only:
        step = step_fn_for(cfg, "prefill", device="cpu")
        np.testing.assert_allclose(step(tp, {"tokens": tokens}).numpy(),
                                   np.asarray(want)[:, -1], **TOL)


def test_forward_full_runs_mamba_chunk_once_per_mamba_layer(params,
                                                            monkeypatch):
    _, cfg = _cfgs()
    _, tp = params
    calls = []
    orig = ops.mamba_chunk
    monkeypatch.setattr(ops, "mamba_chunk", lambda *a: calls.append(
        tuple(a[0].shape)) or orig(*a))
    T.forward_full(cfg, tp, torch.zeros((2, 8), dtype=torch.long),
                   last_only=True)
    n_mamba = cfg.layer_kinds().count("mamba")
    assert n_mamba == 2
    assert calls == [(2, 8, cfg.d_inner, cfg.ssm_d_state)] * n_mamba


def test_decode_step_matches_reference(params):
    """One token against a random cache: Mamba conv and ssm states, and
    attention K/V at per-slot lengths. Logits and every new cache leaf."""
    ref, cfg = _cfgs()
    p, tp = params
    B, L = 3, 12
    n_super = cfg.num_layers // 2
    KH, hd = cfg.num_kv_heads, cfg.head_dim
    cache = {"pos0": {"conv": _x((n_super, B, cfg.ssm_conv - 1,
                                  cfg.d_inner), 8, 0.5),
                      "ssm": _x((n_super, B, cfg.d_inner,
                                 cfg.ssm_d_state), 9, 0.5)},
             "pos1": {"k": _x((n_super, B, KH, L, hd), 10),
                      "v": _x((n_super, B, KH, L, hd), 11)}}
    tokens = np.array([[3], [200], [17]], np.int32)
    lens = np.array([0, 5, 11], np.int32)
    want, wc = RT.decode_step(ref, p, jnp.asarray(tokens),
                              jax.tree.map(jnp.asarray, cache),
                              jnp.asarray(lens))
    got, gc = T.decode_step(cfg, tp, torch.from_numpy(tokens),
                            from_jax_tree(cache), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for pos in ("pos0", "pos1"):
        _assert_tree(gc[pos], wc[pos])


@pytest.mark.parametrize("width", ["reduced", "depth8"])
def test_param_and_cache_defs_match_reference(width):
    """Keys, shapes, axes, inits and dtypes of every leaf, at ``.reduced()``
    and at the full width cut to depth 8 (one whole Jamba period: attention
    at layer 4, MoE on layers 1, 3, 5, 7), the configuration served on one
    card."""
    ref, port = jax_arch(NAME), get_arch(NAME)
    if width == "reduced":
        ref, port = ref.reduced(), port.reduced()
    else:
        ref = dataclasses.replace(ref, num_layers=8)
        port = dataclasses.replace(port, num_layers=8)
        assert T.superblock_period(port) == 8
    for want_tree, got_tree in ((RT.param_defs(ref), T.param_defs(port)),
                                (RT.cache_defs(ref, 8, 256),
                                 T.cache_defs(port, 8, 256))):
        want, got = dict(_leaves(want_tree)), dict(_leaves(got_tree))
        assert sorted(want) == sorted(got)
        for path, pd in want.items():
            assert dataclasses.astuple(got[path]) == dataclasses.astuple(pd), \
                path


@pytest.mark.parametrize("layers,dtype_bytes,want", [
    (32, 2, 103_140_630_528),   # the published model in bf16: no 80 GB card
    (8, 2, 26_590_470_144),     # one whole period, served on one card
    (2, 4, 14_715_764_736),     # the float32 parity config, each side
])
def test_jamba_weight_bytes(layers, dtype_bytes, want):
    """The weight bytes of jamba-v0.1-52b at full width, from the
    reference's and the port's ``param_defs`` alike."""
    kw = dict(num_layers=layers)
    if layers == 2:
        kw.update(attn_period=2, attn_offset=1)
    for defs in (RT.param_defs(dataclasses.replace(jax_arch(NAME), **kw)),
                 T.param_defs(dataclasses.replace(get_arch(NAME), **kw))):
        n = sum(int(np.prod(pd.shape)) for _, pd in _leaves(defs))
        assert n * dtype_bytes == want


def test_bf16_hybrid_tree_crosses_leaf_by_leaf():
    """The untouched reference tree (bf16 leaves: blocks/pos{j}/{norm1,
    mamba|attn, norm2, ffn} with the MoE router/wi/wg/wo) arrives with the
    same nesting, shapes, dtypes and bits."""
    cfg = jax_arch(NAME).reduced()
    p = JP.init_params(RT.param_defs(cfg), jax.random.PRNGKey(0))
    tp = from_jax_tree(jax.tree.map(np.asarray, p))
    want, got = dict(_leaves(p)), dict(_leaves(tp))
    assert sorted(want) == sorted(got)
    assert ("blocks", "pos1", "ffn", "router") in got
    assert ("blocks", "pos0", "mamba", "a_log") in got
    for path, a in want.items():
        assert got[path].dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got[path].float().numpy(),
                                      np.asarray(a, np.float32))


def _serve(engine_cls, scfg_cls, cfg, p, prompts, scfg, max_new, **kw):
    rec = TraceRecorder()
    eng = engine_cls(cfg, p, scfg_cls(**scfg), recorder=rec, **kw)
    for pr in prompts:
        eng.add_request(pr, max_new_tokens=max_new)
    return eng.run_until_done(), eng, rec.to_trace()


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_engine_matches_reference_engine(params, mode):
    """The same workload through both engines, traced: a hybrid stack
    prefills sequentially whatever the mode; greedy tokens, counters,
    prefill stats, PAS log and trace events are identical, and the port's
    trace lints clean."""
    ref, cfg = _cfgs()
    p, tp = params
    scfg = dict(max_slots=3, max_len=48, prefill_chunk=8, prefill_mode=mode)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 1, 9, 3)]
    tj, ej, trj = _serve(JaxServeEngine, JaxServeConfig, ref, p, prompts,
                         scfg, 5)
    tt, et, trt = _serve(ServeEngine, ServeConfig, cfg, tp, prompts, scfg, 5,
                         device="cpu")
    assert et.effective_prefill_mode == "sequential"
    assert tt == tj
    assert et.dispatch_counts == ej.dispatch_counts
    assert et.host_syncs == ej.host_syncs
    assert et.async_fetches == ej.async_fetches
    assert et.prefill_stats == ej.prefill_stats
    assert et.pas_log == ej.pas_log
    assert trt.events == trj.events
    assert trt.summary == trj.summary
    assert lint_trace(trt) == []


def test_wave_mates_change_each_others_tokens(params):
    """The reference's sequential prefill feeds token 0 to every other row:
    a wave-mate's prompt enters each slot's Mamba state, and every row
    competes for the MoE capacity. Prompt A served beside B gives other
    tokens than A alone, in both packages, and the port matches the
    reference in both cases (2 slots, prompts of 6 and 9 tokens)."""
    ref, cfg = _cfgs()
    p, tp = params
    rng = np.random.default_rng(10)
    a, b = (rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in (6, 9))
    scfg = dict(max_slots=2, max_len=32, prefill_mode="sequential")
    out = {"jax": {}, "torch": {}}
    for name, prompts in (("alone", [a]), ("beside", [a, b])):
        tj, ej, _ = _serve(JaxServeEngine, JaxServeConfig, ref, p, prompts,
                           scfg, 6)
        tt, et, _ = _serve(ServeEngine, ServeConfig, cfg, tp, prompts, scfg,
                           6, device="cpu")
        assert tt == tj
        assert et.dispatch_counts == ej.dispatch_counts
        out["jax"][name], out["torch"][name] = tj, tt
    for pkg in out.values():
        assert pkg["alone"][0] != pkg["beside"][0]


def test_batched_prefill_through_moe_raises():
    """Batched prefill through MoE FFNs raises where the stack has other
    mixers than attention: jamba's Mamba state is threaded token by token,
    so its engine prefills sequentially. An all-attention stack with MoE
    FFNs (the ``moe`` family's shape) prefills in chunks, its MoE layers
    routing each chunk as one group, as the reference does: here at
    jamba's widths with every layer attention, dense and MoE FFNs
    alternating (``tests/test_torch_configs.py`` holds the ``moe``
    family's engines against the reference)."""
    _, jamba = _cfgs()
    assert not T.supports_batched_prefill(jamba) and jamba.is_moe
    with pytest.raises(NotImplementedError, match="attention mixers"):
        T.prefill_chunk(jamba, {"embed": {}, "blocks": {}},
                        torch.zeros((1, 4), dtype=torch.long), {},
                        torch.ones((1, 4), dtype=torch.bool), offset=0)
    ref, cfg = _cfgs(attn_period=0)
    assert T.supports_batched_prefill(cfg) and cfg.is_moe
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        RT.param_defs(ref), is_leaf=lambda x: hasattr(x, "fan_in"))
    p = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(_np_leaf(path[-1].key, pd, rng)) for path, pd in leaves])
    tp = from_jax_tree(jax.tree.map(np.asarray, p))
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    valid = np.array([[True] * 8, [True] * 5 + [False] * 3])
    want = RT.prefill_chunk(
        ref, p, jnp.asarray(tokens),
        JP.init_params(RT.cache_defs(ref, 2, 16), jax.random.PRNGKey(0)),
        jnp.asarray(valid), offset=0)
    got = T.prefill_chunk(
        cfg, tp, torch.from_numpy(tokens).long(),
        {k: {n: torch.zeros(v.shape) for n, v in c.items()}
         for k, c in T.cache_defs(cfg, 2, 16).items()},
        torch.from_numpy(valid), offset=0)
    for pos in want:
        for leaf in want[pos]:
            np.testing.assert_allclose(got[pos][leaf].numpy(),
                                       np.asarray(want[pos][leaf]), **TOL)
