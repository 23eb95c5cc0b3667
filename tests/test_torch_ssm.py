"""Port parity for the ``ssm`` family: ``repro_torch.models.ssm`` and the
RWKV6 stack of ``repro_torch.models.transformer`` against the reference on
the CPU, at rwkv6-7b ``.reduced()`` (and llama3.2-1b ``.reduced()`` for the
dense ``forward_full``), with float32 weights and ``dtype="float32"``.

Weights are drawn from a numpy seed, so that they are the same in every
process (the reference's ``init_params`` folds ``hash()`` of each leaf's
path into its key), with the reference's zero-initialized interpolation
coefficients, decay LoRA and group-norm bias drawn too, so that every term
of the mixers takes part. Modules agree within 1e-4 (f32: the frameworks
sum in another order, and the full-sequence wkv runs the plain version of
the ``rwkv_chunk`` kernel, a sequential scan, where the reference runs an
associative one). The engines give identical greedy tokens and counters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
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
from repro_torch.models.params import from_jax_tree, init_params
from repro_torch.serve import ServeConfig, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
# leaves the reference initializes to zero, drawn here so that they count
DRAWN = {"mu_r": 0.5, "mu_k": 0.5, "mu_v": 0.5, "mu_g": 0.5, "mu_w": 0.5,
         "mu_ck": 0.5, "mu_cr": 0.5, "w_lora_b": 0.5, "ln_bias": 0.1}


def _cfgs(name="rwkv6-7b", **kw):
    ref = dataclasses.replace(jax_arch(name).reduced(), dtype="float32",
                              **kw)
    port = dataclasses.replace(get_arch(name).reduced(), dtype="float32",
                               **kw)
    return ref, port


def _np_leaf(name, pd, rng):
    """A float32 leaf drawn as the reference's ``_materialize`` draws it,
    or from ``DRAWN`` for the zero-initialized mixer leaves."""
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


def _params(name="rwkv6-7b", seed=0):
    ref, _ = _cfgs(name)
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


def _layer0(p, tp):
    """Layer 0's RWKV leaves of both trees."""
    return ({k: v[0] for k, v in p["blocks"]["pos0"]["rwkv"].items()},
            {k: v[0] for k, v in tp["blocks"]["pos0"]["rwkv"].items()})


def _state(keys, B, H, hd, d, seed):
    shapes = {"shift_tm": (B, d), "shift_cm": (B, d), "wkv": (B, H, hd, hd)}
    return {k: _x(shapes[k], seed + i, 0.5) for i, k in enumerate(keys)}


def _assert_tree(got, want):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)


@pytest.mark.parametrize("T_,stateful", [(16, False), (1, False), (1, True),
                                         (16, True)])
def test_rwkv_time_mix_matches_reference(params, T_, stateful):
    """From a zero state over a sequence or one token (the rwkv_chunk
    path), and from a carried state one token at a time (the decode path,
    GEMV products) or over a sequence."""
    ref, cfg = _cfgs()
    pj, pt = _layer0(*params)
    B, d = 2, cfg.d_model
    x = _x((B, T_, d), 1)
    st = _state(("shift_tm", "wkv"), B, cfg.num_heads, cfg.rwkv_head_dim, d,
                2) if stateful else None
    want, wst = JS.rwkv_time_mix(
        ref, pj, jnp.asarray(x),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    got, gst = S.rwkv_time_mix(
        cfg, pt, torch.from_numpy(x),
        None if st is None else {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_tree(gst, wst)


@pytest.mark.parametrize("T_,stateful", [(16, False), (1, True), (16, True)])
def test_rwkv_channel_mix_matches_reference(params, T_, stateful):
    ref, cfg = _cfgs()
    pj, pt = _layer0(*params)
    B, d = 2, cfg.d_model
    x = _x((B, T_, d), 3)
    st = _state(("shift_cm",), B, 0, 0, d, 4) if stateful else None
    want, wst = JS.rwkv_channel_mix(
        ref, pj, jnp.asarray(x),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    got, gst = S.rwkv_channel_mix(
        cfg, pt, torch.from_numpy(x),
        None if st is None else {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_tree(gst, wst)


def test_rwkv_time_mix_keeps_the_chunk_shape_rule(params):
    """T % min(ssm_chunk, T) == 0, as the reference's scan asserts."""
    _, cfg = _cfgs()
    _, pt = _layer0(*params)
    with pytest.raises(ValueError):
        S.rwkv_time_mix(cfg, pt, torch.zeros((1, cfg.ssm_chunk + 1,
                                              cfg.d_model)))


@pytest.mark.parametrize("name,last_only", [
    ("rwkv6-7b", True), ("rwkv6-7b", False), ("llama3.2-1b", True),
])
def test_forward_full_matches_reference(name, last_only):
    """The full-sequence forward (the serving prefill step), through the
    port's step function for ``last_only=True``."""
    ref, cfg = _cfgs(name)
    p, tp = params_ = _params(name, seed=1)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16))
    want, _ = RT.forward_full(ref, p, jnp.asarray(tokens),
                              last_only=last_only)
    got, aux = T.forward_full(cfg, tp, torch.from_numpy(tokens),
                              last_only=last_only)
    assert float(aux) == 0.0 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if last_only:
        step = step_fn_for(cfg, "prefill", device="cpu")
        np.testing.assert_allclose(step(params_[1], {"tokens": tokens}
                                        ).numpy(),
                                   np.asarray(want)[:, -1], **TOL)


def test_forward_full_runs_rwkv_chunk_once_per_layer(params, monkeypatch):
    """Every layer's time mix sends its wkv to ops.rwkv_chunk (on the CPU,
    its plain version)."""
    _, cfg = _cfgs()
    _, tp = params
    calls = []
    orig = ops.rwkv_chunk
    monkeypatch.setattr(ops, "rwkv_chunk", lambda *a, **k: calls.append(
        tuple(a[0].shape)) or orig(*a, **k))
    T.forward_full(cfg, tp, torch.zeros((2, 16), dtype=torch.long),
                   last_only=True)
    assert calls == [(2 * cfg.num_heads, 16, cfg.rwkv_head_dim)] \
        * cfg.num_layers


def test_decode_step_matches_reference(params):
    """One token against a random recurrent state: logits and the new wkv
    and shift states of every layer."""
    ref, cfg = _cfgs()
    p, tp = params
    B, n, d = 3, cfg.num_layers, cfg.d_model
    H, hd = cfg.num_heads, cfg.rwkv_head_dim
    cache = {"pos0": {"wkv": _x((n, B, H, hd, hd), 6, 0.5),
                      "shift_tm": _x((n, B, d), 7, 0.5),
                      "shift_cm": _x((n, B, d), 8, 0.5)}}
    tokens = np.array([[3], [200], [17]], np.int32)
    lens = np.array([0, 5, 9], np.int32)
    want, wc = RT.decode_step(ref, p, jnp.asarray(tokens),
                              jax.tree.map(jnp.asarray, cache),
                              jnp.asarray(lens))
    got, gc = T.decode_step(cfg, tp, torch.from_numpy(tokens),
                            from_jax_tree(cache), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_tree(gc["pos0"], wc["pos0"])


def test_cache_defs_match_reference():
    ref, cfg = _cfgs()
    want = RT.cache_defs(ref, 3, 16)["pos0"]
    got = init_params(T.cache_defs(cfg, 3, 16), device="cpu")["pos0"]
    assert sorted(got) == sorted(want)
    for k, pd in want.items():
        assert tuple(got[k].shape) == pd.shape
        assert str(got[k].dtype).replace("torch.", "") == pd.dtype


def _serve(engine_cls, scfg_cls, cfg, p, prompts, scfg, max_new, **kw):
    rec = TraceRecorder()
    eng = engine_cls(cfg, p, scfg_cls(**scfg), recorder=rec, **kw)
    for pr in prompts:
        eng.add_request(pr, max_new_tokens=max_new)
    return eng.run_until_done(), eng, rec.to_trace()


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_engine_matches_reference_engine(params, mode):
    """The same workload through both engines, traced: an ssm stack
    prefills sequentially whatever the mode; greedy tokens, counters,
    prefill stats, PAS log and trace events are identical, and the port's
    trace lints clean."""
    ref, cfg = _cfgs()
    p, tp = params
    scfg = dict(max_slots=3, max_len=48, prefill_chunk=8, prefill_mode=mode)
    rng = np.random.default_rng(9)
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


def test_wave_mates_advance_each_others_state(params):
    """The reference's sequential prefill feeds token 0 to every other row,
    and an RWKV state is cumulative: prompt A served beside B gives other
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
