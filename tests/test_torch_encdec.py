"""Port parity for the ``encdec`` (whisper-medium) and ``vlm`` (pixtral-12b)
families on the CPU, at ``.reduced()`` size: attention's non-causal
prefill, the cross attention and the encoder's keys and values, the
encoder, the full-sequence forward with frames or patches, the
teacher-forced ``prefill_with_cache`` and a decode step against the filled
cross cache, the prefill step, the stub inputs, and both engines against
the reference engine.

Weights are drawn from a numpy seed (the layernorms' zero-initialized
biases too, so that they count) and carried across with
``from_jax_tree``; the float32 cases cast the tree to float32. Tolerances:
float32 1e-4 (the frameworks sum in another order), bf16 5e-2 (bf16
rounds at other places in the two frameworks). Whisper's encoder runs at
``encoder_seq`` 16 (its ``.reduced()``) and 24, which the reference's
query chunk of 16 does not divide, so that the plain flash path is held
against ``flash_attention_xla``'s largest-divisor blocks at a ragged
length. Greedy tokens, dispatch counts, host syncs and trace events are
exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_arch
from repro.data.pipeline import batch_for as jax_batch_for
from repro.launch.steps import make_prefill_step_fn as jax_prefill_step
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.models.params import init_params as jax_init
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.trace import TraceRecorder as JaxTraceRecorder
from repro.trace.schema import Trace as JaxTrace
from repro.verify import lint_trace as jax_lint_trace
from repro_torch.configs import get_arch
from repro_torch.data import batch_for
from repro_torch.launch.steps import step_fn_for
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_tree, init_params
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.trace import TraceRecorder
from repro_torch.verify import lint_trace

WHISPER, PIXTRAL = "whisper-medium", "pixtral-12b"
DTYPES = ("float32", "bfloat16")
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
# leaves the reference initializes to zero, drawn here so that they count
DRAWN = {"bias": 0.1}


def _cfgs(name, dtype="float32", **kw):
    ref = dataclasses.replace(jax_arch(name).reduced(), dtype=dtype, **kw)
    port = dataclasses.replace(get_arch(name).reduced(), dtype=dtype, **kw)
    return ref, port


def _np_leaf(name, pd, rng):
    if name in DRAWN:
        return (rng.standard_normal(pd.shape) * DRAWN[name]
                ).astype(np.float32)
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


_PARAMS = {}


def _params(name, dtype="float32", **kw):
    """Weights of ``name``'s reduced stack from a numpy seed, as a JAX tree
    (float32, or in the ParamDefs' bf16) and the port's tree (cached)."""
    key = (name, dtype, tuple(sorted(kw.items())))
    if key not in _PARAMS:
        ref, _ = _cfgs(name, dtype, **kw)
        rng = np.random.default_rng(0)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(
            RT.param_defs(ref), is_leaf=lambda x: hasattr(x, "fan_in"))
        out_dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        p = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(_np_leaf(getattr(path[-1], "key", None), pd, rng)
                        ).astype(out_dt)
            for path, pd in leaves])
        _PARAMS[key] = p, from_jax_tree(jax.tree.map(np.asarray, p))
    return _PARAMS[key]


def _x(shape, seed, dtype):
    """Seeded standard-normal inputs as (JAX array, torch tensor)."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                    .astype(np.float32)).astype(getattr(jnp, dtype))
    return a, from_jax_tree(np.asarray(a))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def _layer0(tree):
    """Layer 0 of a stacked tree, either package's."""
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [16, 24])
def test_attention_prefill_non_causal(S, dtype):
    """The encoder's self attention: RoPE at positions 0..S-1, no mask."""
    ref, cfg = _cfgs(WHISPER, dtype)
    p, tp = _params(WHISPER, dtype)
    pj = _layer0(p["encoder"]["blocks"]["pos0"])["attn"]
    pt = _layer0(tp["encoder"]["blocks"]["pos0"])["attn"]
    xj, xt = _x((2, S, cfg.d_model), 1, dtype)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))
    want = RA.attention_prefill(ref, pj, xj, jnp.asarray(pos), causal=False)
    got = A.attention_prefill(cfg, pt, xt, torch.from_numpy(pos.copy()),
                              causal=False)
    _close(got, want, dtype)
    causal = A.attention_prefill(cfg, pt, xt, torch.from_numpy(pos.copy()))
    assert not torch.allclose(causal.float(), got.float())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,S_enc", [(8, 16), (1, 24), (30, 24)])
def test_cross_attention_and_encoder_kv(Sq, S_enc, dtype):
    """``encoder_kv`` of encoder states, then ``cross_attention`` of Sq
    decoder rows against them (the flash kernel's non-causal mode at
    Sq != Skv); one row also through ``cross_attention_decode`` (the GEMV
    and the decode kernel over every encoder position)."""
    ref, cfg = _cfgs(WHISPER, dtype)
    p, tp = _params(WHISPER, dtype)
    pj = _layer0(p["blocks"]["pos0"])["cross"]
    pt = _layer0(tp["blocks"]["pos0"])["cross"]
    ej, et = _x((2, S_enc, cfg.d_model), 2, dtype)
    kj, vj = RA.encoder_kv(ref, pj, ej)
    kt, vt = A.encoder_kv(cfg, pt, et)
    assert kt.shape == (2, cfg.num_kv_heads, S_enc, cfg.head_dim)
    _close(kt, kj, dtype)
    _close(vt, vj, dtype)
    xj, xt = _x((2, Sq, cfg.d_model), 3, dtype)
    want = RA.cross_attention(ref, pj, xj, (kj, vj))
    _close(A.cross_attention(cfg, pt, xt, (kt, vt)), want, dtype)
    one = A.cross_attention_decode(cfg, pt, xt[:, -1:], (kt, vt))
    _close(one, want[:, -1:], dtype)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S_enc", [16, 24])
def test_encode(S_enc, dtype):
    ref, cfg = _cfgs(WHISPER, dtype, encoder_seq=S_enc)
    p, tp = _params(WHISPER, dtype, encoder_seq=S_enc)
    fj, ft = _x((2, S_enc, cfg.d_model), 4, dtype)
    _close(T.encode(cfg, tp, ft), RT.encode(ref, p, fj), dtype)


def _stub_inputs(name, cfg, dtype, B=2, S=12, seed=5):
    """Tokens and the family's stub embeddings (in ``dtype``) from the
    port's ``batch_for``, as (JAX kwargs, torch kwargs, tokens)."""
    b = batch_for(cfg, B, S + (cfg.num_patches if cfg.family == "vlm"
                               else 0), seed=seed)
    jk, tk = {}, {}
    for key in ("frame_embeds", "patch_embeds"):
        if key in b:
            jk[key] = jnp.asarray(b[key]).astype(getattr(jnp, dtype))
            tk[key] = from_jax_tree(np.asarray(jk[key]))
    return jk, tk, b["tokens"]


@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,S_enc", [(WHISPER, 16), (WHISPER, 24),
                                        (PIXTRAL, None)])
def test_forward_full(name, S_enc, dtype, last_only):
    """Whisper with frames (the encoder, then each decoder layer's cross
    attention over its own keys and values); pixtral with its patches
    prepended, positions over patches and text. Logits and aux loss."""
    kw = {} if S_enc is None else dict(encoder_seq=S_enc)
    ref, cfg = _cfgs(name, dtype, **kw)
    p, tp = _params(name, dtype, **kw)
    jk, tk, tokens = _stub_inputs(name, cfg, dtype)
    want, want_aux = RT.forward_full(ref, p, jnp.asarray(tokens),
                                     last_only=last_only, **jk)
    got, got_aux = T.forward_full(cfg, tp, torch.from_numpy(tokens),
                                  last_only=last_only, **tk)
    assert got.shape == want.shape
    _close(got, want, dtype)
    assert float(got_aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("name", [WHISPER, PIXTRAL])
def test_forward_without_its_stub_input_raises(name):
    _, cfg = _cfgs(name)
    _, tp = _params(name)
    with pytest.raises(ValueError, match="embeds"):
        T.forward_full(cfg, tp, torch.zeros((1, 4), dtype=torch.long))


def _prefill_both(name, dtype, B=2, S=6, L=16):
    ref, cfg = _cfgs(name, dtype)
    p, tp = _params(name, dtype)
    jk, tk, tokens = _stub_inputs(name, cfg, dtype, B=B, S=S)
    cj = jax_init(RT.cache_defs(ref, B, L), jax.random.PRNGKey(0))
    ct = init_params(T.cache_defs(cfg, B, L), device="cpu")
    lj, cj, nj = RT.prefill_with_cache(ref, p, jnp.asarray(tokens), cj, **jk)
    lt, ct, nt = T.prefill_with_cache(cfg, tp, torch.from_numpy(tokens), ct,
                                      **tk)
    return (ref, cfg, p, tp, tokens), (lj, cj, nj), (lt, ct, nt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", [WHISPER, PIXTRAL])
def test_prefill_with_cache(name, dtype):
    """Teacher-forced prefill: the last logits, the lengths, every cache
    leaf (whisper's ``ck``/``cv`` filled once from the encoded frames)."""
    _, (lj, cj, nj), (lt, ct, nt) = _prefill_both(name, dtype)
    assert lt.dtype == torch.float32
    _close(lt, lj, dtype)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    for pos, leaves in cj.items():
        for leaf, want in leaves.items():
            _close(ct[pos][leaf], want, dtype)
    if name == WHISPER:
        assert float(ct["pos0"]["ck"].abs().amax()) > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_against_the_filled_cross_cache(dtype):
    """Two decode steps after the prefill: each layer attends its filled
    cross cache (the decode kernel at every encoder position)."""
    (ref, cfg, p, tp, _), (_, cj, nj), (_, ct, nt) = \
        _prefill_both(WHISPER, dtype)
    nxt = np.array([[3], [7]], np.int32)
    for _ in range(2):
        wj, cj = RT.decode_step(ref, p, jnp.asarray(nxt), cj, nj)
        wt, ct = T.decode_step(cfg, tp, torch.from_numpy(nxt), ct, nt)
        _close(wt, wj, dtype)
        nj, nt = nj + 1, nt + 1
    for leaf in ("k", "v"):
        _close(ct["pos0"][leaf], cj["pos0"][leaf], dtype)


@pytest.mark.parametrize("S_enc", [16, 24])
def test_forward_full_equals_prefill_with_cache(S_enc):
    """The port's own full-sequence forward and its teacher-forced decode
    give the same last logits (the check of the reference's
    ``tests/test_archs.py::test_decode_matches_prefill``, in float32)."""
    _, cfg = _cfgs(WHISPER, encoder_seq=S_enc)
    _, tp = _params(WHISPER, encoder_seq=S_enc)
    _, tk, tokens = _stub_inputs(WHISPER, cfg, "float32", S=8)
    toks = torch.from_numpy(tokens)
    full, _ = T.forward_full(cfg, tp, toks, **tk)
    cache = init_params(T.cache_defs(cfg, 2, 16), device="cpu")
    last, _, lens = T.prefill_with_cache(cfg, tp, toks, cache, **tk)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert lens.tolist() == [8, 8]


# --------------------------------------------------------------------------- #
# the stub inputs and the prefill step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_batch_for_equals_the_reference(name):
    cfg = get_arch(name).reduced()
    got = batch_for(cfg, 2, 12, seed=3)
    want = jax_batch_for(jax_arch(name).reduced(), 2, 12, seed=3)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", [WHISPER, PIXTRAL])
def test_prefill_step_matches_reference(name, dtype):
    """``launch/steps.py``'s prefill step passes the batch's stub
    embeddings through, as the reference's does."""
    ref, cfg = _cfgs(name, dtype)
    p, tp = _params(name, dtype)
    b = batch_for(cfg, 2, 12 + cfg.num_patches, seed=7)
    if dtype == "bfloat16":
        # the frontend's output in the model's dtype
        for key in ("frame_embeds", "patch_embeds"):
            if key in b:
                b[key] = np.asarray(jnp.asarray(b[key]).astype(jnp.bfloat16))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax_prefill_step(ref)(p, jb)
    tb = {k: from_jax_tree(v) for k, v in b.items()}
    got = step_fn_for(cfg, "prefill", device="cpu")(tp, tb)
    assert got.shape == (2, cfg.vocab_size)
    _close(got, want, dtype)


# --------------------------------------------------------------------------- #
# the engine against the reference engine
# --------------------------------------------------------------------------- #
def _serve(engine_cls, scfg_cls, rec_cls, cfg, p, prompts, scfg, max_new,
           **kw):
    rec = rec_cls()
    eng = engine_cls(cfg, p, scfg_cls(**scfg), recorder=rec, **kw)
    for pr in prompts:
        eng.add_request(pr, max_new_tokens=max_new)
    return eng.run_until_done(), eng, rec.to_trace()


@pytest.mark.parametrize("name,scfg", [
    (WHISPER, dict()),
    (WHISPER, dict(policy="interleaved", pack=True)),
    (PIXTRAL, dict()),
    (PIXTRAL, dict(pack=True)),
], ids=["whisper", "whisper-interleaved", "pixtral", "pixtral-packed"])
def test_engine_matches_reference_engine(name, scfg):
    """The same prompts through both engines in float32, traced: whisper
    prefills sequentially under ``serial`` whatever it is asked (its cross
    cache stays zero: the engine encodes no frames), pixtral in chunks,
    packed or not, without patches. Greedy tokens, counters, prefill
    stats, PAS log and trace events are identical, and the port's trace
    lints clean under both packages' protocol lint."""
    ref, cfg = _cfgs(name)
    p, tp = _params(name)
    scfg = dict(max_slots=3, max_len=48, prefill_chunk=8, **scfg)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 1, 9, 3)]
    tj, ej, trj = _serve(JaxServeEngine, JaxServeConfig, JaxTraceRecorder,
                         ref, p, prompts, scfg, 4)
    tt, et, trt = _serve(ServeEngine, ServeConfig, TraceRecorder, cfg, tp,
                         prompts, scfg, 4, device="cpu")
    want_mode = "sequential" if name == WHISPER else "batched"
    assert et.effective_prefill_mode == ej.effective_prefill_mode == want_mode
    assert et.effective_policy == ej.effective_policy
    assert et.snapshot_supported == (name == PIXTRAL)
    assert tt == tj
    assert et.dispatch_counts == ej.dispatch_counts
    assert et.host_syncs == ej.host_syncs
    assert et.prefill_stats == ej.prefill_stats
    assert et.pas_log == ej.pas_log
    assert trt.events == trj.events
    assert trt.summary == trj.summary
    assert lint_trace(trt) == []
    assert jax_lint_trace(JaxTrace.loads(trt.dumps())) == []
    if name == WHISPER:
        assert et.dispatch_counts["prefill"] == sum(
            len(pr) - 1 for pr in prompts)
        assert float(et.cache["pos0"]["ck"].abs().amax()) == 0.0
