"""Port parity for packed prefill and the int8 KV cache, on the CPU.

Each port function against its reference namesake on the same inputs
(made with numpy seeds; weights carried across with ``from_jax_tree``), at
llama3.2-1b ``.reduced()`` in float32:

  * the packing planner's dispatches, array for array;
  * the segment mask: ``segment_attention_ref`` and
    ``flash_attention_xla(segment_info=)`` against the reference's Pallas
    kernel (interpret mode) and its oracle, on valid query rows;
  * the packed K/V scatter, the int8 quantizer and the scale writes;
  * ``attention_prefill_packed`` and ``prefill_chunk_packed``, bf16 and
    int8 caches;
  * the packed and the int8 engine against the reference engine, and the
    port's packed engine against its unpacked one.

Tolerances are ``tests/test_kernels.py::_tol``'s f32 1e-4 for attention
outputs (sums in another order) and 1e-5 for float cache cells. The int8
quantizer and the cache writes are exact on the same inputs. Where each
framework computes the quantizer's input itself (a projection's matmul,
summed in another order and on another number of threads), an int8 cell
may round the other way when its value sits within an ulp of a rounding
tie: those cells differ by one quantum, and they are rare (1 in 10240
cells seen). Every counter is exact."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as JA
from repro.models import transformer as RT
from repro.models.params import init_params as jax_init
from repro.sched import plan_packed_job as jax_plan
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.trace import TraceRecorder
from repro.verify import lint_trace
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_tree
from repro_torch.sched import plan_packed_job
from repro_torch.serve import ServeConfig, ServeEngine

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
LAYOUT = ("tokens", "seg_slot", "seg_pos", "seg_ids", "valid", "row_slot",
          "prefix_len")


def _cfgs(**kw):
    ref_cfg = dataclasses.replace(jax_arch("llama3.2-1b").reduced(),
                                  dtype="float32", **kw)
    port = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               dtype="float32", **kw)
    return ref_cfg, port


def _np_leaf(pd, rng):
    """A float32 leaf drawn as the reference's ``_materialize`` draws it."""
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """float32 weights from a numpy seed, the same in every process (the
    reference's ``init_params`` folds ``hash()`` of each leaf's path into
    its key, which Python randomizes per process): int8 rounding ties
    make greedy parity a property of the weights, so they are pinned."""
    ref_cfg, _ = _cfgs()
    rng = np.random.default_rng(0)
    defs = RT.param_defs(ref_cfg)
    leaves, treedef = jax.tree_util.tree_flatten(
        defs, is_leaf=lambda x: hasattr(x, "fan_in"))
    p = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_np_leaf(pd, rng)) for pd in leaves])
    return p, from_jax_tree(jax.tree.map(np.asarray, p))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _wave(plens, seed=0, slots=None):
    rng = np.random.default_rng(seed)
    slots = list(range(len(plens))) if slots is None else slots
    return [(int(s), SimpleNamespace(rid=i, prompt=rng.integers(
        0, 100, p).astype(np.int32))) for i, (s, p) in enumerate(zip(slots,
                                                                     plens))]


def _dispatch(plens, B, C, seed=0):
    """The first packed dispatch of a wave of prompts in slots 0.."""
    return plan_packed_job(_wave(plens, seed), max_slots=B, chunk=C,
                           sub_batch=0).dispatches[0]


def _tt(*arrays):
    return [from_jax_tree(np.asarray(a)) for a in arrays]


# --------------------------------------------------------------------------- #
# planner
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(6))
def test_planner_matches_reference(seed):
    """Seeded mixed waves: every dispatch's arrays, span, rows, segments and
    completions equal the reference planner's."""
    rng = np.random.default_rng(seed)
    B, C = int(rng.integers(2, 9)), int(rng.integers(4, 17))
    n = int(rng.integers(1, 2 * B + 1))
    plens = [int(rng.integers(1, 4 * C)) for _ in range(n)]
    wave = _wave(plens, seed, slots=list(rng.permutation(max(n, B))[:n]))
    got = plan_packed_job(wave, max_slots=B, chunk=C, sub_batch=3)
    want = jax_plan(wave, max_slots=B, chunk=C, sub_batch=3)
    if want is None:
        assert got is None
        return
    assert (got.chunk, got.sub_batch, got.n_chunks) == \
        (want.chunk, want.sub_batch, want.n_chunks)
    for g, w in zip(got.dispatches, want.dispatches):
        for name in LAYOUT:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert (g.prefix_span, g.rows, g.segments, g.n_valid,
                g.token_slots) == (w.prefix_span, w.rows, w.segments,
                                   w.n_valid, w.token_slots)
        assert [(s, r.rid) for s, r in g.completes] == \
            [(s, r.rid) for s, r in w.completes]


# --------------------------------------------------------------------------- #
# the segment mask
# --------------------------------------------------------------------------- #
def _layout():
    """Two packed rows over [prefix(8) ; chunk(8)] keys (the reference
    test's layout): row 0 a continuation (prefix_len 6) plus a 3-token
    prompt and a padding column, row 1 two whole prompts and padding."""
    q_pos = np.array([[8, 9, 10, 11, 0, 1, 2, 0],
                      [0, 1, 2, 0, 1, 2, 3, 0]], np.int32)
    q_seg = np.array([[0, 0, 0, 0, 1, 1, 1, -2],
                      [1, 1, 1, 2, 2, 2, 2, -2]], np.int32)
    pref_pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    pref_seg = np.where(pref_pos < np.array([[6], [0]]), 0, -1
                        ).astype(np.int32)
    kv_pos = np.concatenate([pref_pos, q_pos], axis=1)
    kv_seg = np.concatenate([pref_seg, np.where(q_seg == -2, -1, q_seg)],
                            axis=1)
    return q_pos, q_seg, kv_pos, kv_seg


@pytest.mark.parametrize("H,KH,D", [(4, 2, 32), (4, 4, 64), (8, 2, 16)])
def test_segment_attention_matches_pallas_and_oracle(H, KH, D):
    info = _layout()
    B, Sq, Skv = 2, 8, 16
    q = _x((B, H, Sq, D), 1)
    k, v = _x((B, KH, Skv, D), 2), _x((B, KH, Skv, D), 3)
    jinfo = tuple(jnp.asarray(a) for a in info)
    kern = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        block_q=4, block_kv=8, segment_info=jinfo,
                        interpret=True)
    oracle = jax_ref.segment_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), *jinfo)
    tq, tk, tv = _tt(q, k, v)
    tinfo = _tt(*info)
    got = {
        "ref": ref.segment_attention_ref(tq, tk, tv, *tinfo),
        "ops": ops.flash_attention(tq, tk, tv, segment_info=tinfo),
        "xla": A.flash_attention_xla(tq, tk, tv, causal=True, chunk_q=4,
                                     chunk_kv=8, segment_info=tinfo),
    }
    rows = (info[1] >= 0)[:, None, :, None]       # padded queries: garbage
    for name, g in got.items():
        for want in (kern, oracle):
            np.testing.assert_allclose(np.where(rows, g.numpy(), 0),
                                       np.where(rows, np.asarray(want), 0),
                                       err_msg=name, **TOL)


def test_segment_mask_matches_q_offset_when_unpacked():
    """One segment per row at positions [offset, offset + Sq) is the static
    q_offset mask: the plain version and the blocked twin agree with it."""
    B, H, KH, Sq, Skv, off, D = 2, 4, 2, 8, 16, 8, 32
    q, k, v = _tt(_x((B, H, Sq, D), 5), _x((B, KH, Skv, D), 6),
                  _x((B, KH, Skv, D), 7))
    info = _tt(np.tile(off + np.arange(Sq, dtype=np.int32), (B, 1)),
               np.ones((B, Sq), np.int32),
               np.tile(np.arange(Skv, dtype=np.int32), (B, 1)),
               np.ones((B, Skv), np.int32))
    static = ref.flash_attention_ref(q, k, v, causal=True, q_offset=off)
    torch.testing.assert_close(
        ref.flash_attention_ref(q, k, v, segment_info=info), static,
        rtol=1e-5, atol=1e-5)
    kw = dict(causal=True, chunk_q=4, chunk_kv=8)
    torch.testing.assert_close(
        A.flash_attention_xla(q, k, v, segment_info=info, **kw),
        A.flash_attention_xla(q, k, v, q_offset=off, **kw),
        rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# cache writes and the int8 quantizer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("plens,B,C,L", [
    ((21, 6, 4, 3), 4, 8, 40),      # a continuation chain plus shorts
    ((9, 9, 9, 2, 2), 5, 8, 24),    # padding columns in every lane
])
def test_write_kv_packed_and_scales(plens, B, C, L):
    """The sync-free packed scatter writes exactly the reference's cells
    (padding writes dropped), for K/V and for the int8 cache's scales."""
    d = _dispatch(plens, B, C)
    KH, hd, R = 2, 16, d.tokens.shape[0]
    kc, vc = _x((B, KH, L, hd), 1), _x((B, KH, L, hd), 2)
    kn, vn = _x((R, KH, C, hd), 3), _x((R, KH, C, hd), 4)
    lay = (d.seg_slot, d.seg_pos, d.valid)
    want = JA.write_kv_packed(*(jnp.asarray(a) for a in (kc, vc, kn, vn)),
                              *(jnp.asarray(a) for a in lay))
    tk, tv = _tt(kc, vc)
    got = A.write_kv_packed(tk, tv, *_tt(kn, vn), *_tt(*lay))
    assert got[0] is tk and got[1] is tv              # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sc, sn = np.abs(_x((B, KH, L), 5)), np.abs(_x((R, KH, C), 6))
    want = JA._write_scale_packed(jnp.asarray(sc), jnp.asarray(sn),
                                  *(jnp.asarray(a) for a in lay))
    got = A._write_scale_packed(*_tt(sc, sn), *_tt(*lay))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("offset,C,L", [(0, 8, 32), (24, 16, 36)])
def test_write_scale_chunk(offset, C, L):
    B, KH = 3, 2
    sc, sn = np.abs(_x((B, KH, L), 1)), np.abs(_x((B, KH, C), 2))
    valid = np.random.default_rng(3).random((B, C)) < 0.7
    want = JA._write_scale_chunk(jnp.asarray(sc), jnp.asarray(sn),
                                 jnp.asarray(valid), offset)
    got = A._write_scale_chunk(*_tt(sc, sn, valid), offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,scale", [((3, 2, 1, 16), 1.0),
                                         ((2, 2, 8, 32), 40.0),
                                         ((1, 1, 4, 8), 0.0)])
def test_quantize_kv(shape, scale):
    """Bit-equal int8 values and scales (zero rows floor the scale at
    1e-8); exact halves round to even in both frameworks."""
    x = _x(shape, 7, scale)
    if scale:
        x.reshape(-1)[:4] = [63.5, -0.5, 2.5, 127.0]   # rounding ties
    wq, ws = JA._quantize_kv(jnp.asarray(x))
    gq, gs = A._quantize_kv(from_jax_tree(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# --------------------------------------------------------------------------- #
# attention and the stack
# --------------------------------------------------------------------------- #
def _cache_pair(ref_cfg, B, L, seed, layers=None):
    """A random cache (int8 values and positive scales for the int8 cache)
    for both frameworks."""
    lead = () if layers is None else (layers,)
    shape = lead + (B, ref_cfg.num_kv_heads, L, ref_cfg.head_dim)
    rng = np.random.default_rng(seed)
    if ref_cfg.kv_dtype == "int8":
        c = {"k": rng.integers(-127, 128, shape).astype(np.int8),
             "v": rng.integers(-127, 128, shape).astype(np.int8),
             "k_scale": (rng.random(shape[:-1]) * 0.05).astype(np.float32),
             "v_scale": (rng.random(shape[:-1]) * 0.05).astype(np.float32)}
    else:
        c = {"k": _x(shape, seed), "v": _x(shape, seed + 1)}
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: from_jax_tree(v) for k, v in c.items()})


def _assert_cache_leaves(got: dict, want: dict):
    """Float cells within 1e-5; int8 cells equal but for rounding ties
    (at most one quantum, in at most 1 cell in 1000)."""
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, \
                (key, int(diff.max()), int((diff > 0).sum()))
        else:
            np.testing.assert_allclose(g, w, err_msg=key, **CACHE_TOL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("plens,B,C,L", [
    ((21, 6, 4, 3), 4, 8, 40),      # continuation lanes: prefix span 16
    ((6, 5, 4), 3, 8, 24),          # short prompts only: no prefix
])
def test_attention_prefill_packed(params, kv_dtype, plens, B, C, L):
    """Outputs on valid tokens within 1e-4; the cache after the dispatch
    equals the reference's cell for cell (int8 values exactly)."""
    ref_cfg, port = _cfgs(kv_dtype=kv_dtype)
    p, tp = params
    pa, tpa = (jax.tree.map(lambda a: a[0], p["blocks"]["pos0"]["attn"]),
               {k: v[0] for k, v in tp["blocks"]["pos0"]["attn"].items()})
    d = _dispatch(plens, B, C)
    R = d.tokens.shape[0]
    x = _x((R, C, ref_cfg.d_model), 11)
    cache_j, cache_t = _cache_pair(ref_cfg, B, L, 12)
    lay = [getattr(d, n) for n in LAYOUT[1:]]
    out_w, new_w = JA.attention_prefill_packed(
        ref_cfg, pa, jnp.asarray(x), cache_j, *(jnp.asarray(a) for a in lay),
        prefix_span=d.prefix_span)
    out_g, new_g = A.attention_prefill_packed(
        port, tpa, from_jax_tree(x), cache_t, *_tt(*lay),
        prefix_span=d.prefix_span)
    np.testing.assert_allclose(out_g.numpy()[d.valid],
                               np.asarray(out_w)[d.valid], **TOL)
    _assert_cache_leaves(new_g, new_w)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_chunk_packed(params, kv_dtype):
    """A whole packed wave through the stack, dispatch by dispatch: the
    cache equals the reference's after every dispatch."""
    ref_cfg, port = _cfgs(kv_dtype=kv_dtype)
    p, tp = params
    B, C, L = 4, 8, 40
    job = plan_packed_job(_wave((27, 10, 4, 2), 21), max_slots=2, chunk=C,
                          sub_batch=0)
    assert job.n_chunks > 1
    cache_j = jax_init(RT.cache_defs(ref_cfg, B, L), KEY)
    cache_t = from_jax_tree(jax.tree.map(np.asarray, cache_j))
    for d in job.dispatches:
        lay = [getattr(d, n) for n in LAYOUT]
        cache_j = RT.prefill_chunk_packed(
            ref_cfg, p, jnp.asarray(d.tokens), cache_j,
            *(jnp.asarray(a) for a in lay[1:]), prefix_span=d.prefix_span)
        cache_t = T.prefill_chunk_packed(port, tp, *_tt(d.tokens), cache_t,
                                         *_tt(*lay[1:]),
                                         prefix_span=d.prefix_span)
        _assert_cache_leaves(cache_t["pos0"], cache_j["pos0"])


@pytest.mark.parametrize("method", ["onehot", "scatter"])
def test_int8_prefill_cached_then_decode(params, method):
    """The int8 branches of the unpacked chunk and of the decode step:
    quantized writes, scale writes and bf16 dequantized attention."""
    ref_cfg, port = _cfgs(kv_dtype="int8", kv_update=method)
    p, tp = params
    pa, tpa = (jax.tree.map(lambda a: a[0], p["blocks"]["pos0"]["attn"]),
               {k: v[0] for k, v in tp["blocks"]["pos0"]["attn"].items()})
    B, C, L, offset = 3, 8, 24, 8
    cache_j, cache_t = _cache_pair(ref_cfg, B, L, 31)
    x = _x((B, C, ref_cfg.d_model), 32)
    valid = np.ones((B, C), bool)
    valid[2, 3:] = False
    out_w, cache_j = JA.attention_prefill_cached(
        ref_cfg, pa, jnp.asarray(x), cache_j, jnp.asarray(valid), offset)
    out_g, cache_t = A.attention_prefill_cached(
        port, tpa, from_jax_tree(x), cache_t, from_jax_tree(valid), offset)
    np.testing.assert_allclose(out_g.numpy()[valid], np.asarray(out_w)[valid],
                               **TOL)
    _assert_cache_leaves(cache_t, cache_j)
    cur = np.array([16, 3, L], np.int32)          # L: past the end
    xd = _x((B, 1, ref_cfg.d_model), 33)
    out_w, cache_j = JA.attention_decode(ref_cfg, pa, jnp.asarray(xd),
                                         cache_j, jnp.asarray(cur))
    out_g, cache_t = A.attention_decode(port, tpa, from_jax_tree(xd),
                                        cache_t, from_jax_tree(cur))
    np.testing.assert_allclose(out_g.numpy(), np.asarray(out_w), **TOL)
    _assert_cache_leaves(cache_t, cache_j)


def test_int8_cache_defs():
    ref_cfg, port = _cfgs(kv_dtype="int8")
    want = RT.cache_defs(ref_cfg, 3, 16)["pos0"]
    got = T.cache_defs(port, 3, 16)["pos0"]
    assert sorted(got) == sorted(k for k in want if k in got) == \
        ["k", "k_scale", "v", "v_scale"]
    for key in got:
        assert (got[key].shape, got[key].dtype) == \
            (want[key].shape, want[key].dtype)


# --------------------------------------------------------------------------- #
# engines
# --------------------------------------------------------------------------- #
def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("kv_update", ["onehot", "scatter"])
@pytest.mark.parametrize("pack,kv_dtype", [(True, "bf16"), (False, "int8"),
                                           (True, "int8")])
def test_engine_matches_reference_engine(params, pack, kv_dtype, kv_update):
    """The same traced workload through both engines: identical greedy
    tokens, counters, prefill stats, PAS log, trace events and summary;
    the port's trace lints clean."""
    ref_cfg, port = _cfgs(kv_dtype=kv_dtype, kv_update=kv_update)
    p, tp = params
    scfg = dict(max_slots=3, max_len=48, prefill_chunk=8, pack=pack)
    rec_j, rec_t = TraceRecorder(), TraceRecorder()
    ej = JaxServeEngine(ref_cfg, p, JaxServeConfig(**scfg), recorder=rec_j)
    et = ServeEngine(port, tp, ServeConfig(**scfg), recorder=rec_t,
                     device="cpu")
    for pr in _prompts(ref_cfg.vocab_size, (5, 17, 1, 30, 9, 3), 3):
        ej.add_request(pr, max_new_tokens=5)
        et.add_request(pr, max_new_tokens=5)
    assert et.run_until_done() == ej.run_until_done()
    assert et.dispatch_counts == ej.dispatch_counts
    assert et.host_syncs == ej.host_syncs
    assert et.prefill_stats == ej.prefill_stats
    assert et.pas_log == ej.pas_log
    tj, tt = rec_j.to_trace(), rec_t.to_trace()
    assert tt.events == tj.events
    assert tt.summary == tj.summary
    assert lint_trace(tt) == []


def _serve(port, tp, prompts, max_new, **kw):
    eng = ServeEngine(port, tp, ServeConfig(**kw), device="cpu")
    for pr in prompts:
        eng.add_request(pr, max_new_tokens=max_new)
    return eng, eng.run_until_done()


@pytest.mark.parametrize("kv_dtype,lens,admission", [
    ("bf16", (17, 9, 5, 5, 17, 9, 5, 5), "fifo"),   # short-prompt waves
    ("bf16", (2, 39, 12, 26, 7, 33, 3), "bucketed"),
    ("int8", (5, 17, 2, 11), "bucketed"),           # the reference's int8 case
])
def test_port_packed_matches_port_unpacked(params, kv_dtype, lens, admission):
    """Packing is numerically invisible in the port: identical greedy
    tokens and decode counters, fewer prefill dispatches, a higher valid
    fraction, the same valid tokens."""
    _, port = _cfgs(kv_dtype=kv_dtype)
    _, tp = params
    prompts = _prompts(port.vocab_size, lens, 4)
    kw = dict(max_slots=4, max_len=64, prefill_chunk=8, admission=admission)
    un, res_un = _serve(port, tp, prompts, 4, **kw)
    pk, res_pk = _serve(port, tp, prompts, 4, pack=True, **kw)
    assert res_pk == res_un
    assert pk.dispatch_counts["decode"] == un.dispatch_counts["decode"]
    assert pk.host_syncs == un.host_syncs == un.dispatch_counts["decode"]
    assert pk.dispatch_counts["prefill"] < un.dispatch_counts["prefill"]
    fp, fu = ((e.prefill_stats["valid_tokens"] / e.prefill_stats["token_slots"])
              for e in (pk, un))
    assert fp > fu
    assert pk.prefill_stats["valid_tokens"] == un.prefill_stats["valid_tokens"]


@pytest.mark.parametrize("admission", ["fifo", "bucketed"])
def test_port_bf16_packed_matches_port_unpacked(params, admission):
    """Packing is sound in bf16 too: with the weights and the cache in
    bf16, the port's packed serve gives its unpacked serve's greedy tokens
    and decode counters (12 prompts of 2-39 tokens, 6 new each). A packed
    and an unpacked serve on the card can still differ, from their flash
    routes' rounding; chip_smoke.py phase 3d reads how far."""
    port = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               dtype="bfloat16")
    tp = _tree(lambda a: a.to(torch.bfloat16), params[1])
    lens = (2, 39, 12, 26, 7, 33, 3, 17, 9, 21, 5, 30)
    prompts = _prompts(port.vocab_size, lens, 5)
    kw = dict(max_slots=4, max_len=64, prefill_chunk=8, admission=admission)
    un, res_un = _serve(port, tp, prompts, 6, **kw)
    pk, res_pk = _serve(port, tp, prompts, 6, pack=True, **kw)
    assert res_pk == res_un
    assert pk.dispatch_counts["decode"] == un.dispatch_counts["decode"]
    assert pk.host_syncs == un.host_syncs
    assert pk.dispatch_counts["prefill"] < un.dispatch_counts["prefill"]


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} if isinstance(t, dict) \
        else fn(t)
