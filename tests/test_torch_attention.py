"""Port parity: ``repro_torch.models.attention`` against
``repro.models.attention`` on the CPU (llama3.2-1b ``.reduced()``, float32
weights; layout A for decode).

Tolerance 1e-5 for projections and 1e-4 for attention outputs (f32; the
frameworks sum in another order, and softmax exponentiates the
difference); cache positions that no update touches must be bit-equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import attention as JA
from repro.models.params import init_params as jax_init
from repro_torch.configs import get_arch
from repro_torch.models import attention as A
from repro_torch.models.params import from_jax_tree

KEY = jax.random.PRNGKey(0)


def _cfgs(**kw):
    ref = dataclasses.replace(jax_arch("llama3.2-1b").reduced(),
                              dtype="float32", **kw)
    port = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               dtype="float32", **kw)
    return ref, port


@pytest.fixture(scope="module")
def weights():
    ref, _ = _cfgs()
    p = jax.tree.map(lambda a: a.astype(jnp.float32),
                     jax_init(JA.attn_defs(ref), KEY))
    return p, from_jax_tree(jax.tree.map(np.asarray, p))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _cache(ref, B, L, seed):
    shape = (B, ref.num_kv_heads, L, ref.head_dim)
    return _x(shape, seed), _x(shape, seed + 1)


def test_qkv_and_out_project(weights):
    ref, port = _cfgs()
    p, tp = weights
    x = _x((2, 7, ref.d_model))
    pos = np.tile(np.arange(3, 10, dtype=np.int32), (2, 1))
    want = JA.qkv_project(ref, p, jnp.asarray(x), jnp.asarray(pos))
    got = A.qkv_project(port, tp, from_jax_tree(x), from_jax_tree(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    o = _x((2, ref.num_heads, 7, ref.head_dim), 3)
    np.testing.assert_allclose(
        A.out_project(tp, from_jax_tree(o)).numpy(),
        np.asarray(JA.out_project(p, jnp.asarray(o))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Sq,Skv,offset,chunks", [
    (16, 48, 32, (16, 32)),
    (12, 30, 18, (8, 16)),       # ragged: blocks are divisors, not chunks
    (32, 32, 0, (16, 32)),
])
def test_flash_attention_xla(Sq, Skv, offset, chunks):
    ref, _ = _cfgs()
    q = _x((2, ref.num_heads, Sq, ref.head_dim))
    k, v = _cache(ref, 2, Skv, 5)
    kw = dict(causal=True, chunk_q=chunks[0], chunk_kv=chunks[1],
              q_offset=offset)
    want = JA.flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    got = A.flash_attention_xla(from_jax_tree(q), from_jax_tree(k),
                                from_jax_tree(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("offset,C,L", [(0, 8, 32), (16, 8, 32),
                                        (24, 16, 36)])  # last overhangs L
def test_write_kv_chunk(offset, C, L):
    ref, _ = _cfgs()
    B = 3
    kc, vc = _cache(ref, B, L, 1)
    kn, vn = _cache(ref, B, C, 7)
    valid = np.random.default_rng(4).random((B, C)) < 0.7
    want = JA.write_kv_chunk(jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(kn), jnp.asarray(vn),
                             jnp.asarray(valid), offset)
    tk, tv = from_jax_tree(kc), from_jax_tree(vc)
    got = A.write_kv_chunk(tk, tv, from_jax_tree(kn), from_jax_tree(vn),
                           from_jax_tree(valid), offset)
    assert got[0] is tk and got[1] is tv          # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("offset,C,L", [(0, 8, 40), (16, 8, 40),
                                        (32, 16, 40)])  # last overhangs L
def test_attention_prefill_cached(weights, offset, C, L):
    ref, port = _cfgs()
    p, tp = weights
    B = 2
    kc, vc = _cache(ref, B, L, 11)
    x = _x((B, C, ref.d_model), 12)
    valid = np.ones((B, C), bool)
    valid[1, C // 2:] = False
    valid[:, max(0, L - offset):] = False         # prompt ends before L
    out_w, cache_w = JA.attention_prefill_cached(
        ref, p, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(valid), offset)
    out_g, cache_g = A.attention_prefill_cached(
        port, tp, from_jax_tree(x),
        {"k": from_jax_tree(kc), "v": from_jax_tree(vc)},
        from_jax_tree(valid), offset)
    # padding rows are garbage by contract: compare the valid tokens
    np.testing.assert_allclose(out_g.numpy()[valid], np.asarray(out_w)[valid],
                               rtol=1e-4, atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_g[key].numpy(),
                                   np.asarray(cache_w[key]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("method", ["onehot", "scatter"])
def test_update_kv_cache(method):
    """onehot writes position cur_len in every row (inactive slots too);
    scatter drops an out-of-range cur_len. Bit-equal to the reference."""
    ref, _ = _cfgs()
    L = 16
    kc, vc = _cache(ref, 3, L, 2)
    kn, vn = _cache(ref, 3, 1, 9)
    cur = np.array([0, 7, L], np.int32)            # L: past the end
    want = JA.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(kn), jnp.asarray(vn),
                              jnp.asarray(cur), method=method)
    got = A.update_kv_cache(from_jax_tree(kc), from_jax_tree(vc),
                            from_jax_tree(kn), from_jax_tree(vn),
                            from_jax_tree(cur), method=method)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy()[1, :, 7], kn[1, :, 0])
    np.testing.assert_array_equal(got[0].numpy()[2], kc[2])


def test_decode_attention_layout_a():
    ref, port = _cfgs()
    B, L = 3, 40
    q = _x((B, ref.num_heads, 1, ref.head_dim))
    kc, vc = _cache(ref, B, L, 3)
    cur = np.array([1, 17, 40], np.int32)
    want = JA.decode_attention(ref, jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(cur))
    got = A.decode_attention(port, from_jax_tree(q), from_jax_tree(kc),
                             from_jax_tree(vc), from_jax_tree(cur))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("method", ["onehot", "scatter"])
def test_attention_decode(weights, method):
    """One decode step, GEMV projections included, both kv_update
    methods: output within 1e-4, cache within 1e-5 and untouched
    positions bit-equal."""
    ref, port = _cfgs(kv_update=method)
    p, tp = weights
    B, L = 3, 24
    kc, vc = _cache(ref, B, L, 21)
    x = _x((B, 1, ref.d_model), 22)
    cur = np.array([3, 10, 23], np.int32)
    out_w, cache_w = JA.attention_decode(
        ref, p, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(cur))
    out_g, cache_g = A.attention_decode(
        port, tp, from_jax_tree(x),
        {"k": from_jax_tree(kc), "v": from_jax_tree(vc)}, from_jax_tree(cur))
    np.testing.assert_allclose(out_g.numpy(), np.asarray(out_w), rtol=1e-4,
                               atol=1e-4)
    written = np.zeros((B, L), bool)
    written[np.arange(B), cur] = True
    for key in ("k", "v"):
        g, w = cache_g[key].numpy(), np.asarray(cache_w[key])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g.transpose(0, 2, 1, 3)[~written],
                                      w.transpose(0, 2, 1, 3)[~written])


def test_unknown_kv_update_raises():
    t = torch.zeros(1, 1, 4, 2)
    with pytest.raises(ValueError):
        A.update_kv_cache(t, t.clone(), t[:, :, :1], t[:, :, :1],
                          torch.zeros(1, dtype=torch.int32), method="bogus")
