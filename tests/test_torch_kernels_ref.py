"""Port parity: the plain PyTorch versions of the port's kernels against the
reference's oracles (``repro/kernels/ref.py``) and its Pallas kernels in
interpret mode, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances are those of ``tests/test_kernels.py::_tol``: f32 1e-4 (sums
taken in another order), bf16 5e-2 (bf16 rounds at other places in the two
frameworks)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.layernorm import layernorm as pallas_layernorm
from repro.kernels.masked_softmax import masked_softmax as pallas_msoftmax
from repro.kernels.pim_matvec import pim_matvec as pallas_matvec
from repro.kernels.rwkv_chunk import rwkv_chunk as pallas_rwkv_chunk
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.models.params import from_jax_tree


def _tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed, dtype=jnp.float32, scale=1.0, shift=0.0):
    """A seeded standard-normal numpy array as a JAX array."""
    a = np.random.default_rng(seed).standard_normal(shape) * scale + shift
    return jnp.asarray(a.astype(np.float32)).astype(dtype)


def _t(a):
    """A JAX array as a torch tensor (bf16 included)."""
    return from_jax_tree(np.asarray(a))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("n,d_in,d_out,act,bias", [
    (1, 256, 512, "none", False),
    (1, 1024, 1024, "gelu", True),
    (4, 512, 256, "silu", True),
    (8, 2048, 512, "gelu", False),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matvec_plain(n, d_in, d_out, act, bias, dtype):
    x = _rand((n, d_in), 1, dtype, 0.5)
    w = _rand((d_in, d_out), 2, dtype, 0.02)
    b = _rand((d_out,), 3, dtype) if bias else None
    got = ref.matvec_ref(_t(x), _t(w), None if b is None else _t(b), act)
    assert got.dtype == _t(x).dtype and tuple(got.shape) == (n, d_out)
    oracle = jref.matvec_ref(x, w, b, act)
    pallas = pallas_matvec(x, w, b, act, block_n=256, block_k=256,
                           interpret=True)
    for want in (oracle, pallas):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("B,H,KH,Sq,Skv,offset", [
    (1, 4, 2, 32, 64, 32),     # chunk 1 of a 2-chunk prefill
    (2, 4, 4, 64, 192, 128),   # chunk 2 of 3
    (1, 8, 2, 32, 32, 0),      # degenerate: plain causal self-attn
])
def test_flash_plain_q_offset(B, H, KH, Sq, Skv, offset):
    """Queries at [offset, offset+Sq) against KV [0, Skv) equal the row
    block of full causal attention, and the Pallas kernel's q_offset
    mode."""
    D = 32
    q_full = _rand((B, H, Skv, D), 1)
    k = _rand((B, KH, Skv, D), 2)
    v = _rand((B, KH, Skv, D), 3)
    q = q_full[:, :, offset:offset + Sq]
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                                  q_offset=offset)
    oracle = jref.flash_attention_ref(q_full, k, v, causal=True
                                      )[:, :, offset:offset + Sq]
    pallas = pallas_flash(q, k, v, causal=True, block_q=16, block_kv=32,
                          q_offset=offset, interpret=True)
    for want in (oracle, pallas):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("B,H,KH,S,D,causal", [
    (1, 4, 4, 64, 32, True),
    (2, 8, 1, 128, 64, False),   # MQA
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_full(B, H, KH, S, D, causal, dtype):
    q = _rand((B, H, S, D), 1, dtype)
    k = _rand((B, KH, S, D), 2, dtype)
    v = _rand((B, KH, S, D), 3, dtype)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    want = jref.flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))


def _two_lanes(C, span):
    """Packed segment ids of two lanes of C queries over [span ; chunk]
    keys: lane 0 two whole prompts (20 and C - 20 tokens, ids 1 and 2),
    lane 1 a prompt's continuation after a ``span``-token prefix (id 0)
    and padding (query id -2, key id -1)."""
    q_pos = np.zeros((2, C), np.int32)
    q_seg = np.full((2, C), -2, np.int32)
    q_pos[0] = np.r_[np.arange(20), np.arange(C - 20)]
    q_seg[0] = np.r_[np.full(20, 1), np.full(C - 20, 2)]
    n = C - 8
    q_pos[1, :n], q_seg[1, :n] = span + np.arange(n), 0
    pref_pos = np.tile(np.arange(span, dtype=np.int32), (2, 1))
    pref_seg = np.array([[-1] * span, [0] * span], np.int32)
    kv_pos = np.concatenate([pref_pos, q_pos], axis=1)
    kv_seg = np.concatenate([pref_seg, np.where(q_seg < 0, -1, q_seg)],
                            axis=1).astype(np.int32)
    return q_pos, q_seg, kv_pos, kv_seg


@pytest.mark.parametrize("D", [96, 112, 160])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_at_the_configs_head_dims(D, dtype):
    """The head dims of gpt2-2.5b (96), kimi-k2 (112) and pixtral-12b
    (160): the plain static mode (a chunk at an offset) and segmented mode
    against the Pallas kernel in interpret mode, on its valid rows."""
    B, H, KH, S, Skv, off = 1, 4, 2, 32, 64, 32
    q = _rand((B, H, S, D), 1, dtype)
    k, v = _rand((B, KH, Skv, D), 2, dtype), _rand((B, KH, Skv, D), 3, dtype)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                                  q_offset=off)
    want = pallas_flash(q, k, v, causal=True, block_q=16, block_kv=32,
                        q_offset=off, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))
    info = _two_lanes(S, 32)
    q = _rand((2, H, S, D), 4, dtype)
    k, v = _rand((2, KH, Skv, D), 5, dtype), _rand((2, KH, Skv, D), 6, dtype)
    got = ref.segment_attention_ref(_t(q), _t(k), _t(v),
                                    *[torch.from_numpy(a) for a in info])
    want = pallas_flash(q, k, v, block_q=16, block_kv=32,
                        segment_info=[jnp.asarray(a) for a in info],
                        interpret=True)
    rows = np.broadcast_to((info[1] >= 0)[:, None, :, None], got.shape)
    np.testing.assert_allclose(_np(got)[rows],
                               np.asarray(want, np.float32)[rows],
                               **_tol(dtype))


def test_every_configs_head_dim_has_both_attention_kernels():
    """Each head dim of the port's registry, and of the reference's
    attention configs not ported yet (whisper-medium, pixtral-12b), is one
    that the flash and decode attention kernels take."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention, flash_attention
    dims = {c.head_dim for c in ARCHS.values()} | {
        c.head_dim for c in JAX_ARCHS.values() if c.family != "ssm"}
    assert {96, 112, 160} <= dims
    assert dims <= set(flash_attention.HEAD_DIMS)
    assert dims <= set(decode_attention.HEAD_DIMS)


@pytest.mark.parametrize("B,H,KH,S,D", [
    (2, 8, 2, 256, 64),
    (3, 4, 1, 512, 64),
])
def test_decode_plain(B, H, KH, S, D):
    q = _rand((B, H, D), 1, jnp.bfloat16)
    k = _rand((B, KH, S, D), 2, jnp.bfloat16)
    v = _rand((B, KH, S, D), 3, jnp.bfloat16)
    lens = jnp.asarray(np.random.default_rng(4).integers(1, S + 1, B),
                       jnp.int32)
    got = ref.decode_attention_ref(_t(q), _t(k), _t(v), _t(lens))
    oracle = jref.decode_attention_ref(q, k, v, lens)
    pallas = pallas_decode(q, k, v, lens, block_kv=64, interpret=True)
    for want in (oracle, pallas):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **_tol(jnp.bfloat16))


def test_decode_plain_masks_beyond_length():
    """Garbage past the length must not leak into the output (the case of
    test_kernels.py::test_decode_attention_masks_beyond_length)."""
    B, H, KH, S, D = 1, 2, 2, 128, 32
    q = _rand((B, H, D), 1)
    k = _rand((B, KH, S, D), 2)
    v = _rand((B, KH, S, D), 3)
    lens = jnp.array([40], jnp.int32)
    pallas = pallas_decode(q, k, v, lens, block_kv=32, interpret=True)
    k2 = k.at[:, :, 40:].set(1e4)
    v2 = v.at[:, :, 40:].set(-1e4)
    base = ref.decode_attention_ref(_t(q), _t(k), _t(v), _t(lens))
    got = ref.decode_attention_ref(_t(q), _t(k2), _t(v2), _t(lens))
    np.testing.assert_allclose(_np(got), _np(base), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rows,d", [(32, 256), (64, 512)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_plain(rows, d, dtype):
    x = _rand((rows, d), 1, dtype, 3.0, 1.0)
    s = _rand((d,), 2, dtype)
    b = _rand((d,), 3, dtype)
    got = ref.norm_ref(_t(x), _t(s), _t(b), mode="layernorm")
    oracle = jref.layernorm_ref(x, s, b)
    pallas = pallas_layernorm(x, s, b, block_rows=16, interpret=True)
    for want in (oracle, pallas):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **_tol(dtype))


def test_norm_modes_need_their_params():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError):
        ref.norm_ref(x, mode="bogus")
    y = ref.norm_ref(x, mode="np_layernorm")
    np.testing.assert_allclose(y.mean(-1).numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("mode", ["rmsnorm", "np_layernorm"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_norm_plain_other_modes(mode, dtype):
    """The norm kernel's other modes against the reference's
    ``layers.apply_norm`` (the Pallas kernel is LayerNorm only)."""
    cfg = dataclasses.replace(jax_arch("llama3.2-1b").reduced(), norm=mode)
    d = cfg.d_model
    x = _rand((16, d), 1, dtype, 3.0, 1.0)
    p = {"scale": _rand((d,), 2, dtype)} if mode == "rmsnorm" else {}
    got = ref.norm_ref(_t(x), *(_t(v) for v in p.values()), mode=mode)
    assert got.dtype == _t(x).dtype
    want = JL.apply_norm(cfg, p, x)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("rows,n", [(32, 64), (64, 128), (16, 1000)])
def test_masked_softmax_plain(rows, n):
    """The plain masked softmax against the reference's oracle and its
    Pallas kernel in interpret mode, at test_kernels.py's shapes: masked
    entries exactly 0, rows summing to 1."""
    x = _rand((rows, n), 11)
    m = np.random.default_rng(12).random((rows, n)) < 0.6
    m[:, 0] = True                                  # no fully masked row
    got = ref.masked_softmax_ref(_t(x), torch.from_numpy(m))
    pallas = pallas_msoftmax(x, jnp.asarray(m), block_rows=16,
                             interpret=True)
    for want in (jref.masked_softmax_ref(x, jnp.asarray(m)), pallas):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert float(np.abs(np.where(m, 0.0, _np(got))).max()) == 0.0
    np.testing.assert_allclose(_np(got).sum(-1), 1.0, rtol=1e-5)


def test_masked_softmax_fully_masked_rows_and_int8_mask():
    """A fully masked row gives all zeros (the 1e-30 clamp), and an int8
    bitmap means what a bool one does, through the port's ops entry."""
    x = _rand((4, 70), 13)
    m = (np.random.default_rng(14).random((4, 70)) < 0.5).astype(np.int8)
    m[1] = 0
    got = ops.masked_softmax(_t(x), torch.from_numpy(m))
    pallas = pallas_msoftmax(x, jnp.asarray(m), block_rows=4, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)
    assert float(np.abs(_np(got)[1]).max()) == 0.0
    np.testing.assert_array_equal(
        _np(got), _np(ops.masked_softmax(_t(x), torch.from_numpy(m != 0))))


def _rwkv_inputs(BH, T, K, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, K)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((BH, T, K)))) * 0.5 + 0.45
         ).astype(np.float32)
    u = rng.standard_normal((BH, K)).astype(np.float32) * 0.1
    return r, k, v, w, u


@pytest.mark.parametrize("BH,T,K,chunk", [
    (2, 64, 32, 16), (1, 128, 64, 64), (4, 32, 16, 32),
])
def test_rwkv_chunk_plain(BH, T, K, chunk):
    """The plain (sequential, batched) wkv against the Pallas kernel in
    interpret mode and the reference's per-row oracle, at test_kernels.py's
    shapes and tolerance (2e-3: the chunked form factors the decays)."""
    r, k, v, w, u = _rwkv_inputs(BH, T, K, 21)
    got_y, got_s = ref.rwkv_chunk_ref(*(torch.from_numpy(a)
                                        for a in (r, k, v, w, u)))
    pal_y, pal_s = pallas_rwkv_chunk(*(jnp.asarray(a) for a in (r, k, v, w,
                                                                 u)),
                                     chunk=chunk, interpret=True)
    np.testing.assert_allclose(_np(got_y), np.asarray(pal_y), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(_np(got_s), np.asarray(pal_s), rtol=2e-3,
                               atol=2e-3)
    for b in range(BH):
        want_y, want_s = jref.rwkv_chunk_ref(
            *(jnp.asarray(a[b]) for a in (r, k, v, w, u)),
            jnp.zeros((K, K), jnp.float32))
        np.testing.assert_allclose(_np(got_y[b]), np.asarray(want_y),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(got_s[b]), np.asarray(want_s),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T", [1, 37])
def test_rwkv_chunk_ops_ragged_and_broadcast_u(T):
    """The port's ops entry at a ragged T (no multiple of any chunk) with u
    of shape (H, K) broadcast over the batch, against the reference's
    per-row oracle; y comes out in the dtype asked for."""
    B, H, K = 2, 3, 16
    r, k, v, w, _ = _rwkv_inputs(B * H, T, K, 22)
    u = np.random.default_rng(23).standard_normal((H, K)).astype(
        np.float32) * 0.1
    y, s = ops.rwkv_chunk(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                          out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    for bh in range(B * H):
        want_y, want_s = jref.rwkv_chunk_ref(
            *(jnp.asarray(a[bh]) for a in (r, k, v, w)),
            jnp.asarray(u[bh % H]), jnp.zeros((K, K), jnp.float32))
        np.testing.assert_allclose(_np(y[bh]), np.asarray(want_y),
                                   rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(_np(s[bh]), np.asarray(want_s),
                                   rtol=1e-4, atol=1e-4)


def _mamba_inputs(B, T, d, n, seed):
    """test_kernels.py::test_mamba_chunk's distributions: decays in
    (0.45, 0.95), inputs and C of scale 0.3 and 0.5."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, T, d, n)))) * 0.5 + 0.45
         ).astype(np.float32)
    u = (rng.standard_normal((B, T, d, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((B, T, n)) * 0.5).astype(np.float32)
    return a, u, C


@pytest.mark.parametrize("B,T,d,n", [
    (2, 32, 64, 8), (1, 64, 128, 16), (2, 16, 32, 4),   # test_kernels.py's
    (2, 37, 24, 5),                                     # ragged T, d and n
])
def test_mamba_chunk_plain(B, T, d, n):
    """The plain (sequential, batched) selective scan, through the port's
    ops entry, against the reference's per-row oracle (its Pallas kernel
    calls ``pl.load``, which the installed jax no longer has)."""
    a, u, C = _mamba_inputs(B, T, d, n, 24)
    y, h = ops.mamba_chunk(*(torch.from_numpy(x) for x in (a, u, C)))
    assert y.shape == (B, T, d) and y.dtype == torch.float32
    assert h.shape == (B, d, n) and h.dtype == torch.float32
    for b in range(B):
        want_y, want_h = jref.mamba_chunk_ref(
            *(jnp.asarray(x[b]) for x in (a, u, C)))
        np.testing.assert_allclose(_np(y[b]), np.asarray(want_y),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(h[b]), np.asarray(want_h),
                                   rtol=1e-4, atol=1e-4)


def test_mamba_chunk_plain_keeps_the_input_dtype():
    """bf16 operands: y in bf16 (the reference oracle's ``a.dtype``), the
    final state in f32, within bf16's 5e-2."""
    a, u, C = _mamba_inputs(1, 9, 16, 4, 25)
    ab, ub, Cb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (a, u, C))
    y, h = ref.mamba_chunk_ref(_t(ab), _t(ub), _t(Cb))
    want_y, want_h = jref.mamba_chunk_ref(ab[0], ub[0], Cb[0])
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y[0]), np.asarray(want_y, np.float32),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_np(h[0]), np.asarray(want_h), rtol=5e-2,
                               atol=5e-2)
