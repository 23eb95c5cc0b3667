"""The port's hand-written kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: each test skips without a CUDA device. On a
machine with an H100, nvcc and triton:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Shapes are small and ragged (no tile divides them), so every masked edge
is exercised, plus the main-path shape of ``rwkv_chunk``, ``mamba_chunk``
and the masked softmax, and every decode FC shape the serves give
``pim_matvec``. Tolerances are those of ``tests/test_kernels.py::_tol``:
f32 1e-4 (sums taken in another order), bf16 5e-2 (the kernel and the
plain version round to bf16 at other places). The bf16 routes of flash,
``decode_attention`` and ``pim_matvec`` are held tighter, to |err| <= 1e-2
+ 2e-2 |want|: attention outputs are means over hundreds of keys, about
0.05 in size, so 5e-2 would let a kernel drop a whole KV tile or split,
and a GEMV that drops one of its K-slices can stay near 5e-2 where the
outputs are small (PERF.md's findings have the readings of the sound
kernels and of copies that drop a tile, a split or a slice)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_segmented)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.layernorm import layernorm, layernorm_bwd
from repro_torch.kernels.mamba_chunk import mamba_chunk
from repro_torch.kernels.mamba_chunk_bwd import mamba_chunk_bwd
from repro_torch.kernels.masked_softmax import masked_softmax
from repro_torch.kernels.pim_matvec import pim_matvec
from repro_torch.kernels.rwkv_chunk import rwkv_chunk
from repro_torch.kernels.rwkv_chunk_bwd import rwkv_chunk_bwd
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from repro_torch.serve import ServeConfig, ServeEngine

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed, dtype, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)


def _close(got, want, dtype, tol=None):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **(tol or _tol(dtype)))


def _close_tight(got, want, dtype):
    _close(got, want, dtype, dict(rtol=2e-2, atol=1e-2)
           if dtype == torch.bfloat16 else None)


@pytest.mark.parametrize("B,H,KH,S,L,offset,D", [
    (2, 4, 2, 37, 165, 128, 64),     # ragged chunk, prefix of a cache
    (1, 8, 8, 16, 40, 32, 64),       # last chunk overhangs the cache end
    (3, 6, 2, 5, 5, 0, 128),         # plain causal self-attention
    (1, 2, 1, 70, 90, 20, 32),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(card, B, H, KH, S, L, offset, D, dtype):
    q = _rand((B, H, S, D), 1, dtype)
    kc, vc = _rand((B, KH, L, D), 2, dtype), _rand((B, KH, L, D), 3, dtype)
    span = min(offset + S, L)
    k, v = kc[:, :, :span], vc[:, :, :span]
    got = flash_attention(q, k, v, causal=True, q_offset=offset)
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=offset)
    _close_tight(got, want, dtype)


@pytest.mark.parametrize("B,H,KH,Sq,Skv,D", [
    (1, 16, 16, 300, 1500, 64),     # whisper's encoder frames, no tile's
    (2, 4, 4, 37, 165, 64),         # ragged Sq and Skv
    (1, 8, 2, 130, 70, 64),         # Sq > Skv, GQA
    (2, 4, 1, 100, 300, 160),       # MQA at pixtral's head dim
    (1, 2, 2, 64, 64, 32),
    # whisper-medium on one of two tensor-parallel ranks (8 / 8 heads):
    # the encoder at B 2 and at the generate's 8 rows, the cross attention
    (2, 8, 8, 1500, 1500, 64),
    (8, 8, 8, 1500, 1500, 64),
    (2, 8, 8, 448, 1500, 64),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_non_causal(card, B, H, KH, Sq, Skv, D, dtype):
    """The static mode with ``causal=False`` (whisper's encoder and cross
    attention): every key attended, at Sq != Skv, a ragged tail tile of
    queries and keys, and no diagonal skipping."""
    q = _rand((B, H, Sq, D), 1, dtype)
    k, v = _rand((B, KH, Skv, D), 2, dtype), _rand((B, KH, Skv, D), 3, dtype)
    got = flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    _close_tight(got, want, dtype)
    # the last key counts for the first query: causal would drop it
    v2 = v.clone()
    v2[:, :, -1] += 100.0
    moved = flash_attention(q, k, v2, causal=False) - got
    torch.cuda.synchronize()
    assert bool((moved[:, :, 0].float().abs().amax(-1) > 0).all())


def _segment_layout(R, C, prefix_lens, seed):
    """Packed lanes as the planner lays them out: a lane with a prefix
    starts with its continuation segment (id 0), then whole prompts (ids
    1..) and padding columns; keys are [prefix span ; chunk]."""
    rng = np.random.default_rng(seed)
    span = -(-max(prefix_lens) // C) * C
    q_pos = np.zeros((R, C), np.int32)
    q_seg = np.full((R, C), -2, np.int32)
    for r, p in enumerate(prefix_lens):
        col, sid = 0, 1
        if p:
            n = int(rng.integers(1, C + 1))
            q_pos[r, :n], q_seg[r, :n], col = p + np.arange(n), 0, n
        while col < C:
            n = int(rng.integers(1, C // 2 + 2))
            if col + n > C:
                break
            q_pos[r, col:col + n], q_seg[r, col:col + n] = np.arange(n), sid
            col, sid = col + n, sid + 1
    pref_pos = np.tile(np.arange(span, dtype=np.int32), (R, 1))
    pref_seg = np.where(pref_pos < np.array(prefix_lens)[:, None], 0, -1)
    kv_pos = np.concatenate([pref_pos, q_pos], axis=1)
    kv_seg = np.concatenate([pref_seg, np.where(q_seg < 0, -1, q_seg)],
                            axis=1).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (q_pos, q_seg, kv_pos,
                                                  kv_seg)]


@pytest.mark.parametrize("R,H,KH,C,prefix_lens,D", [
    (3, 8, 2, 37, (0, 50, 13), 64),         # ragged chunk and span
    (2, 8, 2, 128, (300, 0), 128),
    (4, 16, 4, 20, (0, 0, 0, 0), 64),       # no prefix: keys are the chunk
    (1, 4, 1, 70, (33,), 32),
    # a layout-B rank's packed chunk (granite-20b on two ranks: 24 of 48
    # query heads on one KV head of 128), over a gathered prefix of 512
    (8, 24, 1, 128, (400, 0, 260, 0, 130, 0, 0, 512), 128),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_kernel_matches_plain(card, R, H, KH, C, prefix_lens, D,
                                        dtype):
    info = _segment_layout(R, C, prefix_lens, 7)
    Skv = info[2].shape[1]
    q = _rand((R, H, C, D), 1, dtype)
    k, v = _rand((R, KH, Skv, D), 2, dtype), _rand((R, KH, Skv, D), 3, dtype)
    got = flash_attention_segmented(q, k, v, info)
    want = ref.segment_attention_ref(q, k, v, *info)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())        # padding rows included
    rows = (info[1] >= 0)[:, None, :, None].expand_as(got)
    _close_tight(got[rows], want[rows], dtype)


@pytest.mark.parametrize("B,H,KH,S,L,offset,D", [
    (2, 4, 4, 64, 64, 0, 64),          # G 1
    (1, 32, 4, 37, 165, 128, 64),      # G 8; G*S 296 is no multiple of 64
    (2, 8, 2, 50, 300, 77, 16),        # D 16; Skv 127 off the KV tile
    (1, 8, 2, 100, 260, 200, 128),     # D 128; the chunk overhangs the cache
    (2, 8, 2, 64, 1000, 130, 64),      # a prefix slice: head stride > Skv*D
    (2, 32, 8, 2048, 2048, 0, 128),    # jamba's prefill step: S 2048 causal
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_tile_edges(card, B, H, KH, S, L, offset, D, dtype):
    """The edges of the bf16 route's tiles (64 query rows over the G heads
    of a KV head, 64 keys) and of the f32 route's, against the plain
    version."""
    q = _rand((B, H, S, D), 4, dtype)
    kc, vc = _rand((B, KH, L, D), 5, dtype), _rand((B, KH, L, D), 6, dtype)
    span = min(offset + S, L)
    k, v = kc[:, :, :span], vc[:, :, :span]
    assert k.stride(1) == L * D
    got = flash_attention(q, k, v, causal=True, q_offset=offset)
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=offset)
    _close_tight(got, want, dtype)


@pytest.mark.parametrize("D", [96, 112, 160])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_at_head_dims_off_64(card, D, dtype):
    """The head dims of the reference's configs that are no multiple of 64
    (gpt2-2.5b's 96, kimi-k2's 112, pixtral-12b's 160), in both modes,
    against the plain version: the bf16 route computes them at the next
    multiple of 64 over zero-filled columns and stores D columns a row."""
    B, H, KH, S, L, offset = 2, 8, 2, 77, 300, 130
    q = _rand((B, H, S, D), 4, dtype)
    kc, vc = _rand((B, KH, L, D), 5, dtype), _rand((B, KH, L, D), 6, dtype)
    k, v = kc[:, :, :offset + S], vc[:, :, :offset + S]
    got = flash_attention(q, k, v, causal=True, q_offset=offset)
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=offset)
    _close_tight(got, want, dtype)
    info = _segment_layout(3, 37, (0, 50, 13), 7)
    Skv = info[2].shape[1]
    q = _rand((3, H, 37, D), 1, dtype)
    k, v = _rand((3, KH, Skv, D), 2, dtype), _rand((3, KH, Skv, D), 3, dtype)
    got = flash_attention_segmented(q, k, v, info)
    want = ref.segment_attention_ref(q, k, v, *info)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    rows = (info[1] >= 0)[:, None, :, None].expand_as(got)
    _close_tight(got[rows], want[rows], dtype)


def _lanes_layout(C, lanes, prefix_span):
    """Packed lanes from explicit segment lengths: ``lanes`` holds, per
    lane, (prefix_len, [segment lengths]) -- a lane with a prefix starts
    with its continuation (id 0) -- and the rest of the lane is padding
    (query id -2, key id -1); a lane of no segments is all padding. Keys
    are [prefix span ; chunk]."""
    R = len(lanes)
    q_pos = np.zeros((R, C), np.int32)
    q_seg = np.full((R, C), -2, np.int32)
    for r, (prefix, lens) in enumerate(lanes):
        col = 0
        for i, n in enumerate(lens):
            sid = 0 if (prefix and i == 0) else i + 1
            start = prefix if sid == 0 else 0
            q_pos[r, col:col + n] = start + np.arange(n)
            q_seg[r, col:col + n] = sid
            col += n
    pref_pos = np.tile(np.arange(prefix_span, dtype=np.int32), (R, 1))
    pref_seg = np.where(pref_pos < np.array([p for p, _ in lanes])[:, None],
                        0, -1)
    kv_pos = np.concatenate([pref_pos, q_pos], axis=1)
    kv_seg = np.concatenate([pref_seg, np.where(q_seg < 0, -1, q_seg)],
                            axis=1).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (q_pos, q_seg, kv_pos,
                                                  kv_seg)]


@pytest.mark.parametrize("H,KH,C,span,lanes,D", [
    # several segments a lane: each 64-row tile sees only its own
    # segments' key tiles; a lane without a prefix sees no prefix tile
    (8, 2, 256, 512, ((500, (100, 90, 66)), (0, (64, 64, 64, 64)),
                      (0, ())), 64),
    # one head a KV head, D 128, a lane of padding beside a long prefix
    (4, 4, 200, 320, ((0, ()), (300, (130, 70))), 128),
    # G 8, D 16, Skv off the KV tile
    (16, 2, 77, 90, ((61, (20, 30, 27)), (0, (5, 9))), 16),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_kernel_skips_invisible_tiles(card, H, KH, C, span,
                                                lanes, D, dtype):
    """Layouts in which whole KV tiles are invisible to some query tiles,
    and lanes that are all padding: valid rows agree with the plain
    version, and every row (padding included) is finite."""
    from repro_torch.kernels.flash_attention import segment_tile_visible
    info = _lanes_layout(C, lanes, span)
    R, Skv = len(lanes), span + C
    vis = segment_tile_visible(*[t.cpu() for t in info], groups=H // KH)
    assert not bool(vis.all())       # the kernel has tiles to skip
    q = _rand((R, H, C, D), 1, dtype)
    k, v = _rand((R, KH, Skv, D), 2, dtype), _rand((R, KH, Skv, D), 3, dtype)
    got = flash_attention_segmented(q, k, v, info)
    want = ref.segment_attention_ref(q, k, v, *info)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())        # padding rows included
    rows = (info[1] >= 0)[:, None, :, None].expand_as(got)
    _close_tight(got[rows], want[rows], dtype)


def test_bf16_flash_refuses_unaligned_inputs(card):
    """The bf16 route reads q/k/v by TMA: a q that starts off a 16-byte
    boundary raises, it is not copied or read wrong."""
    q = _rand((1 * 4 * 16 * 64 + 1,), 1, torch.bfloat16)[1:].view(1, 4, 16, 64)
    k, v = (_rand((1, 2, 16, 64), s, torch.bfloat16) for s in (2, 3))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("B,H,KH,L,D,lens", [
    (3, 8, 2, 100, 64, (1, 33, 100)),
    (2, 32, 8, 77, 64, (77, 2)),
    (1, 4, 4, 9, 128, (5,)),
    # llama's decode (G 4, D 64) and jamba's (D 128): lengths of 1, on the
    # 64-key tile and split edges, and off them; S off the tile
    (8, 32, 8, 1024, 64, (1, 64, 65, 341, 342, 700, 1023, 1024)),
    (8, 32, 8, 256, 128, (1, 63, 64, 65, 85, 86, 255, 256)),
    (4, 8, 8, 200, 64, (1, 64, 128, 200)),          # G 1
    (3, 16, 2, 130, 128, (2, 129, 130)),            # G 8
    # the reference's other head shapes: gpt2-2.5b (D 96), kimi-k2 (D 112),
    # pixtral-12b (D 160), granite-20b (MQA, G 48 x D 128)
    (2, 20, 20, 150, 96, (150, 77)),
    (2, 64, 8, 300, 112, (1, 300)),
    (2, 32, 8, 257, 160, (256, 257)),
    (2, 48, 1, 500, 128, (499, 3)),
    # whisper's cross cache: G 1, every length the 1,500 frames
    (8, 16, 16, 1500, 64, (1500,) * 8),
    # one of two tensor-parallel ranks: whisper-medium's cross cache and
    # self cache (8 / 8 heads), jamba's (16 / 4 of 128), pixtral-12b's
    # (16 / 4 of 160)
    (8, 8, 8, 1500, 64, (1500,) * 8),
    (8, 8, 8, 448, 64, (1, 8, 9, 24, 63, 64, 65, 448)),
    (8, 16, 4, 1024, 128, (1, 64, 65, 341, 342, 700, 1023, 1024)),
    (8, 16, 4, 1024, 160, (1, 77, 700, 1023, 1024, 5, 333, 512)),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(card, B, H, KH, L, D, lens, dtype):
    q = _rand((B, H, D), 1, dtype)
    k, v = _rand((B, KH, L, D), 2, dtype), _rand((B, KH, L, D), 3, dtype)
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    want = ref.decode_attention_ref(q, k, v, n)
    _close_tight(decode_attention(q, k, v, n), want, dtype)
    # garbage past each length must not leak in
    k2, v2 = k.clone(), v.clone()
    for b, m in enumerate(lens):
        k2[b, :, m:], v2[b, :, m:] = 1e4, -1e4
    _close_tight(decode_attention(q, k2, v2, n), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_is_deterministic(card, dtype):
    """The splits merge in a fixed order: two calls agree bitwise."""
    q = _rand((8, 32, 64), 4, dtype)
    k, v = (_rand((8, 8, 1024, 64), s, dtype) for s in (5, 6))
    n = torch.tensor((1, 77, 700, 1023, 1024, 5, 333, 512),
                     dtype=torch.int32, device="cuda")
    a, b = decode_attention(q, k, v, n), decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,H,KH,L,D,lens", [
    # phase 21a's shard: granite-20b's MQA heads on 512 of 1,024 positions
    (8, 48, 1, 512, 128, (0, 1, 63, 64, 65, 511, 512, 300)),
    (3, 32, 8, 300, 64, (0, 299, 130)),
    (2, 4, 2, 70, 16, (0, 0)),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_partial_mode(card, B, H, KH, L, D, lens, dtype):
    """``return_lse``: o as without it, the f32 log-sum-exp of the scaled
    scores within 1e-4 (f32) or 1e-3 (bf16), and a row of length 0 gives
    o = 0 and lse = -inf; two calls agree bitwise; layout A's output is
    the partial mode's o."""
    q = _rand((B, H, D), 1, dtype)
    k, v = _rand((B, KH, L, D), 2, dtype), _rand((B, KH, L, D), 3, dtype)
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o, lse = decode_attention(q, k, v, n, return_lse=True)
    want_o, want_lse = ref.decode_attention_ref(q, k, v, n, return_lse=True)
    _close_tight(o, want_o, dtype)
    empty = n == 0
    assert bool(torch.isneginf(lse[empty]).all())
    assert bool((o[empty] == 0).all())
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse[~empty], want_lse[~empty], rtol=0,
                               atol=tol)
    o2, lse2 = decode_attention(q, k, v, n, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    full = ~empty
    if bool(full.any()):
        assert torch.equal(decode_attention(q, k, v, n)[full], o[full])


def test_decode_kernel_refuses_unaligned_cache(card):
    """K/V tiles arrive by 16-byte copies: a k that starts off a 16-byte
    boundary raises, it is not copied or read wrong."""
    q = _rand((1, 4, 64), 1, torch.bfloat16)
    k = _rand((4 * 64 + 1,), 2, torch.bfloat16)[1:].view(1, 4, 1, 64)
    n = torch.tensor((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(q, k, k, n)


@pytest.mark.parametrize("n,d_in,d_out,act,bias", [
    (1, 64, 64, "none", False),
    (3, 100, 37, "silu", True),      # ragged: the plain-load route
    (8, 256, 520, "gelu", True),
    (11, 130, 64, "silu", False),    # more rows than one launch takes
    (5, 1000, 1000, "gelu", True),   # ragged d_in and d_out, 16-byte rows
    (8, 4096, 4104, "gelu", True),   # a column tile past d_out
    (2, 520, 1032, "none", True),    # slices that are no whole tile
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_matvec_kernel_matches_plain(card, n, d_in, d_out, act, bias, dtype):
    x = _rand((n, d_in), 1, dtype)
    w = _rand((d_in, d_out), 2, dtype, d_in ** -0.5)
    b = _rand((d_out,), 3, dtype) if bias else None
    _close_tight(pim_matvec(x, w, b, act), ref.matvec_ref(x, w, b, act),
                 dtype)


# (d_in, d_out) of every decode FC: llama3.2-1b, rwkv6-7b, jamba-v0.1-52b
SERVED_GEMV = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
               (4096, 4096), (4096, 14336), (14336, 4096), (4096, 8192),
               (8192, 4096), (4096, 1024)]


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("d_in,d_out", SERVED_GEMV)
def test_matvec_kernel_at_served_shapes(card, d_in, d_out, n):
    """bf16 at every served shape, silu on the widening ones as the MLP's
    gate; float32 (the parity phases' route) at 8 rows."""
    act = "silu" if d_out > d_in else "none"
    for dtype in (torch.bfloat16,) + ((torch.float32,) if n == 8 else ()):
        x = _rand((n, d_in), 1, dtype)
        w = _rand((d_in, d_out), 2, dtype, d_in ** -0.5)
        _close_tight(pim_matvec(x, w, None, act),
                     ref.matvec_ref(x, w, None, act), dtype)


# llama3.2-1b on one of two tensor-parallel ranks: q (d -> d/2), k and v
# (d -> 256), the row-parallel o (d/2 -> d), wg and wi (d -> f/2) and wo
# (f/2 -> d) at the engine's 8 rows; decode attention and a prefill chunk
# at 16 / 4 heads
TP2_GEMV = [(2048, 1024, "none"), (2048, 256, "none"), (1024, 2048, "none"),
            (2048, 4096, "silu"), (2048, 4096, "none"), (4096, 2048, "none")]


@pytest.mark.parametrize("d_in,d_out,act", TP2_GEMV)
@pytest.mark.parametrize("dtype", DTYPES)
def test_matvec_kernel_at_tensor_parallel_shapes(card, d_in, d_out, act,
                                                 dtype):
    x = _rand((8, d_in), 1, dtype)
    w = _rand((d_in, d_out), 2, dtype, d_in ** -0.5)
    _close_tight(pim_matvec(x, w, None, act),
                 ref.matvec_ref(x, w, None, act), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_kernels_at_tensor_parallel_heads(card, dtype):
    lens = (1, 77, 700, 1023, 1024, 5, 333, 512)
    q = _rand((8, 16, 64), 1, dtype)
    k, v = _rand((8, 4, 1024, 64), 2, dtype), _rand((8, 4, 1024, 64), 3, dtype)
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    _close_tight(decode_attention(q, k, v, n),
                 ref.decode_attention_ref(q, k, v, n), dtype)
    q = _rand((8, 16, 128, 64), 4, dtype)
    k, v = k[:, :, :640], v[:, :, :640]
    _close_tight(flash_attention(q, k, v, causal=True, q_offset=512),
                 ref.flash_attention_ref(q, k, v, causal=True, q_offset=512),
                 dtype)


# the decode FCs of the recurrent, hybrid, encoder-decoder and VLM
# families on one of two tensor-parallel ranks (``chip_smoke.tp_gemv_plan``):
# rwkv6-7b's r, k, v, g (d -> 2048), wo, wck, wcv and the whole wcr;
# jamba's in_proj x, z and out_proj (d_inner 4096 a rank), its attention
# (16 / 4 heads of 128) and MLP; whisper-medium's q, k, v, o, cross q and
# o and GELU MLP; pixtral-12b's (16 / 4 heads of 160) and MLP
FAMILY_TP2_GEMV = [
    (4096, 2048, "none"), (2048, 4096, "none"), (4096, 7168, "none"),
    (7168, 4096, "none"), (4096, 4096, "none"), (4096, 512, "none"),
    (4096, 7168, "silu"), (1024, 512, "none"), (512, 1024, "none"),
    (1024, 2048, "gelu"), (2048, 1024, "none"), (5120, 2560, "none"),
    (5120, 640, "none"), (2560, 5120, "none"), (5120, 7168, "silu"),
    (5120, 7168, "none"), (7168, 5120, "none")]


@pytest.mark.parametrize("d_in,d_out,act", FAMILY_TP2_GEMV)
@pytest.mark.parametrize("dtype", DTYPES)
def test_matvec_kernel_at_family_tensor_parallel_shapes(card, d_in, d_out,
                                                        act, dtype):
    x = _rand((8, d_in), 1, dtype)
    w = _rand((d_in, d_out), 2, dtype, d_in ** -0.5)
    _close_tight(pim_matvec(x, w, None, act),
                 ref.matvec_ref(x, w, None, act), dtype)


@pytest.mark.parametrize("B,H,KH,S,D", [
    (2, 16, 4, 2048, 128),     # jamba's prefill step on a rank
    (2, 16, 4, 1024, 160),     # pixtral-12b's, 256 patches + 768 tokens
    (2, 8, 8, 448, 64),        # whisper-medium's decoder
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_at_family_tensor_parallel_heads(card, B, H, KH, S, D,
                                                      dtype):
    """The causal full-sequence calls of the prefill steps on one of two
    tensor-parallel ranks."""
    q = _rand((B, H, S, D), 1, dtype)
    k, v = _rand((B, KH, S, D), 2, dtype), _rand((B, KH, S, D), 3, dtype)
    _close_tight(flash_attention(q, k, v, causal=True),
                 ref.flash_attention_ref(q, k, v, causal=True), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_matvec_kernel_is_deterministic(card, dtype):
    """The K-slices sum in a fixed order: two calls agree bitwise."""
    x = _rand((8, 8192), 1, dtype)
    w = _rand((8192, 2048), 2, dtype, 8192 ** -0.5)
    b = _rand((2048,), 3, dtype)
    a, c = pim_matvec(x, w, b, "gelu"), pim_matvec(x, w, b, "gelu")
    torch.cuda.synchronize()
    assert torch.equal(a, c)


@pytest.mark.parametrize("mode", ["rmsnorm", "layernorm", "np_layernorm"])
@pytest.mark.parametrize("rows,d", [(1, 64), (7, 300)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_kernel_matches_plain(card, mode, rows, d, dtype):
    x = _rand((rows, d), 1, dtype, 3.0)
    s, b = _rand((d,), 2, dtype), _rand((d,), 3, dtype)
    s = s if mode != "np_layernorm" else None
    b = b if mode == "layernorm" else None
    _close(layernorm(x, s, b, mode=mode), ref.norm_ref(x, s, b, mode=mode),
           dtype)


@pytest.mark.parametrize("mode", ["rmsnorm", "layernorm", "np_layernorm"])
@pytest.mark.parametrize("rows,d", [
    (1024, 2048), (8, 2048), (8, 4096), (4096, 4096),   # the served shapes
    (1027, 2048),          # rows no power of two
    (33, 3000),            # d no power of two (8 warps over 4096 lanes)
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_kernel_at_served_shapes(card, mode, rows, d, dtype):
    """At the paths' shapes, where the warp count follows d, and ragged
    ones."""
    x = _rand((rows, d), 4, dtype, 3.0)
    s, b = _rand((d,), 5, dtype), _rand((d,), 6, dtype)
    s = s if mode != "np_layernorm" else None
    b = b if mode == "layernorm" else None
    _close(layernorm(x, s, b, mode=mode), ref.norm_ref(x, s, b, mode=mode),
           dtype)


def test_each_launch_counts_once(card):
    ops.reset_launch_counts()
    x, w = _rand((10, 64), 1, torch.float32), _rand((64, 32), 2, torch.float32)
    ops.fused_matvec(x, w)                      # 10 rows: two launches
    ops.layernorm(x, x[0], mode="rmsnorm")
    q, k = _rand((2, 4, 8, 32), 3, torch.float32), \
        _rand((2, 2, 24, 32), 4, torch.float32)
    info = _segment_layout(2, 8, (16, 0), 5)
    ops.flash_attention(q, k, k, segment_info=info)
    ops.flash_attention(q, k, k, segment_info=info)
    torch.cuda.synchronize()
    r = _rand((6, 70, 16), 6, torch.float32)
    ops.rwkv_chunk(r, r, r, torch.sigmoid(r), r[:3, 0])
    ops.masked_softmax(q, q > 0)
    a = torch.sigmoid(_rand((2, 9, 40, 16), 7, torch.float32))
    ops.mamba_chunk(a, a, a[:, :, 0])
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_segmented": 2,
                                   "decode_attention": 0, "pim_matvec": 2,
                                   "layernorm": 1, "rwkv_chunk": 1,
                                   "masked_softmax": 1, "mamba_chunk": 1,
                                   "flash_attention_bwd": 0,
                                   "layernorm_bwd": 0, "rwkv_chunk_bwd": 0,
                                   "mamba_chunk_bwd": 0}


def _rwkv_inputs(BH, T_, K, dtype, seed, strong=False):
    """r, k, v in ``dtype``; the model's decays in f32 (exp(-exp(w0)) with
    w0 = log U(1e-3, 1), so many lie near 1; ``strong``: w0 over ssm.py's
    clamp [-10, 4], down to about 2e-24 a step); u in f32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn((BH, T_, K), generator=g, device="cuda") * 0.5
               for _ in range(3))
    w0 = (torch.rand((BH, T_, K), generator=g, device="cuda") * 14 - 10
          if strong else
          torch.log(torch.rand((BH, T_, K), generator=g, device="cuda")
                    * (1 - 1e-3) + 1e-3))
    u = torch.randn((BH, K), generator=g, device="cuda") * 0.1
    return r.to(dtype), k.to(dtype), v.to(dtype), torch.exp(-torch.exp(w0)), u


@pytest.mark.parametrize("BH,T_,K", [
    (128, 2048, 64),       # the full-sequence prefill of rwkv6-7b, B 2
    (32, 2048, 64),        # B 1 on one of two tensor-parallel ranks
    (4, 200, 64),          # ragged last chunk
    (6, 37, 16),           # one ragged chunk, a narrow head
    (2, 1, 64),            # one step
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_chunk_kernel_matches_plain(card, BH, T_, K, dtype):
    """y in r's dtype and the final state in f32; f32 within the
    reference's 2e-3 for the chunked form (test_kernels.py), bf16 (the
    tensor-core route) within 1e-2 + 2e-2 |want|, which a kernel that
    drops one off-diagonal block fails."""
    r, k, v, w, u = _rwkv_inputs(BH, T_, K, dtype, 7)
    y, s = rwkv_chunk(r, k, v, w, u)
    want_y, want_s = ref.rwkv_chunk_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    tol = dict(rtol=2e-3, atol=2e-3) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=1e-2)
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(s, want_s, **tol)


@pytest.mark.parametrize("BH,T_,K", [(16, 512, 64), (5, 77, 37)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_chunk_kernel_at_strong_decays(card, BH, T_, K, dtype):
    """The model's whole decay range: every output finite, y in f32 and
    the state within the chunked form's 2e-3 in both routes."""
    r, k, v, w, u = _rwkv_inputs(BH, T_, K, dtype, 9, strong=True)
    assert float(w.min()) < 1e-20
    y, s = rwkv_chunk(r, k, v, w, u, out_dtype=torch.float32)
    want_y, want_s = ref.rwkv_chunk_ref(r, k, v, w, u,
                                        out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(y, want_y, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(s, want_s, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_chunk_kernel_is_deterministic(card, dtype):
    r, k, v, w, u = _rwkv_inputs(8, 300, 64, dtype, 10, strong=True)
    y1, s1 = rwkv_chunk(r, k, v, w, u)
    y2, s2 = rwkv_chunk(r, k, v, w, u)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_rwkv_chunk_kernel_writes_y_in_the_dtype_asked(card):
    """bf16 inputs, y in f32 (the model path), u broadcast over the batch
    from (H, K)."""
    r, k, v, w, u = _rwkv_inputs(8, 130, 64, torch.bfloat16, 8)
    y, s = ops.rwkv_chunk(r, k, v, w, u[:4], out_dtype=torch.float32)
    want_y, want_s = ref.rwkv_chunk_ref(r, k, v, w, u[:4].repeat(2, 1),
                                        out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, want_y, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(s, want_s, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("rows,n", [(8 * 32 * 128, 640), (7, 100),
                                    (33, 4096), (5, 5000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_softmax_kernel_matches_plain(card, rows, n, dtype):
    """A causal bitmap with random holes and three fully masked rows:
    masked entries exactly 0, fully masked rows all 0, other rows summing
    to 1."""
    g = torch.Generator(device="cuda").manual_seed(9)
    x = (torch.randn((rows, n), generator=g, device="cuda") * 3).to(dtype)
    keep = (torch.arange(n, device="cuda")[None, :]
            <= (torch.arange(rows, device="cuda")[:, None] % n)) \
        & (torch.rand((rows, n), generator=g, device="cuda") > 0.1)
    keep[:, 0] = True
    keep[1::max(rows // 3, 2)][:3] = False
    for mask in (keep, keep.to(torch.int8)):
        got = masked_softmax(x, mask.contiguous())
        want = ref.masked_softmax_ref(x, keep)
        _close(got, want, dtype)
        assert bool((got[~keep] == 0).all())
        sums = got.float().sum(-1)
        live = keep.any(-1)
        assert bool((sums[~live] == 0).all())
        torch.testing.assert_close(sums[live], torch.ones_like(sums[live]),
                                   **_tol(dtype))


def test_rwkv_forward_full_and_engine_on_the_card_match_the_cpu(card):
    """The reduced rwkv6-7b in float32: the full-sequence prefill step's
    logits through rwkv_chunk (once per layer) agree with the plain path,
    and the engine gives its greedy tokens and counters."""
    cfg = dataclasses.replace(get_arch("rwkv6-7b").reduced(),
                              dtype="float32")
    params = init_params(T.param_defs(cfg), device="cpu", seed=6)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 40)))
    logits, runs = [], []
    for dev in ("cuda", "cpu"):
        p = _tree(lambda a: a.float().to(dev), params)
        ops.reset_launch_counts()
        logits.append(T.forward_full(cfg, p, tokens.to(dev),
                                     last_only=True)[0].cpu())
        if dev == "cuda":
            assert ops.launch_counts()["rwkv_chunk"] == cfg.num_layers
        eng = ServeEngine(cfg, p, ServeConfig(max_slots=3, max_len=48),
                          device=dev)
        for n in (3, 12, 1, 7):
            eng.add_request(tokens[0, :n].numpy(), max_new_tokens=5)
        runs.append((eng.run_until_done(), eng.dispatch_counts,
                     eng.host_syncs))
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-4, atol=1e-4)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("kv_update", ["onehot", "scatter"])
@pytest.mark.parametrize("pack,kv_dtype", [(False, "bf16"), (True, "bf16"),
                                           (False, "int8"), (True, "int8")])
def test_engine_on_the_card_matches_the_cpu(card, kv_update, pack, kv_dtype):
    """The reduced llama in float32 through the kernels gives the plain
    path's greedy tokens and counters, packed or not, bf16 or int8
    cache."""
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32", kv_update=kv_update,
                              kv_dtype=kv_dtype)
    params = init_params(T.param_defs(cfg), device="cpu", seed=4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (3, 20, 1, 41)]
    runs = []
    for dev in ("cuda", "cpu"):
        p = _tree(lambda a: a.float().to(dev), params)
        eng = ServeEngine(cfg, p, ServeConfig(max_slots=3, max_len=48,
                                              prefill_chunk=16, pack=pack),
                          device=dev)
        for pr in prompts:
            eng.add_request(pr, max_new_tokens=6)
        runs.append((eng.run_until_done(), eng.dispatch_counts,
                     eng.host_syncs))
    assert runs[0] == runs[1]


def _mamba_inputs(B, T_, d, n, dtype, seed):
    """The model's discretization: a = exp(dt A) with dt = softplus(.) and
    A = -exp(log U), so decays lie in (0, 1), many near 1; u = dt x B."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T_, d), generator=g, device="cuda") - 2)
    A = -torch.exp(-torch.log(torch.rand((d, n), generator=g, device="cuda")
                              * (1 - 1e-3) + 1e-3))
    a = torch.exp(dt[..., None] * A)
    u = (dt * torch.randn((B, T_, d), generator=g, device="cuda"))[..., None] \
        * torch.randn((B, T_, 1, n), generator=g, device="cuda") * 0.1
    C = torch.randn((B, T_, n), generator=g, device="cuda")
    return a.to(dtype), u.to(dtype), C.to(dtype)


@pytest.mark.parametrize("B,T_,d,n", [
    (2, 2048, 8192, 16),   # jamba-v0.1-52b's full-sequence prefill step
    (2, 2048, 4096, 16),   # the same on one of two tensor-parallel ranks
    (1, 200, 8192, 16),    # ragged T
    (2, 37, 128, 4),       # the reduced config's widths
    (3, 5, 100, 5),        # a d_state that is no power of two
    (1, 1, 7, 32),         # one step, the widest d_state
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_chunk_kernel_matches_plain(card, B, T_, d, n, dtype):
    """y in a's dtype and h_T in f32, within f32's 1e-4 and bf16's 5e-2."""
    a, u, C = _mamba_inputs(B, T_, d, n, dtype, 11)
    y, h = mamba_chunk(a, u, C)
    want_y, want_h = ref.mamba_chunk_ref(a, u, C)
    torch.cuda.synchronize()
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), **_tol(dtype))
    torch.testing.assert_close(h, want_h, **_tol(dtype))


@pytest.mark.parametrize("case", [
    "d_state 33", "u shape", "C shape", "mixed dtypes", "float16",
    "not contiguous", "rank 3",
])
def test_mamba_chunk_kernel_refuses_what_it_cannot_compute(card, case):
    """Bad shapes and dtypes raise before a launch, and count nothing."""
    a, u, C = _mamba_inputs(2, 6, 8, 4, torch.float32, 12)
    args = {"d_state 33": lambda: (
                *_mamba_inputs(1, 2, 8, 33, torch.float32, 13),),
            "u shape": lambda: (a, u[:, :5], C),
            "C shape": lambda: (a, u, C[..., :3]),
            "mixed dtypes": lambda: (a, u.to(torch.bfloat16), C),
            "float16": lambda: tuple(t.half() for t in (a, u, C)),
            "not contiguous": lambda: (a.transpose(1, 2), u.transpose(1, 2),
                                       C),
            "rank 3": lambda: (a[:, :, 0], u[:, :, 0], C)}[case]()
    ops.reset_launch_counts()
    with pytest.raises((ValueError, TypeError)):
        mamba_chunk(*args)
    assert ops.launch_counts()["mamba_chunk"] == 0


def test_dense_forward_full_on_the_card_matches_the_cpu(card):
    """The reduced llama in float32: the full-sequence forward's attention
    (K after RoPE, V a transposed view of the projection) through the
    static flash kernel agrees with the plain path."""
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32")
    params = init_params(T.param_defs(cfg), device="cpu", seed=8)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 40)))
    out = []
    for dev in ("cuda", "cpu"):
        p = _tree(lambda a: a.float().to(dev), params)
        ops.reset_launch_counts()
        out.append(T.forward_full(cfg, p, tokens.to(dev))[0].cpu())
        if dev == "cuda":
            assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(out[0], out[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["whisper-medium", "pixtral-12b"])
def test_encdec_and_vlm_forward_on_the_card_match_the_cpu(card, name):
    """The reduced whisper (the encoder's non-causal flash, the decoder's
    cross attention against it) and pixtral (its patch prefix) in
    float32: the full-sequence forward, ``prefill_with_cache`` and a
    decode step against the filled cross cache on the card agree with the
    plain path on the CPU."""
    from repro_torch.data import batch_for
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32",
                              encoder_seq=24)
    params = init_params(T.param_defs(cfg), device="cpu", seed=8)
    b = batch_for(cfg, 2, 12 + cfg.num_patches, seed=9)
    stub = {k: torch.from_numpy(v) for k, v in b.items()
            if k in ("frame_embeds", "patch_embeds")}
    tokens = torch.from_numpy(b["tokens"])
    out = []
    for dev in ("cuda", "cpu"):
        p = _tree(lambda a: a.float().to(dev), params)
        kw = {k: v.to(dev) for k, v in stub.items()}
        ops.reset_launch_counts()
        full = T.forward_full(cfg, p, tokens.to(dev), **kw)[0].cpu()
        if dev == "cuda":
            assert ops.launch_counts()["flash_attention"] == \
                cfg.encoder_layers + cfg.num_layers * (
                    2 if name == "whisper-medium" else 1)
        cache = init_params(T.cache_defs(cfg, 2, 32), device=dev)
        last, cache, lens = T.prefill_with_cache(
            cfg, p, tokens.to(dev), cache,
            frame_embeds=kw.get("frame_embeds"))
        step, _ = T.decode_step(cfg, p, last.argmax(-1)[:, None], cache,
                                lens)
        out.append((full, last.cpu(), step.cpu()))
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_moe_on_the_card_repeats_its_bits(card):
    """qwen3-moe's MoE FFN (128 experts, top-8) in bf16 on a prefill
    chunk's rows: two calls give the same bits (the combine sums each
    token's 8 expert outputs in a fixed order, where a scatter-add's
    atomics would vary it). Its values are held to the CPU in float32 by
    ``chip_smoke.py`` phase 11b."""
    from repro_torch.models import moe as M
    cfg = get_arch("qwen3-moe-30b-a3b")
    p = init_params(M.moe_defs(cfg),
                    torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    x = _rand((4, 64, cfg.d_model), 1, torch.bfloat16)
    y1, aux1 = M.apply_moe(cfg, p, x)
    y2, aux2 = M.apply_moe(cfg, p, x)
    torch.cuda.synchronize()
    assert y1.shape == x.shape and bool(torch.isfinite(y1).all())
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)


def test_jamba_forward_full_and_engine_on_the_card_match_the_cpu(card):
    """The reduced jamba-v0.1-52b in float32: the full-sequence prefill
    step's logits and aux loss through mamba_chunk (once per Mamba layer)
    and flash (once per attention layer) agree with the plain path, and the
    engine gives its greedy tokens and counters."""
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b").reduced(),
                              dtype="float32")
    params = init_params(T.param_defs(cfg), device="cpu", seed=6)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 40)))
    logits, aux, runs = [], [], []
    for dev in ("cuda", "cpu"):
        p = _tree(lambda a: a.float().to(dev), params)
        ops.reset_launch_counts()
        lg, ax = T.forward_full(cfg, p, tokens.to(dev), last_only=True)
        logits.append(lg.cpu())
        aux.append(float(ax))
        if dev == "cuda":
            counts = ops.launch_counts()
            assert counts["mamba_chunk"] == 2
            assert counts["flash_attention"] == 2
        eng = ServeEngine(cfg, p, ServeConfig(max_slots=3, max_len=48),
                          device=dev)
        for n in (3, 12, 1, 7):
            eng.add_request(tokens[0, :n].numpy(), max_new_tokens=5)
        runs.append((eng.run_until_done(), eng.dispatch_counts,
                     eng.host_syncs))
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-4, atol=1e-4)
    assert abs(aux[0] - aux[1]) <= 1e-4
    assert runs[0] == runs[1]


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} if isinstance(t, dict) \
        else fn(t)


def _serving_state(dtype, dev, B=4, L=64, seed=8):
    """The reduced llama in ``dtype`` on ``dev`` with a random cache: slots
    0 and 1 ready (lengths 10 and 40), slots 2 and 3 parked mid-prefill at
    max_len-1. Returns (cfg, params, cache, decode state)."""
    name = str(dtype).replace("torch.", "")
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(), dtype=name)
    params = _tree(lambda a: a.to(dev, dtype),
                   init_params(T.param_defs(cfg), device="cpu", seed=seed))
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, L, cfg.head_dim)
    cache = {"pos0": {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype) for k in ("k", "v")}}
    state = [torch.tensor(a, device=dev) for a in (
        np.array([5, 9, 0, 0], np.int32), np.array([10, 40, L - 1, L - 1],
                                                   np.int32),
        np.array([True, True, False, False]), np.zeros(B, np.int32),
        np.full(B, 6, np.int32))]
    return cfg, params, cache, state


def _chunk(pack: bool, dev, B=4, C=16):
    """A prefill chunk of slots 2 and 3 for the fused step: unpacked at
    offset 16, or the last dispatch of their wave packed."""
    from types import SimpleNamespace

    from repro_torch.sched import plan_packed_job
    rng = np.random.default_rng(9)
    if not pack:
        valid = np.zeros((B, C), bool)
        valid[2, :], valid[3, :7] = True, True
        return dict(tokens=rng.integers(0, 256, (B, C)).astype(np.int32),
                    tok_valid=valid, offset=16)
    wave = [(s, SimpleNamespace(prompt=rng.integers(0, 256, n)))
            for s, n in ((2, 37), (3, 9))]
    d = plan_packed_job(wave, max_slots=B, chunk=C,
                        sub_batch=0).dispatches[-1]
    return dict(tokens=d.tokens, seg_slot=d.seg_slot, seg_pos=d.seg_pos,
                seg_ids=d.seg_ids, tok_valid=d.valid, row_slot=d.row_slot,
                prefix_len=d.prefix_len, prefix_span=d.prefix_span)


def _fused(cfg, params, cache, state, chunk, dev, fused: bool,
           draw=None, temperature=0.0):
    """One overlapped step: ``T.fused_step``, or its unfused pair
    (``decode_and_sample``, then the chunk). Returns (fetch, cache)."""
    arrays = {k: torch.as_tensor(v, device=dev)
              for k, v in chunk.items() if k not in ("offset", "prefix_span")}
    static = {k: chunk[k] for k in ("offset", "prefix_span") if k in chunk}
    sample = dict(temperature=temperature, eos_token=None, max_len=64)
    packed = "prefix_span" in chunk
    names = (["tokens", "seg_slot", "seg_pos", "seg_ids", "tok_valid",
              "row_slot", "prefix_len"] if packed else ["tokens", "tok_valid"])
    layout = [arrays[k] for k in names]
    fn = T.prefill_chunk_packed if packed else T.prefill_chunk

    def chunk_fn(c):
        return fn(cfg, params, layout[0], c, *layout[1:], **static)
    if fused:
        fetch, cache, *_, draw = T.fused_step(cfg, params, cache, chunk_fn,
                                              *state, draw, **sample)
        return fetch, cache, draw
    fetch, cache, *_, draw = T.decode_and_sample(cfg, params, cache, *state,
                                                 draw, **sample)
    return fetch, chunk_fn(cache), draw


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_step_on_the_card(card, dtype, pack):
    """A fused step (two slots decoding, two parked slots prefilling) runs
    the decode kernels and flash (once per layer) and gives its unfused
    pair's fetch and cache bit for bit (the same kernels in the same
    order); in float32 it is within 1e-4 of the plain path on the CPU."""
    chunk = _chunk(pack, "cuda")
    cfg, params, cache, state = _serving_state(dtype, "cuda")
    ops.reset_launch_counts()
    got = _fused(cfg, params, _tree(torch.clone, cache), state, chunk,
                 "cuda", fused=True)
    counts = ops.launch_counts()
    flash = "flash_attention_segmented" if pack else "flash_attention"
    assert counts[flash] == cfg.num_layers
    assert counts["decode_attention"] == cfg.num_layers
    assert counts["pim_matvec"] > 0 and counts["layernorm"] > 0
    want = _fused(cfg, params, _tree(torch.clone, cache), state, chunk,
                  "cuda", fused=False)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for key, leaf in got[1]["pos0"].items():
        assert torch.equal(leaf, want[1]["pos0"][key]), key
    if dtype == torch.float32:
        cfg, params, cache, state = _serving_state(dtype, "cpu")
        plain = _fused(cfg, params, cache, state, chunk, "cpu", fused=True)
        assert torch.equal(got[0].cpu(), plain[0])
        for key, leaf in got[1]["pos0"].items():
            torch.testing.assert_close(leaf.cpu(), plain[1]["pos0"][key],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_superstep_on_the_card(card, dtype):
    """A k=4 superstep (lane 0 reaches the max_len-1 cap at round 2, lane 1
    runs on, the parked lanes stay frozen) launches the decode kernels 4
    times a layer and gives the fetches and cache of four single steps bit
    for bit; in float32 it is within 1e-4 of the plain path on the CPU."""
    cfg, params, cache, state = _serving_state(dtype, "cuda")
    state[1][0] = 61                           # 3 rounds short of max_len 64
    sample = dict(temperature=0.0, eos_token=None, max_len=64)
    ops.reset_launch_counts()
    got, got_cache, *_ = T.decode_superstep(
        cfg, params, _tree(torch.clone, cache), *state, None, k=4, **sample)
    assert ops.launch_counts()["decode_attention"] == 4 * cfg.num_layers
    one_cache, (tok, lens, active, gen, max_new) = \
        _tree(torch.clone, cache), list(state)
    want = []
    for _ in range(4):
        fetch, one_cache, tok, lens, gen, _ = T.decode_and_sample(
            cfg, params, one_cache, tok, lens, active, gen, max_new, None,
            **sample)
        active = active & (fetch[1] == 0)
        want.append(fetch)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.stack(want))
    assert got[1, 1, 0] == 1 and bool((got[2:, 2, 0] == 63).all())
    for key, leaf in got_cache["pos0"].items():
        assert torch.equal(leaf, one_cache["pos0"][key]), key
    if dtype == torch.float32:
        cfg, params, cache, state = _serving_state(dtype, "cpu")
        state[1][0] = 61
        plain, plain_cache, *_ = T.decode_superstep(
            cfg, params, cache, *state, None, k=4, **sample)
        assert torch.equal(got.cpu(), plain)
        for key, leaf in got_cache["pos0"].items():
            torch.testing.assert_close(leaf.cpu(), plain_cache["pos0"][key],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sampled_steps_on_the_card_issue_no_sync(card, dtype):
    """Temperature 0.8 under CUDA's sync debug mode set to raise: a k=4
    superstep (lane 0 reaches the max_len-1 cap at round 2, lane 1 its
    max_new at round 3, so round 4 is dead) gives four single steps'
    fetches and draw counter (3: the dead round draws nothing) bit for bit,
    and a packed fused step its unfused pair's. The noise's bits are the
    CPU's; its logs are each device's own float32 ``log``, so within a
    few units in the last place."""
    cfg, params, cache, state = _serving_state(dtype, "cuda")
    state[1][0], state[4][1] = 61, 3
    chunk = {k: torch.as_tensor(v, device="cuda") if isinstance(
        v, np.ndarray) else v for k, v in _chunk(True, "cuda").items()}
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    sample = dict(temperature=0.8, eos_token=None, max_len=64, seed=5)
    caches = [_tree(torch.clone, cache) for _ in range(5)]
    # the kernels built and loaded before the sync check
    _fused(cfg, params, caches[4], state, chunk, "cuda", True, zero, 0.8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, got_cache, *_, got_draw = T.decode_superstep(
            cfg, params, caches[0], *state, zero, k=4, **sample)
        one_cache, draw = caches[1], zero
        tok, lens, active, gen, max_new = state
        want = []
        for _ in range(4):
            fetch, one_cache, tok, lens, gen, draw = T.decode_and_sample(
                cfg, params, one_cache, tok, lens, active, gen, max_new,
                draw, **sample)
            active = active & (fetch[1] == 0)
            want.append(fetch)
        fused = _fused(cfg, params, caches[2], state, chunk, "cuda", True,
                       zero, 0.8)
        pair = _fused(cfg, params, caches[3], state, chunk, "cuda", False,
                      zero, 0.8)
        noise = T.gumbel_noise(5, zero + 2, (4, cfg.vocab_size), "cuda")
        bits = T.uniform_noise(5, zero + 2, (4, cfg.vocab_size), "cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, torch.stack(want))
    assert int(got_draw) == int(draw) == 3
    assert got[1, 1, 0] == 1 and got[2, 1, 1] == 1
    for key, leaf in got_cache["pos0"].items():
        assert torch.equal(leaf, one_cache["pos0"][key]), key
    assert torch.equal(fused[0], pair[0]) and int(fused[2]) == 1
    for key, leaf in fused[1]["pos0"].items():
        assert torch.equal(leaf, pair[1]["pos0"][key]), key
    cpu_draw = torch.tensor(2)
    assert torch.equal(bits.cpu(), T.uniform_noise(
        5, cpu_draw, (4, cfg.vocab_size), "cpu"))
    torch.testing.assert_close(noise.cpu(), T.gumbel_noise(
        5, cpu_draw, (4, cfg.vocab_size), "cpu"), rtol=4 * 2.0 ** -23,
        atol=4 * 2.0 ** -23)


# --------------------------------------------------------------------------- #
# KV snapshots on the card
# --------------------------------------------------------------------------- #
def _snapshot_engine(kv_dtype="bfloat16"):
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              kv_dtype=kv_dtype)
    params = init_params(T.param_defs(cfg), device="cuda", seed=0)
    scfg = ServeConfig(max_slots=4, max_len=64, prefill_chunk=8)
    return cfg, params, scfg


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_snapshot_round_trip_through_disk_is_bitwise(card, tmp_path,
                                                     kv_dtype):
    """A ready slot's KV rows exported from the card, published to a
    disk-backed ``SnapshotStore``, reloaded after the owner's crash and
    restored into another engine's slot come back bit for bit."""
    from repro_torch.chaos import SnapshotStore
    from repro_torch.checkpoint import flatten_tree

    cfg, params, scfg = _snapshot_engine(kv_dtype)
    src = ServeEngine(cfg, params, scfg, device=card)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 21)
    src.add_request(prompt, 20, gid=5)
    for _ in range(5):
        src.step()
    entries = src.export_kv_snapshot()
    assert [e["gid"] for e in entries] == [5] and src.export_transfers == 1
    store = SnapshotStore(root=str(tmp_path))
    store.put(0, entries, tick=4)
    store.drop_node(0)
    rec = store.lookup(5)
    assert store.stats["disk_loads"] == 1
    P, slot = rec["prefix_len"], entries[0]["slot"]
    dst = ServeEngine(cfg, params, scfg, device=card)
    dst.add_request(np.concatenate([prompt, entries[0]["generated"]]), 3,
                    gid=5, restore={"prefix_len": P, "cache": rec["cache"],
                                    "bytes": rec["bytes"]})
    dst.admit_wave()
    got, want = flatten_tree(dst.cache), flatten_tree(src.cache)
    for key in want:
        assert torch.equal(got[key][:, 0, :, :P].cpu(),
                           want[key][:, slot, :, :P].cpu()), key


def test_snapshot_export_adds_one_blocking_transfer(card):
    """Under CUDA's sync debug mode a serve with one export makes exactly
    its decode fetches' host syncs plus the export's one blocking
    transfer; the reference's ``export_syncs`` still counts a leaf an
    entry."""
    import warnings

    cfg, params, scfg = _snapshot_engine()
    eng = ServeEngine(cfg, params, scfg, device=card)
    rng = np.random.default_rng(4)
    for gid in range(3):
        eng.add_request(rng.integers(0, cfg.vocab_size, 9 + gid), 12,
                        gid=gid)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(4):
                eng.step()
            entries = eng.export_kv_snapshot()
            eng.run_until_done()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hidden = [w for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(entries) == 3 and eng.export_transfers == 1
    assert len(hidden) == 1
    assert eng.snapshot_stats["export_syncs"] == 3 * 2
    assert eng.host_syncs == eng.dispatch_counts["decode"]


# --------------------------------------------------------------------------- #
# the training path: the forward's lse, the flash and norm backward kernels
# --------------------------------------------------------------------------- #
def _bwd_inputs(B, H, KH, S, D, dtype, causal, seed, Skv=None):
    Skv = S if Skv is None else Skv
    q = _rand((B, H, S, D), seed, dtype)
    k, v = _rand((B, KH, Skv, D), seed + 1, dtype), \
        _rand((B, KH, Skv, D), seed + 2, dtype)
    do = _rand((B, H, S, D), seed + 3, dtype)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("B,H,KH,S,Skv,D,causal", [
    (2, 4, 2, 37, 37, 64, True),     # ragged S, GQA
    (1, 8, 2, 100, 100, 16, True),   # the reduced configs' head dim
    (2, 4, 4, 70, 70, 32, False),    # non-causal, MHA
    (1, 4, 1, 33, 33, 128, True),    # G 4 onto one KV head
    (1, 4, 2, 1, 1, 64, True),       # one position
    # S at the 64-row tiles' edges and one past the 128-key CTA
    (1, 4, 2, 63, 63, 64, True),
    (1, 4, 2, 64, 64, 64, True),
    (1, 4, 2, 65, 65, 64, True),
    (1, 4, 2, 127, 127, 64, True),
    (1, 4, 2, 129, 129, 64, True),
    (1, 8, 1, 200, 200, 64, True),   # G 8 onto one KV head
    (1, 4, 4, 448, 1500, 64, False),  # whisper's cross attention
] + [
    # the tensor-core route's narrower head dims (32- and 64-byte
    # swizzled rows) at one position, the tiles' edges and G 8, and
    # non-causal at ragged Sq != Skv
    (1, 4, 2, S, S, D, True) for D in (16, 32) for S in (1, 63, 65, 127, 129)
] + [(1, 8, 1, 200, 200, D, True) for D in (16, 32)] + [
    (1, 4, 2, 130, 300, D, False) for D in (16, 32)
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_kernel_matches_plain(card, B, H, KH, S, Skv, D, causal,
                                        dtype):
    """dq, dk, dv against the plain recomputing backward, from the same
    forward's o and lse; bitwise the same on a second call."""
    args = _bwd_inputs(B, H, KH, S, D, dtype, causal, 10, Skv)
    got = flash_attention_bwd(*args, causal=causal)
    again = flash_attention_bwd(*args, causal=causal)
    want = ref.flash_attention_bwd_ref(*args, causal=causal)
    for g, a, w in zip(got, again, want):
        _close_tight(g, w, dtype)
        assert torch.equal(g, a)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_writes_lse(card, causal, D, dtype):
    """The static mode's lse (natural log of the scaled scores; the bf16
    route keeps log2 units inside) against the plain one; the output is
    the one the serving path gets without it."""
    q, k, v = (_rand((2, 8, 70, D), 20, dtype),
               _rand((2, 2, 70, D), 21, dtype), _rand((2, 2, 70, D), 22, dtype))
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    o_want, lse_want = ref.flash_attention_ref(q, k, v, causal=causal,
                                               return_lse=True)
    _close_tight(o, o_want, dtype)
    _close(lse, lse_want, torch.float32)
    assert torch.equal(flash_attention(q, k, v, causal=causal), o)


@pytest.mark.parametrize("mode", ["rmsnorm", "layernorm", "np_layernorm"])
@pytest.mark.parametrize("rows,d", [(7, 300), (4096, 2048), (1027, 2048),
                                    (1, 2048), (8193, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_bwd_kernel_matches_plain(card, mode, rows, d, dtype):
    """dx, dscale, dbias against the plain version; bitwise the same on
    a second call (the partials are summed in a fixed order)."""
    x, dy = _rand((rows, d), 30, dtype, 3.0), _rand((rows, d), 31, dtype)
    s, b = _rand((d,), 32, dtype), _rand((d,), 33, dtype)
    s = s if mode != "np_layernorm" else None
    b = b if mode == "layernorm" else None
    got = layernorm_bwd(x, s, b, dy, mode=mode)
    again = layernorm_bwd(x, s, b, dy, mode=mode)
    want = ref.norm_bwd_ref(x, s, b, dy, mode=mode)
    for g, a, w in zip(got, again, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w, dtype)
            assert torch.equal(g, a)


def test_gradients_without_a_backward_kernel_raise_on_the_card(card):
    q = _rand((2, 4, 16), 40, torch.float32).requires_grad_()
    k = _rand((2, 2, 8, 16), 41, torch.float32)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.decode_attention(q, k, k, torch.ones(2, dtype=torch.int32))
    x = _rand((3, 16), 42, torch.float32).requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.fused_matvec(x, _rand((16, 8), 43, torch.float32))
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.flash_attention(q[:, :, None].expand(2, 4, 8, 16).contiguous(),
                            k, k, q_offset=3)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_steps_on_the_card_match_the_cpu(card, remat):
    """llama3.2-1b ``.reduced()`` in float32: three AdamW steps on the
    card (the flash and norm kernels forward and backward) against the
    same steps on the CPU (the plain versions): losses, every gradient
    leaf of the first step and the parameters after it within 1e-4, and
    the backward kernels launched once a layer (the norms 2 L + 1)."""
    from repro_torch.optim import adamw_init, linear_warmup_cosine
    from repro_torch.train import (TrainStepConfig, loss_and_grads,
                                   make_train_step)
    from repro_torch.data import SyntheticLM
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32", remat=remat)
    p_cpu = _tree_f32(init_params(T.param_defs(cfg), device="cpu", seed=3))
    p_gpu = _tree_to(p_cpu, "cuda")
    data = SyntheticLM(cfg.vocab_size, 48, 4)
    b0 = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    ops.reset_launch_counts()
    _, _, g_gpu = loss_and_grads(cfg, p_gpu, _tree_to(b0, "cuda"))
    torch.cuda.synchronize()
    n = cfg.num_layers
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd"] == n
    assert counts["layernorm_bwd"] == 2 * n + 1
    assert counts["flash_attention"] == n * (2 if remat == "full" else 1)
    _, _, g_cpu = loss_and_grads(cfg, p_cpu, b0)
    for a, c in zip(_leaves_of(g_gpu), _leaves_of(g_cpu)):
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-4)
    tcfg = TrainStepConfig(learning_rate=linear_warmup_cosine(1e-3, 1, 3))
    steps = [make_train_step(cfg, tcfg, device=d) for d in ("cuda", "cpu")]
    states = [[p_gpu, adamw_init(p_gpu)], [p_cpu, adamw_init(p_cpu)]]
    for i in range(3):
        losses = []
        for st, step in zip(states, steps):
            st[0], st[1], m = step(st[0], st[1], data.batch(i))
            losses.append(float(m["loss"]))
        assert abs(losses[0] - losses[1]) <= 1e-4 * (1 + abs(losses[1]))
    for a, c in zip(_leaves_of(states[0][0]), _leaves_of(states[1][0])):
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("BH,T_,K,U,strong,final", [
    (128, 2048, 64, 64, False, False),   # rwkv6-7b's training shape, B 2
    (32, 2048, 64, 32, False, False),    # B 1 on one of two ranks
    (4, 200, 64, 4, False, True),        # a ragged last sub-chunk, dS_T
    (6, 37, 16, 3, False, True),         # U < BH, K 16
    (16, 512, 64, 16, True, False),      # the model's strong decays
    (2, 1, 64, 1, False, True),          # one step
    (2, 48, 64, 2, True, True),          # a last stretch of 2 sub-chunks
    (3, 88, 37, 1, False, True),         # of 3, K 37
])
@pytest.mark.parametrize("dtype,dy_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_rwkv_chunk_bwd_kernel_matches_plain(card, BH, T_, K, U, strong,
                                             final, dtype, dy_dtype):
    """dr, dk, dv, dw and du against the plain adjoint recurrences; f32
    within the chunked wkv's 2e-3, bf16 inputs within 1e-2 + 2e-2 |want|
    (dr, dk, dv round to bf16); bitwise the same on a second call. The
    shapes reach every length of the kernel's last stretch of 32 steps
    (1 to 4 sub-chunks of 8)."""
    r, k, v, w, u = _rwkv_inputs(BH, T_, K, dtype, 11, strong=strong)
    u = u[:U].contiguous()
    dy = _rand((BH, T_, K), 12, dy_dtype)
    ds = _rand((BH, K, K), 13, torch.float32) if final else None
    got = rwkv_chunk_bwd(r, k, v, w, u, dy, ds)
    again = rwkv_chunk_bwd(r, k, v, w, u, dy, ds)
    want = ref.rwkv_chunk_bwd_ref(r, k, v, w, u, dy, ds)
    tol = dict(rtol=2e-3, atol=2e-3) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=1e-2)
    for g, a, w_ in zip(got, again, want):
        _close(g, w_, dtype, tol)
        assert torch.equal(g, a)


@pytest.mark.parametrize("B,T_,d,n,final", [
    (1, 2048, 8192, 16, False),   # jamba's training shape, B 1
    (2, 2048, 4096, 16, False),   # B 2 on one of two ranks (d_inner 4096)
    (1, 200, 8192, 16, True),     # a ragged last checkpoint, dh_T
    (2, 37, 128, 4, True),        # the reduced widths
    (2, 37, 100, 5, False),       # n no power of two
    (1, 1, 8, 32, True),          # one step, n 32
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_chunk_bwd_kernel_matches_plain(card, B, T_, d, n, final,
                                              dtype):
    """da, du, dC against the plain adjoint recurrence, a = exp(dt A) as
    the model makes it (down to 0), from the checkpoints that the forward
    kernel writes (h every 16 steps, held against the plain recurrence's);
    f32 within 2e-3, bf16 within 1e-2 + 2e-2 |want|; bitwise the same on
    a second call."""
    g = torch.Generator(device="cuda").manual_seed(14)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T_, d), generator=g, device="cuda") * 3)
    A = torch.rand((d, n), generator=g, device="cuda") * 20 + 1e-3
    a = (dt[..., None] * -A).exp().to(dtype)
    u = torch.randn((B, T_, d, n), generator=g, device="cuda").to(dtype)
    C = torch.randn((B, T_, n), generator=g, device="cuda").to(dtype)
    dy = torch.randn((B, T_, d), generator=g, device="cuda").to(dtype)
    dh = torch.randn((B, d, n), generator=g, device="cuda") if final \
        else None
    y, h, ck = mamba_chunk(a, u, C, checkpoints=True)
    y0, h0 = mamba_chunk(a, u, C)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    _close(ck, ref.mamba_checkpoints_ref(a, u), torch.float32)
    got = mamba_chunk_bwd(a, u, C, dy, dh, ck=ck)
    again = mamba_chunk_bwd(a, u, C, dy, dh, ck=ck)
    want = ref.mamba_chunk_bwd_ref(a, u, C, dy, dh)
    tol = dict(rtol=2e-3, atol=2e-3) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=1e-2)
    for x, y, z in zip(got, again, want):
        _close(x, z, dtype, tol)
        assert torch.equal(x, y)


def test_mamba_chunk_bwd_refuses_wrong_checkpoints(card):
    """The backward kernel takes the forward's checkpoints or raises: it
    never recomputes them."""
    a = torch.rand((1, 40, 8, 4), device="cuda")
    u, C = torch.randn_like(a), torch.randn((1, 40, 4), device="cuda")
    dy = torch.randn((1, 40, 8), device="cuda")
    with pytest.raises(ValueError, match="checkpoints"):
        mamba_chunk_bwd(a, u, C, dy)
    ck = mamba_chunk(a, u, C, checkpoints=True)[2]
    with pytest.raises(ValueError, match="checkpoints"):
        mamba_chunk_bwd(a, u, C, dy, ck=ck[:, :2].contiguous())
    with pytest.raises(TypeError):
        mamba_chunk_bwd(a, u, C, dy, ck=ck.double())


@pytest.mark.parametrize("B,H,KH,S,Skv,causal", [
    (1, 4, 2, 40, 40, True),         # one 64-row tile, ragged
    (1, 8, 2, 129, 129, True),       # one past the 128-key CTA, G 4
    (1, 4, 4, 70, 130, False),       # non-causal, MHA, Sq != Skv
])
@pytest.mark.parametrize("D", [96, 112, 128, 160])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_kernel_at_the_wide_head_dims(card, B, H, KH, S, Skv,
                                                causal, D, dtype):
    """The head dims above 64 (gpt2-2.5b's 96, kimi-k2's 112, jamba's 128,
    pixtral-12b's 160): the bf16 route at the padded width in column
    parts, the float32 route with a row's chunks past D masked; against
    the plain backward, bitwise the same on a second call."""
    args = _bwd_inputs(B, H, KH, S, D, dtype, causal, 50, Skv)
    got = flash_attention_bwd(*args, causal=causal)
    again = flash_attention_bwd(*args, causal=causal)
    want = ref.flash_attention_bwd_ref(*args, causal=causal)
    for g, a, w in zip(got, again, want):
        _close_tight(g, w, dtype)
        assert torch.equal(g, a)


@pytest.mark.parametrize("D", [80, 256])
def test_flash_bwd_refuses_unsupported_head_dims(card, D):
    """A head dim outside the forward's set raises and names the dims the
    kernel takes; nothing falls back to the plain version."""
    args = _bwd_inputs(1, 2, 2, 8, D, torch.bfloat16, True, 51, 8)
    with pytest.raises(ValueError, match="160"):
        flash_attention_bwd(*args, causal=True)


@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-v0.1-52b",
                                  "qwen3-moe-30b-a3b", "whisper-medium",
                                  "pixtral-12b"])
def test_family_gradients_on_the_card_match_the_cpu(card, name):
    """Each family's ``.reduced()`` stack in float32 under remat "full"
    (pixtral-12b's with its own heads, 32 / 8 of 160): every gradient leaf
    on the card (the kernels and their backward kernels) within 1e-4 of
    the CPU's (the plain versions), and the recurrences' backward kernels
    launched once a layer."""
    from repro_torch.data import batch_for
    from repro_torch.train import loss_and_grads
    full = get_arch(name)
    heads = dict(head_dim=full.head_dim, num_heads=full.num_heads,
                 num_kv_heads=full.num_kv_heads) \
        if name == "pixtral-12b" else {}
    cfg = dataclasses.replace(full.reduced(), dtype="float32", remat="full",
                              **heads)
    p_cpu = _tree_f32(init_params(T.param_defs(cfg), device="cpu", seed=3))
    b = {k: torch.from_numpy(v) for k, v in batch_for(cfg, 2, 32).items()}
    ops.reset_launch_counts()
    _, _, g_gpu = loss_and_grads(cfg, _tree_to(p_cpu, "cuda"),
                                 _tree_to(b, "cuda"))
    torch.cuda.synchronize()
    kinds = cfg.layer_kinds()
    counts = ops.launch_counts()
    assert counts["rwkv_chunk_bwd"] == kinds.count("rwkv")
    assert counts["mamba_chunk_bwd"] == kinds.count("mamba")
    assert counts["rwkv_chunk"] == 2 * kinds.count("rwkv")
    assert counts["mamba_chunk"] == 2 * kinds.count("mamba")
    _, _, g_cpu = loss_and_grads(cfg, p_cpu, b)
    for a, c in zip(_leaves_of(g_gpu), _leaves_of(g_cpu)):
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-4)


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    return [tree]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _tree_f32(tree):
    if isinstance(tree, dict):
        return {k: _tree_f32(v) for k, v in tree.items()}
    return tree.float()
