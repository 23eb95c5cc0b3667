"""The decode-path kernels' plans, on the CPU: how ``pim_matvec`` cuts a
GEMV across CTAs and how ``decode_attention`` splits each row's keys, and
the split-and-combine arithmetic of flash-decoding, emulated in float32
with torch and held to the plain version. The kernels themselves run only
on the card (``tests/test_torch_kernels_cuda.py``); these are the Python
halves they are launched with."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import pim_matvec as PM

# (d_in, d_out) of every decode FC the serves run through pim_matvec
SERVED_GEMV = {
    "llama3.2-1b": [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)],
    "rwkv6-7b": [(4096, 4096), (4096, 14336), (14336, 4096)],
    "jamba-v0.1-52b": [(4096, 8192), (8192, 4096), (4096, 4096),
                       (4096, 1024), (4096, 14336), (14336, 4096)],
}
SHAPES = sorted({s for v in SERVED_GEMV.values() for s in v})
SMS = 132


def _slices(p, d_in):
    return [(s * p.slice, min(d_in, (s + 1) * p.slice))
            for s in range(p.splits)]


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_matvec_plan_fills_the_card_at_served_shapes(d_in, d_out, n):
    """Every served shape launches at least one CTA per SM, in clusters of
    at most 8, with slices of whole 16-row k-steps and whole tiles."""
    p = PM.plan(n, d_in, d_out, torch.bfloat16)
    assert p.ctas == -(-d_out // p.bn) * p.splits >= SMS
    assert 1 <= p.splits <= PM.MAX_SPLITS
    assert p.slice % 16 == 0 and p.slice % p.tile_rows == 0
    assert p.tile_rows % 16 == 0
    assert p.tile_rows * p.bn * 2 == PM.TILE_BYTES
    # the slice of x a CTA holds fits its budget
    assert PM.ROWS_PER_LAUNCH * p.slice * 2 <= PM.X_SLICE_BYTES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d_in,d_out", SHAPES + [
    (1, 1), (100, 37), (130, 64), (1000, 1000), (520, 1032), (4096, 4104),
    (16, 128256), (29, 3)])
def test_matvec_plan_covers_d_in_and_d_out_once(d_in, d_out, dtype):
    """The slices of d_in are disjoint, none empty, and cover [0, d_in);
    the column tiles cover [0, d_out) with none wholly past it -- the
    conditions under which the C entry accepts the plan."""
    p = PM.plan(8, d_in, d_out, dtype)
    covered = np.zeros(d_in, np.int32)
    for lo, hi in _slices(p, d_in):
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert p.slice * p.splits >= d_in > p.slice * (p.splits - 1)
    cols = -(-d_out // p.bn)
    assert cols * p.bn >= d_out > (cols - 1) * p.bn
    assert p.bn in ((16, 32, 64, 128) if dtype == torch.bfloat16
                    else (16, 32, 64))


def test_matvec_plan_asks_the_same_shape_once():
    """The plan is cached: the decode step's wrappers pay a lookup."""
    assert PM.plan(8, 2048, 8192, torch.bfloat16) \
        is PM.plan(8, 2048, 8192, torch.bfloat16)


@pytest.mark.parametrize("B,H,KH,S", [(8, 32, 8, 1024), (8, 32, 8, 256),
                                       (3, 32, 8, 300), (1, 48, 1, 2048),
                                       (2, 8, 8, 64)])
def test_decode_plan_fills_the_card(B, H, KH, S):
    """llama's and jamba's B 8 x KH 8 launch at least 132 CTAs; no plan
    has more splits than the cache has tiles, or more than 8."""
    splits = DA.plan(B, H, KH, S)
    groups = -(-(H // KH) // DA.HEAD_GROUP)
    assert 1 <= splits <= min(DA.MAX_SPLITS, -(-S // DA.TILE))
    if (B, KH) == (8, 8):
        assert B * KH * groups * splits >= SMS


@pytest.mark.parametrize("S", [256, 1024])
def test_decode_shares_cover_each_length_once(S):
    """For every length 1..S and every split count, the CTAs' shares are
    disjoint tile-aligned ranges that cover [0, length) exactly once."""
    for splits in range(1, DA.MAX_SPLITS + 1):
        for length in range(1, S + 1):
            shares = [DA.share(length, s, splits) for s in range(splits)]
            assert shares[0][0] == 0 and shares[-1][1] == length
            for (lo, hi), (lo2, _) in zip(shares, shares[1:]):
                assert lo <= hi == lo2
            for lo, hi in shares:
                assert lo % DA.TILE == 0 or lo == length


def _split_combine(q, k, v, lengths, splits):
    """Flash-decoding's arithmetic in f32, as the kernel does it: each of
    ``splits`` CTAs takes its share of a row's keys and keeps (m, l, acc)
    -- the neutral (-inf, 0, 0) when the share is empty -- and the shares
    merge as sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)."""
    B, H, D = q.shape
    KH = k.shape[1]
    G = H // KH
    qg = q.float().reshape(B, KH, G, D) / math.sqrt(D)
    out = torch.empty(B, KH, G, D)
    for b in range(B):
        ms, ls, accs = [], [], []
        for s in range(splits):
            lo, hi = DA.share(int(lengths[b]), s, splits)
            if lo == hi:
                ms.append(torch.full((KH, G), -math.inf))
                ls.append(torch.zeros(KH, G))
                accs.append(torch.zeros(KH, G, D))
                continue
            sc = torch.einsum("kgd,kcd->kgc", qg[b], k[b, :, lo:hi].float())
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("kgc,kcd->kgd", p,
                                     v[b, :, lo:hi].float()))
        M = torch.stack(ms).amax(0)
        w = [torch.where(m == -math.inf, torch.zeros_like(m),
                         torch.exp(m - M)) for m in ms]
        num = sum(wi[..., None] * a for wi, a in zip(w, accs))
        den = sum(wi * li for wi, li in zip(w, ls))
        out[b] = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, H, D)


@pytest.mark.parametrize("splits", [1, 3, 4, 8])
@pytest.mark.parametrize("B,H,KH,S,D,lens", [
    (3, 8, 2, 300, 16, (1, 299, 130)),          # len 1: one split holds it
    (4, 4, 4, 256, 32, (64, 65, 128, 256)),     # on and past tile edges
    (2, 16, 2, 200, 64, (200, 5)),              # S off the tile
])
def test_decode_split_combine_matches_plain(B, H, KH, S, D, lens, splits):
    """The split-and-combine emulation equals the plain version within
    1e-5, empty shares included."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, D), (B, KH, S, D), (B, KH, S, D)))
    lengths = torch.tensor(lens, dtype=torch.int32)
    if splits > 1:
        assert any(DA.share(n, splits - 1, splits)[0] == n for n in lens)
    got = _split_combine(q, k, v, lengths, splits)
    want = ref.decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
