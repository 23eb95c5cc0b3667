"""The bf16 route of the flash backward (``csrc/flash_attention_bwd.cu``),
emulated on the CPU.

``emulate`` repeats the route's arithmetic in plain PyTorch, in the order
and with the tiles of the kernels (``kernels/flash_attention_bwd.py``'s
``TILE`` rows a warpgroup and ``KV_CTA_TILES`` a dK/dV CTA; here
``q_cta_tiles(D)`` a dQ CTA and ``kv_parts(D)`` column parts of the dK/dV
pass):

  * every tile is ``pad_dim(D)`` wide: above D 64 the next multiple of 64,
    the columns past D zero (TMA's out-of-bounds fill); S^T = K Q^T, dP^T
    = V dO^T, S and dP run over all of it (the zero columns add nothing),
    and only D columns are stored;
  * the dK/dV pass: a CTA per (128 keys, column part, KV head, batch
    row), the first key tiles first; a part is 64 columns of dK and dV
    above D 64 (all D up to 64), so each part's CTA recomputes S^T and
    dP^T; each warpgroup's 64 keys walk the 64-row query tiles of the
    group's G heads from the causal frontier on, skip a tile that no
    (key, query) pair of it sees and mask only one that crosses the
    diagonal;
  * the dQ pass: a CTA per (192 query rows, 128 above D 64; head, batch
    row), the last row tiles first, its dQ accumulators the whole width;
    each warpgroup's 64 rows walk the 64-key tiles up to its own frontier
    and mask the diagonal's and the one that crosses Skv;
  * scores in log2 units: P = exp2(s scale log2 e - lse log2 e), a query
    row past S given a log2 lse of 1e30;
  * P and dS entering the second products as two bf16 halves (hi, and the
    bf16 rounding of what hi leaves out), the outputs rounded to bf16.

Against the reference's ``_flash_bwd`` (``repro/models/attention.py``, the
custom VJP of ``flash_attention_fused``) run in JAX on the CPU, on
bf16-valued inputs and the forward's bf16 output: within the kernel's
bf16 bound (``chip_smoke.py``'s ``TIGHT_TOL``, 1e-2 + 2e-2 |want|). At
S 1000 with G 4 (about 4,000 terms a key) the split's error is the bf16
rounding of the outputs (a quarter of the bound), while one bf16 rounding
of P and dS takes more than twice that: 0.54 of the bound at B 1, H 4 /
1 here, 0.99 at llama's B 4, H 32 / 8 (``tools/flash_bwd_rounding.py``
runs this emulation there), where the card's first route missed it.
That is why the route splits them. Every (key tile,
query tile) pair that holds a pair the mask keeps is visited exactly
once, the CTAs nearest the causal frontier (the most pairs a row or key)
first; an emulation that drops one tile pair fails the bound.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _flash_bwd, flash_attention_xla
from repro_torch.kernels.flash_attention_bwd import KV_CTA_TILES, TILE

LOG2E = 1.4426950408889634
NO_ROW = 1e30                      # the log2 lse of a query row past S
BF16_BOUND = (1e-2, 2e-2)          # (atol, rtol): chip_smoke's TIGHT_TOL
KV_CTA = TILE * KV_CTA_TILES


def _cdiv(a, b):
    return -(-a // b)


# the route's tiles at head dim D, as the source's constants set them
# (kPadD, kParts, kDqWgs in csrc/flash_attention_bwd.cu)
def pad_dim(D: int) -> int:
    """The width the bf16 route computes at: D up to 64, else the next
    multiple of 64 (the columns past D zero)."""
    return D if D <= 64 else _cdiv(D, 64) * 64


def kv_parts(D: int) -> int:
    """The dK/dV pass's column parts, one a CTA: 1 up to D 64, else one
    a 64 columns of ``pad_dim(D)``."""
    return 1 if D <= 64 else pad_dim(D) // 64


def q_cta_tiles(D: int) -> int:
    """The dQ pass's warpgroups (64 query rows each) a CTA."""
    return 3 if D <= 64 else 2


def dkdv_visits(B, H, KH, S, Skv, causal, D=64):
    """The dK/dV pass's tiles in launch order: per CTA a list of (batch
    row, KV head, head in the group, first key, first query row,
    masked, column part)."""
    G, pairs, n_qt, NP = H // KH, KH * B, _cdiv(S, TILE), kv_parts(D)
    ctas = []
    for cta in range(_cdiv(Skv, KV_CTA) * NP * pairs):
        kt, part, pair = cta // (pairs * NP), cta // pairs % NP, cta % pairs
        kh, b = pair % KH, pair // KH
        k0 = kt * KV_CTA
        qt0 = min(k0 // TILE, n_qt) if causal else 0
        per_g = n_qt - qt0
        visits = []
        for it in range(G * per_g):
            g, q0 = it // per_g, (qt0 + it % per_g) * TILE
            for wg in range(KV_CTA_TILES):
                kw = k0 + wg * TILE
                if min(TILE, Skv - kw) > 0 and (
                        not causal or min(q0 + TILE, S) - 1 >= kw):
                    visits.append((b, kh, g, kw, q0,
                                   causal and q0 < kw + TILE - 1, part))
        ctas.append(visits)
    return ctas


def dq_visits(B, H, KH, S, Skv, causal, D=64):
    """The dQ pass's tiles in launch order: per CTA a list of (batch row,
    head, first row, first key, masked)."""
    n_wg = q_cta_tiles(D)
    pairs, n_rt, n_kv = H * B, _cdiv(S, TILE * n_wg), _cdiv(Skv, TILE)
    ctas = []
    for cta in range(n_rt * pairs):
        pair = cta % pairs
        h, b = pair % H, pair // H
        r0 = (n_rt - 1 - cta // pairs) * TILE * n_wg
        visits = []
        for wg in range(n_wg):
            r0w = r0 + wg * TILE
            wg_end = n_kv if r0w < S else 0
            first_masked = n_kv - (Skv % TILE != 0)
            if causal:
                if r0w < S:
                    wg_end = min(n_kv, (min(r0w + TILE, S) - 1) // TILE + 1)
                first_masked = min(first_masked, r0w // TILE)
            visits += [(b, h, r0w, t * TILE, t >= first_masked)
                       for t in range(wg_end)]
        ctas.append(visits)
    return ctas


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _times(x, tile, split):
    """x @ tile as the route's register-A products take x: two bf16
    halves, or one bf16 rounding."""
    hi = _bf16(x)
    return hi @ tile + _bf16(x - hi) @ tile if split else hi @ tile


def _rows(t, first, n, width):
    """Rows [first, first + n) of t's second-last axis as a tile of
    ``width`` columns, zero past its rows and columns (TMA's out-of-bounds
    fill)."""
    out = torch.zeros(*t.shape[:-2], n, width)
    got = t[..., first:first + n, :]
    out[..., :got.shape[-2], :got.shape[-1]] = got
    return out


def emulate(q, k, v, o, lse, do, causal, split=True, drop=()):
    """The bf16 route's (dq, dk, dv), as f32 tensors of bf16 values; q, o,
    do (B, H, S, D), k, v (B, KH, Skv, D) f32 of bf16 values, lse (B, H,
    S) natural log. ``drop``: visits (as ``dkdv_visits`` / ``dq_visits``
    give them) to leave out."""
    B, H, S, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G, DP = H // KH, pad_dim(D)
    NO = DP // kv_parts(D)           # a dK/dV part's columns
    sl2 = LOG2E / math.sqrt(D)
    delta = (do * o).sum(-1)
    lse2 = lse * LOG2E
    pad = torch.full((B, H, TILE), NO_ROW)
    lse2_p = torch.cat([lse2, pad], -1)
    del_p = torch.cat([delta, torch.zeros(B, H, TILE)], -1)
    dk = torch.zeros(B, KH, _cdiv(Skv, TILE) * TILE, DP)
    dv = torch.zeros_like(dk)
    ar = torch.arange(TILE)
    for cta in dkdv_visits(B, H, KH, S, Skv, causal, D):
        for visit in cta:
            if visit in drop:
                continue
            b, kh, g, kw, q0, masked, part = visit
            h, cols = kh * G + g, slice(part * NO, part * NO + NO)
            kt, vt = (_rows(t[b, kh], kw, TILE, DP) for t in (k, v))
            qt, dot = (_rows(t[b, h], q0, TILE, DP) for t in (q, do))
            p = torch.exp2(kt @ qt.T * sl2 - lse2_p[b, h, q0:q0 + TILE])
            if masked:
                p = torch.where((kw + ar)[:, None] > (q0 + ar)[None, :],
                                0.0, p)
            ds = p * (vt @ dot.T - del_p[b, h, q0:q0 + TILE])
            dv[b, kh, kw:kw + TILE, cols] += _times(p, dot[:, cols], split)
            dk[b, kh, kw:kw + TILE, cols] += _times(ds, qt[:, cols], split)
    dq = torch.zeros(B, H, _cdiv(S, TILE) * TILE, DP)
    for cta in dq_visits(B, H, KH, S, Skv, causal, D):
        for visit in cta:
            if visit in drop:
                continue
            b, h, r0w, t0, masked = visit
            kh = h // G
            qt, dot = (_rows(t[b, h], r0w, TILE, DP) for t in (q, do))
            kt, vt = (_rows(t[b, kh], t0, TILE, DP) for t in (k, v))
            p = torch.exp2(qt @ kt.T * sl2
                           - lse2_p[b, h, r0w:r0w + TILE, None])
            if masked:
                key, row = (t0 + ar)[None, :], (r0w + ar)[:, None]
                p = torch.where((key >= Skv) | (causal & (key > row)), 0.0,
                                p)
            ds = p * (dot @ vt.T - del_p[b, h, r0w:r0w + TILE, None])
            dq[b, h, r0w:r0w + TILE] += _times(ds, kt, split)
    scale = 1.0 / math.sqrt(D)
    # only the D real columns are stored
    return (_bf16(dq[:, :, :S, :D] * scale), _bf16(dk[:, :, :Skv, :D] * scale),
            _bf16(dv[:, :, :Skv, :D]))


def _bf16_input(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return _bf16(torch.from_numpy(a))


@functools.lru_cache(maxsize=None)
def reference(B, H, KH, S, Skv, D, causal, seed):
    """bf16-valued inputs, the reference forward's o (rounded to bf16, as
    the card's forward writes it) and lse, and its backward in f32 (each
    compiled whole by ``jax.jit``: quicker than op by op)."""
    q, do = _bf16_input((B, H, S, D), seed), _bf16_input((B, H, S, D),
                                                           seed + 3)
    k, v = _bf16_input((B, KH, Skv, D), seed + 1), \
        _bf16_input((B, KH, Skv, D), seed + 2)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    o, lse = jax.jit(functools.partial(
        flash_attention_xla, causal=causal, chunk_q=64, chunk_kv=64,
        return_lse=True))(jq, jk, jv)
    o = _bf16(torch.from_numpy(np.array(o)))
    want = jax.jit(functools.partial(_flash_bwd, causal, 64, 64))(
        (jq, jk, jv, jnp.asarray(o.numpy()), lse), jnp.asarray(do.numpy()))
    lse = torch.from_numpy(np.array(lse)).reshape(B, H, S)
    want = [_bf16(torch.from_numpy(np.array(w))) for w in want]
    return (q, k, v, o, lse, do), want


@functools.lru_cache(maxsize=None)
def split_share(case):
    """The split route's share of the bound at a case of ``CASES``."""
    args, want = reference(*case, seed=7)
    got = emulate(*args, case[-1])
    assert all(bool(torch.isfinite(g).all()) for g in got)
    return share(got, want)


def share(got, want):
    """The largest share of the bf16 bound that an element's error takes,
    over dq, dk and dv."""
    atol, rtol = BF16_BOUND
    return max(float(((g - w).abs() / (atol + rtol * w.abs())).max())
               for g, w in zip(got, want))


# (B, H, KH, S, Skv, D, causal): llama's heads per KV head at S 1000 (the
# case that one bf16 rounding misses), a ragged S one past a CTA's 128
# keys, and the non-causal mode at Sq != Skv with ragged edges at D 16;
# the padded widths at ragged S (a dQ CTA of 128 rows): D 96 and 112 (DP
# 128, two dK/dV column parts), D 128, and D 160 (DP 192, three parts) one
# past its dQ CTA and non-causal
CASES = [(1, 4, 1, 1000, 1000, 64, True), (1, 4, 2, 129, 129, 32, True),
         (1, 4, 2, 130, 300, 16, False), (1, 4, 2, 129, 129, 96, True),
         (1, 4, 1, 70, 70, 112, True), (1, 2, 2, 200, 200, 128, True),
         (1, 4, 2, 129, 129, 160, True), (1, 2, 1, 70, 130, 160, False)]


@pytest.mark.parametrize("B,H,KH,S,Skv,D,causal", CASES)
def test_tiles_visit_every_pair_once_heaviest_first(B, H, KH, S, Skv, D,
                                                    causal):
    G = H // KH
    kv_ctas = dkdv_visits(B, H, KH, S, Skv, causal, D)
    q_ctas = dq_visits(B, H, KH, S, Skv, causal, D)
    if causal:
        # the heaviest CTAs launch first: the dK/dV pass's key tiles from
        # the first (its query rows start at the causal frontier), the dQ
        # pass's row tiles from the last (its keys end at the frontier)
        first_row = [min(v[4] for v in c) for c in kv_ctas if c]
        last_key = [max(v[3] for v in c) for c in q_ctas if c]
        assert first_row == sorted(first_row)
        assert last_key == sorted(last_key, reverse=True)
    # a (key tile, query tile) pair holds a kept (key, query) pair iff its
    # first key is below Skv and (causal) does not exceed its last row
    want = {(b, h, kt * TILE, qt * TILE)
            for b in range(B) for h in range(H)
            for kt in range(_cdiv(Skv, TILE)) for qt in range(_cdiv(S, TILE))
            if not causal or kt * TILE <= min(qt * TILE + TILE, S) - 1}
    # each dK/dV column part visits each pair once, one part a CTA
    for part in range(kv_parts(D)):
        kv = [(b, kh * G + g, kw, q0) for c in kv_ctas
              for b, kh, g, kw, q0, _, p in c if p == part]
        assert len(kv) == len(set(kv)) and set(kv) == want
    assert all(len({v[-1] for v in c}) == 1 for c in kv_ctas if c)
    dq = [(b, h, t0, r0w) for c in q_ctas for b, h, r0w, t0, _ in c]
    assert len(dq) == len(set(dq)) and set(dq) == want
    # a dQ CTA's rows: q_cta_tiles(D) tiles
    for c in q_ctas:
        assert len({v[2] // (TILE * q_cta_tiles(D)) for v in c}) <= 1
    # only tiles that cross the diagonal (or, in the dQ pass, Skv) mask
    for b, kh, g, kw, q0, masked, _ in sum(kv_ctas, []):
        assert masked == (causal and kw + TILE - 1 > q0)
    for b, h, r0w, t0, masked in sum(q_ctas, []):
        assert masked == ((causal and t0 + TILE - 1 > r0w)
                          or t0 + TILE > Skv)


@pytest.mark.parametrize("B,H,KH,S,Skv,D,causal", CASES)
def test_split_route_holds_the_bf16_bound(B, H, KH, S, Skv, D, causal):
    assert split_share((B, H, KH, S, Skv, D, causal)) <= 1.0


def test_split_against_one_rounding_and_a_dropped_tile():
    """At S 1000 with G 4 the split's error is the outputs' bf16
    rounding, one bf16 rounding of P and dS takes more than twice as much
    of the bound; at S 129, dropping one diagonal tile pair from either
    pass fails it, at D 160 too (from one dK/dV column part alone)."""
    args, want = reference(*CASES[0], seed=7)
    split = split_share(CASES[0])
    one = share(emulate(*args, CASES[0][-1], split=False), want)
    assert split <= 0.3 and one > 2 * split
    B, H, KH, S, Skv, D, causal = CASES[1]
    args, want = reference(*CASES[1], seed=7)
    kv_tile = (0, 0, 0, TILE, TILE, True, 0)
    q_tile = (0, 0, TILE, TILE, True)
    assert kv_tile in sum(dkdv_visits(B, H, KH, S, Skv, causal, D), [])
    assert q_tile in sum(dq_visits(B, H, KH, S, Skv, causal, D), [])
    for drop in (kv_tile, q_tile):
        assert share(emulate(*args, causal, drop=(drop,)), want) > 1.0
    # and at D 160 over the padded width, the dK/dV pass's tile pair from
    # its last column part alone
    B, H, KH, S, Skv, D, causal = CASES[6]
    args, want = reference(*CASES[6], seed=7)
    for drop in (kv_tile[:-1] + (2,), q_tile):
        assert share(emulate(*args, causal, drop=(drop,)), want) > 1.0
