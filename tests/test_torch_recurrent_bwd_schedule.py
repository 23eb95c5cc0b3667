"""The schedules of the recurrences' backward CUDA kernels, emulated on
the CPU.

``emulate_rwkv_bwd`` repeats ``csrc/rwkv_chunk_bwd.cu``'s order of work in
plain PyTorch, at the kernel's 64-wide state (narrower K runs zero
channels): the forward writes S before every ``CK`` = 32 steps; each
stretch's level-2 walk keeps S before each sub-chunk of ``SUB`` = 8; each
sub-chunk walks S forward into a history and G back over it. Its sums
keep the kernel's order: over a thread's 4 columns (or rows) in
sequence, over a tile's 4 column groups (or 8 row groups) as a pairwise
tree, over the 4 tiles (or 2) in sequence, then the u terms.

``emulate_mamba_bwd`` repeats ``csrc/mamba_chunk_bwd.cu``'s one reverse
walk from the checkpoints that the forward kernel writes every 16 steps
(``ref.mamba_checkpoints_ref``), at T off the 16-step grid: each stretch
recomputed from its checkpoint, g run down it, dC summed over a warp's
channels as a pairwise tree, over a block's 8 warps and then over the
blocks in sequence.

Both are held against the plain versions (``ref.rwkv_chunk_bwd_ref``,
``ref.mamba_chunk_bwd_ref``) and against ``jax.vjp`` of the reference's
``_wkv_scan`` and ``chunked_linear_scan``, within ``tests/test_kernels.py``'s
float32 tolerance (1e-4), the wkv at decays down to exp(-e^4) ~ 2e-24.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import _wkv_scan, chunked_linear_scan
from repro_torch.kernels import ref
from repro_torch.kernels.mamba_chunk import CK as MAMBA_CK
from repro_torch.kernels.mamba_chunk_bwd import THREADS as MAMBA_THREADS
from repro_torch.kernels.mamba_chunk_bwd import mamba_chunk_bwd
from repro_torch.kernels.rwkv_chunk_bwd import CK, MAX_K, SUB

TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py's float32 _tol


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(xs):
    """x_0 + x_1 + ... in order."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _tree(xs):
    """The pairwise sum that a butterfly of lane shuffles takes."""
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] for i in range(0, len(xs), 2)]
    return xs[0]


def _over_cols(p):
    """(BH, 64, 64) products summed over j as the kernel sums them: a
    thread's 4 columns in order, a tile's 4 column groups as a tree, the
    4 tiles in order."""
    q = p.reshape(p.shape[0], MAX_K, 4, 4, 4)         # rows, tile, group, col
    thread = _seq([q[..., b] for b in range(4)])
    tile = _tree([thread[..., g] for g in range(4)])
    return _seq([tile[..., t] for t in range(4)])


def _over_rows(p):
    """(BH, 64, 64) products summed over i: a thread's 4 rows in order, a
    tile's 8 row groups as a tree, the 2 tiles in order."""
    q = p.reshape(p.shape[0], 2, 8, 4, MAX_K)         # tile, group, row, cols
    thread = _seq([q[:, :, :, a] for a in range(4)])
    tile = _tree([thread[:, :, g] for g in range(8)])
    return _seq([tile[:, t] for t in range(2)])


def emulate_rwkv_bwd(r, k, v, w, u, dy, ds=None):
    """The wkv's gradient in the kernel's schedule and order of sums. Same
    arguments and results as ``ref.rwkv_chunk_bwd_ref`` (f32 inputs)."""
    BH, T, K = r.shape
    U = u.shape[0]
    nsub = -(-T // SUB)
    Tp = nsub * SUB

    def pad(x, fill=0.0):
        out = torch.full((BH, Tp, MAX_K), fill)
        out[:, :T, :K] = x.float()
        out[:, :T, K:] = 0.0
        return out

    rf, kf, vf, yf = (pad(x) for x in (r, k, v, dy))
    wf = pad(w, fill=1.0)                 # padded steps decay by 1
    uf = torch.zeros(BH, MAX_K)
    uf[:, :K] = u.float().repeat(BH // U, 1)

    def step(S, t):
        return wf[:, t, :, None] * S + kf[:, t, :, None] * vf[:, t, None, :]

    # forward: S before every CK steps
    S = torch.zeros(BH, MAX_K, MAX_K)
    ck = []
    for t in range(Tp):
        if t % CK == 0:
            ck.append(S)
        S = step(S, t)
    G = torch.zeros(BH, MAX_K, MAX_K)
    if ds is not None:
        G[:, :K, :K] = ds.float()
    out = [torch.zeros(BH, Tp, MAX_K) for _ in range(4)]
    vdy = (vf * yf).sum(-1)
    ruk = (rf * uf[:, None] * kf).sum(-1)
    for c in reversed(range(len(ck))):
        Q = min(CK // SUB, nsub - c * CK // SUB)
        slots, S = [ck[c]], ck[c]
        for q in range(Q - 1):            # the level-2 walk
            for t in range(c * CK + q * SUB, c * CK + (q + 1) * SUB):
                S = step(S, t)
            slots.append(S)
        for q in reversed(range(Q)):
            t0 = c * CK + q * SUB
            S, hist = slots[q], []
            for t in range(t0, t0 + SUB):
                hist.append(S)
                S = step(S, t)
            for s in reversed(range(SUB)):
                t = t0 + s
                out[0][:, t] = _over_cols(hist[s] * yf[:, t, None, :])
                out[1][:, t] = _over_cols(G * vf[:, t, None, :])
                out[2][:, t] = _over_cols(G * hist[s])
                out[3][:, t] = _over_rows(G * kf[:, t, :, None])
                G = wf[:, t, :, None] * G \
                    + rf[:, t, :, None] * yf[:, t, None, :]
    dr = out[0] + uf[:, None] * (kf * vdy[..., None])
    dk = out[1] + uf[:, None] * rf * vdy[..., None]
    dw = out[2]
    dv = out[3] + yf * ruk[..., None]
    du = (rf * (kf * vdy[..., None])).sum(1).reshape(BH // U, U, MAX_K).sum(0)
    return (dr[:, :T, :K], dk[:, :T, :K], dv[:, :T, :K], dw[:, :T, :K],
            du[:, :K])


def _decays(rng, shape, kind):
    """The model's decays exp(-exp(x)), x in ssm.py's clamp [-10, 4]."""
    lo, hi = {"strong": (2.0, 4.0), "mixed": (-10.0, 4.0)}[kind]
    return np.exp(-np.exp(rng.uniform(lo, hi, shape))).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_wkv_grads(B, H, r, k, v, w, u, dy, ds):
    """jax.vjp of the reference's _wkv_scan (s0 = 0, one chunk)."""
    BH, T, K = r.shape

    def fwd(r, k, v, w, u):
        shape = (B, H, T, K)
        return _wkv_scan(r.reshape(shape), k.reshape(shape),
                         v.reshape(shape), w.reshape(shape), u,
                         jnp.zeros((B, H, K, K), jnp.float32), T)
    _, vjp = jax.vjp(fwd, r, k, v, w, u)
    grads = vjp((dy.reshape(B, H, T, K), ds.reshape(B, H, K, K)))
    return [g.reshape(BH, T, K) for g in grads[:4]] + [grads[4]]


# (B, H, T, K, decays, dS_T): stretches whose last one has 1, 2 or 3
# sub-chunks, a ragged last sub-chunk, K below the kernel's 64
RWKV_CASES = [(1, 2, 37, 64, "strong", True), (2, 1, 48, 64, "mixed", False),
              (1, 2, 81, 16, "mixed", True)]


@pytest.mark.parametrize("B,H,T,K,kind,final", RWKV_CASES)
def test_rwkv_bwd_schedule_matches_plain_and_jax(B, H, T, K, kind, final):
    rng = np.random.default_rng(T + K)
    BH = B * H
    r, k, v, dy = (rng.normal(0, 0.5, (BH, T, K)).astype(np.float32)
                   for _ in range(4))
    w = _decays(rng, (BH, T, K), kind)
    u = rng.normal(0, 0.3, (H, K)).astype(np.float32)
    ds = rng.normal(0, 0.5, (BH, K, K)).astype(np.float32) if final else None
    args = [None if a is None else torch.from_numpy(a)
            for a in (r, k, v, w, u, dy, ds)]
    got = emulate_rwkv_bwd(*args)
    plain = ref.rwkv_chunk_bwd_ref(*args)
    want = _jax_wkv_grads(B, H, r, k, v, w, u, dy,
                          np.zeros((BH, K, K), np.float32) if ds is None
                          else ds)
    for name, g, p, j in zip(("dr", "dk", "dv", "dw", "du"), got, plain,
                             want):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


def emulate_mamba_bwd(a, u, C, dy, dh, ck):
    """The Mamba scan's gradient walked once in reverse from the forward's
    checkpoints ck (h before every 16 steps), dC summed in the kernel's
    order. Same results as ``ref.mamba_chunk_bwd_ref`` (f32)."""
    B, T, d, n = a.shape
    G = 1 << (n - 1).bit_length()            # lanes a channel
    per_warp, warps = 32 // G, MAMBA_THREADS // 32
    per_block = per_warp * warps
    blocks = -(-d * G // MAMBA_THREADS)
    af, uf, Cf, yf = (x.float() for x in (a, u, C, dy))
    g = torch.zeros(B, d, n) if dh is None else dh.float().clone()
    a_next = torch.ones(B, d, n)
    da, du = torch.zeros(B, T, d, n), torch.zeros(B, T, d, n)
    dC = torch.zeros(B, T, n)
    for c in reversed(range(ck.shape[1])):
        t0 = c * MAMBA_CK
        steps = range(t0, min(t0 + MAMBA_CK, T))
        hist = [ck[:, c]]
        for t in steps:
            hist.append(af[:, t] * hist[-1] + uf[:, t])
        for i, t in enumerate(steps):
            p = torch.zeros(B, blocks * per_block, n)
            p[:, :d] = hist[i + 1] * yf[:, t, :, None]
            p = p.reshape(B, blocks, warps, per_warp, n)
            warp = _tree([p[:, :, :, m] for m in range(per_warp)])
            block = _seq([torch.zeros(B, blocks, n)]
                         + [warp[:, :, m] for m in range(warps)])
            dC[:, t] = _seq([torch.zeros(B, n)]
                            + [block[:, m] for m in range(blocks)])
        for i, t in reversed(list(enumerate(steps))):
            g = Cf[:, t, None, :] * yf[:, t, :, None] + a_next * g
            da[:, t] = g * hist[i]
            du[:, t] = g
            a_next = af[:, t]
    return da, du, dC


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_scan_grads(a, u, C, dy, dh, chunk):
    """jax.vjp of mamba_mix's scan: chunked_linear_scan, then y = h C."""
    def fwd(a, u, C):
        h_all, h_fin = chunked_linear_scan(
            jnp.moveaxis(a, 1, 0), jnp.moveaxis(u, 1, 0),
            jnp.zeros(a.shape[:1] + a.shape[2:], jnp.float32), chunk)
        y = jnp.einsum("tbdn,tbn->tbd", h_all, jnp.moveaxis(C, 1, 0))
        return jnp.moveaxis(y, 0, 1), h_fin
    _, vjp = jax.vjp(fwd, a, u, C)
    return vjp((dy, dh))


# (B, T, d, n, chunk of the reference's scan, dh_T): T off the 16-step
# grid, blocks of 16 channels (n 16) and of 32 (n 5 in groups of 8)
MAMBA_CASES = [(1, 37, 24, 16, 37, True), (1, 50, 70, 5, 25, False)]


@pytest.mark.parametrize("B,T,d,n,chunk,final", MAMBA_CASES)
def test_mamba_bwd_schedule_matches_plain_and_jax(B, T, d, n, chunk, final):
    rng = np.random.default_rng(T + d)
    dt = np.log1p(np.exp(rng.normal(-2, 1, (B, T, d))))       # softplus
    A = 1.0 / rng.uniform(1e-3, 1.0, (d, n))
    a = np.exp(dt[..., None] * -A).astype(np.float32)
    u = (rng.normal(0, 1, (B, T, d, n)) * 0.3).astype(np.float32)
    C = rng.normal(0, 1, (B, T, n)).astype(np.float32)
    dy = rng.normal(0, 1, (B, T, d)).astype(np.float32)
    dh = rng.normal(0, 1, (B, d, n)).astype(np.float32) if final else None
    at, ut, Ct, yt = (torch.from_numpy(x) for x in (a, u, C, dy))
    dht = None if dh is None else torch.from_numpy(dh)
    ck = ref.mamba_checkpoints_ref(at, ut, MAMBA_CK)
    assert ck.shape == (B, -(-T // MAMBA_CK), d, n)
    for c in range(ck.shape[1]):             # h before step 16 c
        _, h = ref.mamba_chunk_ref(at[:, :c * MAMBA_CK], ut[:, :c * MAMBA_CK],
                                   Ct[:, :c * MAMBA_CK]) if c else \
            (None, torch.zeros(B, d, n))
        torch.testing.assert_close(ck[:, c], h, rtol=0, atol=0)
    got = emulate_mamba_bwd(at, ut, Ct, yt, dht, ck)
    plain = ref.mamba_chunk_bwd_ref(at, ut, Ct, yt, dht)
    want = _jax_scan_grads(a, u, C, dy, np.zeros((B, d, n), np.float32)
                           if dh is None else dh, chunk)
    for name, g, p, j in zip(("da", "du", "dC"), got, plain, want):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


def test_mamba_bwd_kernel_wants_the_forward_checkpoints():
    """The kernel's wrapper takes the checkpoints its forward wrote, or
    raises; it never recomputes them (checked before the device)."""
    a = torch.rand(1, 20, 4, 2)
    with pytest.raises(ValueError, match="checkpoints"):
        mamba_chunk_bwd(a, a, a[:, :, 0], a[..., 0])
