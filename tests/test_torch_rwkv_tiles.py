"""The bf16 route of the ``rwkv_chunk`` CUDA kernel, emulated on the CPU.

``emulate`` repeats the kernel's arithmetic in plain PyTorch, with the
kernel's chunk, sub-chunk and tile sizes (``kernels/rwkv_chunk.py``):

  * P, the inclusive cumulative log2 decay of a chunk (log2 Q_i = P_{i-1});
  * the off-diagonal sub-chunk blocks of A as products of decayed r and k,
    referenced at the end of the column block (both exponents <= 0);
  * inside a diagonal block, the 4 x 4 tiles below the tile diagonal
    factored the same way at the tile's end, and the tiles on it pairwise
    with the reference's clip (at -60, in log2 units), plus the bonus;
  * every tensor-core product with each operand that is no bf16 input
    split into bf16 halves: hi keeps the top 16 bits, lo is the bf16
    rounding of what is left; hi*hi + hi*lo + lo*hi (v is exact: 2 terms).

Against the sequential oracle (``ref.rwkv_chunk_ref``) and the reference's
Pallas kernel in interpret mode, with decays over the model's whole range
(``ssm.py``: w = exp(-exp(x)), x clamped to [-10, 4], so down to about
2e-24 a step): every output finite, y and S_T within 2e-3. One TF32
rounding of the same operands misses that bound, which is why the kernel
splits them. A copy that drops one off-diagonal block fails the kernel's
bf16 bound (1e-2 + 2e-2 |want|, ``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_chunk import rwkv_chunk as pallas_rwkv_chunk
from repro_torch.kernels import ref
from repro_torch.kernels.rwkv_chunk import CHUNK, SUB, TILE

CLIP2 = -60.0 / math.log(2.0)      # the reference's clip, in log2 units
BF16_BOUND = (1e-2, 2e-2)          # (atol, rtol) of the kernel's bf16 route


def _trunc16(x):
    """x with its low 16 bits cleared: bf16 by truncation."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _tf32(x):
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _trunc16(x)
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm(a, b, precision, b_exact=False):
    """a @ b as the kernel's tensor cores take it."""
    if precision == "tf32":
        return _tf32(a) @ _tf32(b)
    ah, al = _split(a)
    if b_exact:
        return al @ b + ah @ b
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _diag_block(r, k, P, Pm, u, i0):
    """The 16 x 16 diagonal block at row i0 of one chunk, on the CUDA
    cores in f32: (BH, SUB, SUB)."""
    BH = r.shape[0]
    out = torch.zeros(BH, SUB, SUB)
    for ta in range(SUB // TILE):
        a0 = i0 + TILE * ta
        for tb in range(ta):
            b0 = i0 + TILE * tb
            R = P[:, b0 + TILE - 1:b0 + TILE]
            rt = r[:, a0:a0 + TILE] * torch.exp2(Pm[:, a0:a0 + TILE] - R)
            kt = k[:, b0:b0 + TILE] * torch.exp2(R - P[:, b0:b0 + TILE])
            out[:, TILE * ta:TILE * ta + TILE, TILE * tb:TILE * tb + TILE] = \
                rt @ kt.transpose(1, 2)
        for a in range(TILE):
            i = a0 + a
            out[:, i - i0, i - i0] = (r[:, i] * u * k[:, i]).sum(-1)
            for b in range(a):
                j = a0 + b
                ratio = 1.0 if a - b == 1 else torch.exp2(torch.clamp(
                    Pm[:, i] - P[:, j], CLIP2, 0.0))
                out[:, i - i0, j - i0] = (r[:, i] * k[:, j] * ratio).sum(-1)
    return out


def emulate(r, k, v, w, u, precision="split", drop=None):
    """The bf16 route on (BH, T, K) inputs (r, k, v exact in bf16, w and u
    f32; u (BH, K)) -> (y f32, S_T f32). ``drop``: an off-diagonal block
    (I, J) left out, as a broken kernel would."""
    BH, T, K = r.shape
    n = -(-T // CHUNK) * CHUNK
    pad = lambda a, fill: torch.cat(
        [a.float(), torch.full((BH, n - T, K), fill)], 1)
    r, k, v, w = pad(r, 0.0), pad(k, 0.0), pad(v, 0.0), pad(w, 1.0)
    S = torch.zeros(BH, K, K)
    ys = []
    for t0 in range(0, n, CHUNK):
        rc, kc, vc = (a[:, t0:t0 + CHUNK] for a in (r, k, v))
        P = torch.cumsum(torch.log2(torch.clamp(w[:, t0:t0 + CHUNK],
                                                min=1e-38)), 1)
        Pm = torch.cat([torch.zeros(BH, 1, K), P[:, :-1]], 1)
        A = torch.zeros(BH, CHUNK, CHUNK)
        for I in range(CHUNK // SUB):
            s = slice(SUB * I, SUB * I + SUB)
            A[:, s, s] = _diag_block(rc, kc, P, Pm, u, SUB * I)
            for J in range(I):
                if drop == (I, J):
                    continue
                sj = slice(SUB * J, SUB * J + SUB)
                LJ = P[:, SUB * J + SUB - 1:SUB * J + SUB]
                rj = rc[:, s] * torch.exp2(Pm[:, s] - LJ)
                kj = kc[:, sj] * torch.exp2(LJ - P[:, sj])
                A[:, s, sj] = _mm(rj, kj.transpose(1, 2), precision)
        rq = rc * torch.exp2(Pm)
        y = _mm(rq, S, precision) + _mm(A, vc, precision, b_exact=True)
        L = P[:, -1:]
        kd = kc * torch.exp2(L - P)
        S = torch.exp2(L).transpose(1, 2) * S \
            + _mm(kd.transpose(1, 2), vc, precision, b_exact=True)
        ys.append(y)
    return torch.cat(ys, 1)[:, :T], S


def _inputs(BH, T, K, seed, decay):
    """r, k, v rounded to bf16 (as the model's call gives them), u; decays
    exp(-exp(x)) with x over ssm.py's clamp [-10, 4] ("model") or
    test_kernels.py's (0.45, 0.95) ("mild")."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((BH, T, K)) * 0.5)
               .float().to(torch.bfloat16).float() for _ in range(3))
    if decay == "model":
        x = rng.uniform(-10.0, 4.0, (BH, T, K))
        w = np.exp(-np.exp(x))
    else:
        w = 1 / (1 + np.exp(-rng.standard_normal((BH, T, K)))) * 0.5 + 0.45
    u = rng.standard_normal((BH, K)) * 0.1
    return r, k, v, torch.from_numpy(w).float(), torch.from_numpy(u).float()


def _share(got, want, atol, rtol):
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


@pytest.mark.parametrize("BH,T,K,decay", [
    (3, 192, 64, "model"),     # the model's decays, three whole chunks
    (2, 128, 64, "mild"),
    (2, 150, 64, "model"),     # a ragged last chunk
    (3, 37, 16, "model"),      # one ragged chunk, a narrow head
])
def test_emulated_bf16_route_matches_the_oracle(BH, T, K, decay):
    r, k, v, w, u = _inputs(BH, T, K, 31, decay)
    y, s = emulate(r, k, v, w, u)
    want_y, want_s = ref.rwkv_chunk_ref(r, k, v, w, u, out_dtype=torch.float32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    assert float(w.min()) < 1e-20 or decay == "mild"
    torch.testing.assert_close(y, want_y, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(s, want_s, atol=2e-3, rtol=2e-3)
    if T % CHUNK == 0:         # the Pallas kernel takes whole chunks only
        pal_y, pal_s = pallas_rwkv_chunk(
            *(jnp.asarray(a.numpy()) for a in (r, k, v, w, u)),
            chunk=CHUNK, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(pal_y), atol=2e-3,
                                   rtol=2e-3)
        np.testing.assert_allclose(s.numpy(), np.asarray(pal_s), atol=2e-3,
                                   rtol=2e-3)


def test_one_tf32_rounding_misses_the_bound():
    """The reason for the split: the same products with each operand
    rounded once to TF32 miss 2e-3 at the model's decays (on 131k outputs;
    the split uses under a tenth of the bound)."""
    r, k, v, w, u = _inputs(8, 256, 64, 31, "model")
    want_y, _ = ref.rwkv_chunk_ref(r, k, v, w, u, out_dtype=torch.float32)
    split_y, _ = emulate(r, k, v, w, u)
    tf32_y, _ = emulate(r, k, v, w, u, precision="tf32")
    assert _share(split_y, want_y, 2e-3, 2e-3) < 0.1
    assert _share(tf32_y, want_y, 2e-3, 2e-3) > 1.0


@pytest.mark.parametrize("block", [(1, 0), (2, 1), (3, 2)])
def test_dropping_an_off_diagonal_block_fails_the_bf16_bound(block):
    """Each block next to the diagonal (a farther one holds decays over 17
    steps or more, which the model's strong decays can make negligible)."""
    r, k, v, w, u = _inputs(3, 192, 64, 31, "model")
    want_y, _ = ref.rwkv_chunk_ref(r, k, v, w, u, out_dtype=torch.float32)
    y, _ = emulate(r, k, v, w, u, drop=block)
    assert _share(y, want_y, *BF16_BOUND) > 1.0
