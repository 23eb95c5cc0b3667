// rwkv_chunk: the RWKV6 wkv from a zero state, in chunked linear-attention
// form.
//
// Replaces the TPU kernel repro/kernels/rwkv_chunk.py::rwkv_chunk (_kernel).
// Per chunk of C = 64 steps, with Q_i the exclusive cumulative decay:
//
//   y_i = (r_i * Q_i) S0 + sum_{j<i} A_ij v_j + b_i v_i
//   A_ij = sum_c r_ic k_jc exp(clip(log Q_ic - log Q_{j+1,c}, -60, 0))
//   b_i  = (r_i * u) . k_i
//   S_C  = diag(Q_C) S0 + (k * exp(clip(log Q_C - log Q_{j+1}, -60, 0)))^T v
//
// Two routes, picked by the input dtype in rwkv_chunk_launch; both are
// one block per (b, h) row that walks its chunks in order (the TPU grid's
// sequential chunk axis becomes a loop inside the block), the K x K f32
// state in shared memory across chunks, and the ragged last chunk masked
// in the kernel (rows past T load r = k = v = 0 and log w = 0, so they add
// nothing to y or the state).
//
// bf16 inputs (the model's call: rwkv6-7b's full-sequence prefill, BH 128,
// T 2048, K 64, y in f32) run rwkv_chunk_tc_kernel. What bounds the
// function on an H100 is bytes: r, k, v in bf16, w and y in f32 and S_T,
// 237 MB, 0.071 ms at 3.35 TB/s (its exps, counted for the sub-chunked
// form below, take 0.051 ms on the SFUs). The first kernel spent one
// accurate expf per (i, j<i, c), 129k a chunk, with half of each warp idle
// on the triangle and every product an f32 FMA: 2.5 ms. The design:
//  * sub-chunked decays (GLA; flash-linear-attention's chunk_rwkv6): the
//    chunk splits into 4 sub-chunks of 16. For i in sub-chunk I and j in
//    an earlier J, the decay ratio is 2^(P_{i-1} - L_J) * 2^(L_J - P_j),
//    with P the inclusive cumulative log2 decay and L_J its value at the
//    end of J: both exponents are <= 0, so neither factor overflows at any
//    decay, and the 6 off-diagonal 16 x 16 blocks of A are products of
//    decayed r and k. Inside the 4 diagonal blocks the same holds one
//    level down: a 4 x 4 tile below the tile diagonal is a product with
//    the reference at the end of its column tile. Only the 16 tiles on
//    the diagonal keep the pairwise form with its clip (in log2 units; a
//    ratio of neighbours is 1). About 31k exps a chunk (ex2.approx) and 4k
//    logs (a series near 1, lg2.approx elsewhere), against 129k;
//  * the diagonal blocks on the CUDA cores in 4 x 4 register tiles, each
//    over a slice of the channels (no idle lane on the triangle), summed
//    over the slices by a butterfly of shuffles;
//  * every other product on the tensor cores (mma.sync m16n8k16, f32
//    accumulators): the off-diagonal blocks, A v, (r Q) S0 and the state
//    advance. An operand that is no bf16 input (decayed r and k, A, the
//    state) is stored split in two bf16 halves (hi its top 16 bits, lo the
//    rounding of the rest) and the product taken as hi*hi + hi*lo + lo*hi
//    (v, a bf16 input, is exact: 2 products); fragments by ldmatrix.
//    tests/test_torch_rwkv_tiles.py emulates this arithmetic: one TF32
//    rounding of the decayed operands misses the 2e-3 bound of y in f32,
//    the split meets it with a wide margin;
//  * r, k, v, w of chunk c + 1 stream in by TMA (r, k, v in the 128-byte
//    swizzle, rows past T read as zeros) into a second stage while chunk
//    c computes;
//  * no atomics: each sum is taken in a fixed order, so two calls give
//    the same bits.
// Any K <= 64 runs with zero channels up to 64 (and element loads where
// K != 64 or an input is not 16-byte aligned). What holds it at about 3x
// its bound (PERF.md): each chunk is 7 phases
// between block barriers, latency-bound at the 8 warps an SM that one
// block per (b, h) gives (128 blocks for 132 SMs), and the products are
// about 100 mma.sync a warp.
//
// f32 inputs (the float32 parity paths, held to 1e-4 at the logits) keep
// rwkv_chunk_kernel below on the CUDA cores: products in f32 and the
// accurate expf, which TF32 or bf16 tensor-core products would not meet.
// Its tiles sit in shared memory as f32, rows padded to K + 1 floats; its
// threads own a column (j, or the value channel) and every fourth row.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;                      // chunk length
constexpr int kMaxK = 64;                   // head size limit
constexpr int kLd = kMaxK + 1;              // padded row stride of the tiles
constexpr int kRowStep = kThreads / kC;     // rows per thread stride
static_assert(kC == kMaxK, "a thread's column indexes both j and channels");

struct Smem {
  float r[kC][kLd];       // r, then r * Q_i
  float k[kC][kLd];       // k, then k * Q_C / Q_{j+1}
  float v[kC][kLd];
  float lq[kC][kLd];      // log Q_i (exclusive cumulative log decay)
  float lqn[kC][kLd];     // log w, then log Q_{i+1}
  float att[kC][kC + 1];  // intra-chunk attention, lower triangle + bonus
  float s[kMaxK][kMaxK];  // the state, k-major
  float lqt[kMaxK];       // log Q_C
  float u[kMaxK];
};

__device__ __forceinline__ float clip_ratio(float d) {
  return fminf(fmaxf(d, -60.f), 0.f);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
rwkv_chunk_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                  const Tin* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, Tout* __restrict__ y,
                  float* __restrict__ s_out, int T, int K, int u_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int col = tid % kC;                 // j, or a value channel
  const int row0 = tid / kC;
  const size_t base = static_cast<size_t>(bh) * T * K;

  for (int e = tid; e < K * K; e += kThreads) sm.s[e / K][e % K] = 0.f;
  if (tid < K) sm.u[tid] = u[static_cast<size_t>(bh % u_rows) * K + tid];

  for (int t0 = 0; t0 < T; t0 += kC) {
    const int n = min(kC, T - t0);          // valid rows of this chunk
    __syncthreads();                        // the last chunk's reads are done
    for (int e = tid; e < kC * K; e += kThreads) {
      const int i = e / K, c = e % K;
      const bool ok = i < n;
      const size_t g = base + static_cast<size_t>(t0 + i) * K + c;
      sm.r[i][c] = ok ? rt_to_f32(r[g]) : 0.f;
      sm.k[i][c] = ok ? rt_to_f32(k[g]) : 0.f;
      sm.v[i][c] = ok ? rt_to_f32(v[g]) : 0.f;
      sm.lqn[i][c] = ok ? logf(fmaxf(w[g], 1e-38f)) : 0.f;
    }
    __syncthreads();
    if (tid < K) {                          // one channel per thread
      float acc = 0.f;
      for (int i = 0; i < kC; ++i) {
        sm.lq[i][tid] = acc;
        acc += sm.lqn[i][tid];
        sm.lqn[i][tid] = acc;
      }
      sm.lqt[tid] = acc;
    }
    __syncthreads();
    {                                       // att[i][j], j = this column
      const int j = col;
      for (int i = row0; i < kC; i += kRowStep) {
        float a = 0.f;
        if (j < i) {
          for (int c = 0; c < K; ++c)
            a = fmaf(sm.r[i][c] * sm.k[j][c],
                     expf(clip_ratio(sm.lq[i][c] - sm.lqn[j][c])), a);
        } else if (j == i) {
          for (int c = 0; c < K; ++c)
            a = fmaf(sm.r[i][c] * sm.u[c], sm.k[i][c], a);
        }
        sm.att[i][j] = a;
      }
    }
    __syncthreads();
    for (int e = tid; e < kC * K; e += kThreads) {
      const int i = e / K, c = e % K;
      sm.r[i][c] *= expf(sm.lq[i][c]);
      sm.k[i][c] *= expf(clip_ratio(sm.lqt[c] - sm.lqn[i][c]));
    }
    __syncthreads();
    const int vv = col;
    if (vv < K) {                           // y = (r Q) S0 + att v
      for (int i = row0; i < n; i += kRowStep) {
        float acc = 0.f;
        for (int c = 0; c < K; ++c) acc = fmaf(sm.r[i][c], sm.s[c][vv], acc);
        for (int j = 0; j <= i; ++j) acc = fmaf(sm.att[i][j], sm.v[j][vv], acc);
        y[base + static_cast<size_t>(t0 + i) * K + vv] = rt_from_f32<Tout>(acc);
      }
    }
    __syncthreads();
    if (vv < K) {                           // S = diag(Q_C) S0 + kd^T v
      for (int c = row0; c < K; c += kRowStep) {
        float acc = expf(sm.lqt[c]) * sm.s[c][vv];
        for (int j = 0; j < n; ++j) acc = fmaf(sm.k[j][c], sm.v[j][vv], acc);
        sm.s[c][vv] = acc;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < K * K; e += kThreads)
    s_out[static_cast<size_t>(bh) * K * K + e] = sm.s[e / K][e % K];
}

template <typename Tin, typename Tout>
cudaError_t launch_typed(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* y, void* s_out,
                         int BH, int T, int K, int u_rows,
                         cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_chunk_kernel<Tin, Tout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  rwkv_chunk_kernel<Tin, Tout><<<BH, kThreads, smem, stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<Tout*>(y),
      static_cast<float*>(s_out), T, K, u_rows);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 route: sub-chunked decays, products on the tensor cores.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 256;
constexpr int kC = 64;                      // chunk length
constexpr int kSub = 16;                    // sub-chunk length
constexpr int kK = 64;                      // channels, K padded with zeros
constexpr int kLdW = 68;                    // the f32 state's row stride
constexpr int kLdS = 72;                    // bf16 stride: ldmatrix rows on
                                            // distinct banks
constexpr int kOffRows = 96;                // rows of the decayed r blocks
// the reference's clip of the log ratio at -60, in log2 units
constexpr float kClip2 = -86.5617024533378f;
static_assert(kC == 4 * kSub && kK == kC, "the tiling assumes 64 x 64");

// A chunk's inputs as the TMA writes them: r, k, v rows of 128 bytes in
// the 128-byte swizzle (16-byte unit u of row i at u ^ (i % 8): a column
// of 8 rows spans every bank), w rows of 256 bytes. w becomes P in place:
// P_i = log2 of the inclusive cumulative decay, so log2 Q_i = P_{i-1}.
struct Stage {
  __nv_bfloat16 r[kC * kK], k[kC * kK], v[kC * kK];
  float w[kC][kK];
};

// the offset of (row i, channel c) in a swizzled bf16 tile
__device__ __forceinline__ int sw(int i, int c) {
  return i * kK + (((c / 8) ^ (i % 8)) * 8) + c % 8;
}

// r, k, v and w as (K, T, BH) tensors, boxes of 64 x 64 x 1: rows past T
// read as zeros
struct Maps {
  CUtensorMap r, k, v, w;
};

// A product operand that is no bf16 input, stored split in two bf16
// halves, x = hi + lo (put2).
template <int kRows>
struct Split {
  __nv_bfloat16 hi[kRows][kLdS], lo[kRows][kLdS];
};

struct Smem {
  Stage st[2];
  Split<kC> rq;               // r_i 2^{P_{i-1}}: the inter-chunk query
  Split<kC> att;              // A: lower triangle and the bonus diagonal
  Split<kOffRows> rj;         // r_i 2^{P_{i-1} - L_J}, i past sub-chunk J
  Split<kC - kSub> kj;        // k_j 2^{L_J - P_j}, j in sub-chunk J < 3
  Split<kC> kd;               // k_j 2^{L - P_j}: the state advance's keys
  Split<kK> sx;               // the state, split
  float s[kK][kLdW];          // the state, k-major
  float part[8][kK];          // the log scan's sums of eighths
  float u[kK];
  float qtot[kK];             // 2^L, the chunk's whole decay
  uint64_t bar[2];            // a stage's TMA loads complete here
};

// the row of rj that holds r_i decayed to the end of sub-chunk J (J's
// block holds i = 16(J+1)..63)
__device__ __forceinline__ int rj_row(int J, int i) {
  return 48 * J - 8 * J * (J - 1) + i - kSub * (J + 1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float clip2(float d) {
  return fminf(fmaxf(d, kClip2), 0.f);
}

// Store x0, x1 at columns c, c + 1 (c even): hi keeps the top 16 bits of
// each (bf16 by truncation: no conversion instruction), lo is the bf16
// rounding of what hi leaves, exact in f32: x = hi + lo to 2^-16 of |x|.
template <int kRows>
__device__ __forceinline__ void put2(Split<kRows>& m, int i, int c, float x0,
                                     float x1) {
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  const float h0 = __uint_as_float(b0 & 0xffff0000u);
  const float h1 = __uint_as_float(b1 & 0xffff0000u);
  *reinterpret_cast<uint32_t*>(&m.hi[i][c]) = __byte_perm(b0, b1, 0x7632);
  *reinterpret_cast<__nv_bfloat162*>(&m.lo[i][c]) =
      __floats2bfloat162_rn(x0 - h0, x1 - h1);
}

// A lane's ldmatrix.x4 address (row, column) relative to a fragment's
// corner, for mma.m16n8k16: a_* for an A fragment of a row-major [m][k]
// matrix; t_* for an A fragment of the transpose of a row-major [k][m]
// matrix (.trans) and for the B fragments of two n-tiles of a row-major
// [n][k] matrix; b_* for those of a row-major [k][n] matrix (.trans).
__device__ __forceinline__ int a_row(int lane) { return lane % 16; }
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane / 16); }
__device__ __forceinline__ int t_row(int lane) {
  return lane % 8 + 8 * (lane / 16);
}
__device__ __forceinline__ int t_col(int lane) { return 8 * (lane / 8 % 2); }
__device__ __forceinline__ int b_row(int lane) {
  return lane % 8 + 8 * (lane / 8 % 2);
}
__device__ __forceinline__ int b_col(int lane) { return 8 * (lane / 16); }

template <int kRows>
__device__ __forceinline__ void ldsm(const Split<kRows>& m, int row, int col,
                                     bool trans, uint32_t (&hi)[4],
                                     uint32_t (&lo)[4]) {
  if (trans) {
    rt_ldmatrix_x4_trans(hi, &m.hi[row][col]);
    rt_ldmatrix_x4_trans(lo, &m.lo[row][col]);
  } else {
    rt_ldmatrix_x4(hi, &m.hi[row][col]);
    rt_ldmatrix_x4(lo, &m.lo[row][col]);
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(rt_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row),
      "r"(head)
      : "memory");
}

// Stage chunk rows [t0, t0 + 64) of row bh. vec (K == 64, every input
// 16-byte aligned): thread 0 asks the TMA for four boxes that complete on
// the stage's mbarrier. Else every thread copies elements, with zero
// channels past K (w = 1 there) and zero rows past T.
__device__ __forceinline__ void load_chunk(
    Stage& st, uint32_t bar, const Maps& maps, const __nv_bfloat16* r,
    const __nv_bfloat16* k, const __nv_bfloat16* v, const float* w,
    int bh, int T, int t0, int K, bool vec, int tid) {
  if (vec) {
    if (tid == 0) {
      rt_mbar_expect_tx(bar, 3 * kC * kK * 2 + kC * kK * 4);
      tma_load(st.r, &maps.r, bar, t0, bh);
      tma_load(st.k, &maps.k, bar, t0, bh);
      tma_load(st.v, &maps.v, bar, t0, bh);
      tma_load(st.w, &maps.w, bar, t0, bh);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    const size_t base = static_cast<size_t>(bh) * T * K;
    for (int e = tid; e < kC * kK; e += kThreads) {
      const int i = e / kK, c = e % kK;
      const bool ok = t0 + i < T && c < K;
      const size_t gi = base + static_cast<size_t>(t0 + i) * K + c;
      st.r[sw(i, c)] = ok ? r[gi] : zero;
      st.k[sw(i, c)] = ok ? k[gi] : zero;
      st.v[sw(i, c)] = ok ? v[gi] : zero;
      st.w[i][c] = ok ? w[gi] : 1.f;
    }
  }
}

// log2 of a decay w in (0, 1]: a series in d = 1 - w near 1 (where
// lg2.approx's absolute error would be a large share of the result, and
// would add up over a chunk), lg2.approx elsewhere.
__device__ __forceinline__ float log2_decay(float w) {
  const float d = 1.f - w;                  // exact for w >= 1/2
  float lg;
  asm("lg2.approx.f32 %0, %1;\n" : "=f"(lg) : "f"(w));
  float s = 1.f / 7;
  s = fmaf(s, d, 1.f / 6);
  s = fmaf(s, d, 1.f / 5);
  s = fmaf(s, d, 1.f / 4);
  s = fmaf(s, d, 1.f / 3);
  s = fmaf(s, d, 1.f / 2);
  s = fmaf(s, d, 1.f);
  return d < 0.0625f ? -1.4426950408889634f * d * s : lg;
}

// Four bf16 of a staged row as floats.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

// One round of a butterfly that sums 16 values over a group of lanes and
// halves them each round: keep the half this lane's bit kOff picks, send
// the other to the lane across it.
template <int kHalf, int kOff>
__device__ __forceinline__ void reduce_round(float (&v)[16], bool up) {
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
    const float lo = v[m], hi = v[m + kHalf];
    v[m] = (up ? hi : lo) +
           __shfl_xor_sync(RT_FULL_MASK, up ? lo : hi, kOff);
  }
}

// A 4 x 4 tile of a diagonal block below the block's diagonal (rows i0..,
// columns j0.., i0 >= j0 + 4), over 8 of the channels: {4s..4s+3,
// 32+4s..32+4s+3}. The sub-chunk factorization once more, at 4: with R =
// P_{j0+3}, the ratio is 2^(P_{i-1} - R) 2^(R - P_j), both exponents <= 0.
__device__ __forceinline__ void diag_full_tile(Smem& sm, const Stage& st,
                                               int i0, int j0, int s) {
  float acc[4][4] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c0 = 32 * h + 4 * s;
    float rr[4][4], kk[4][4], ref[4], x[4];
    load4(&st.w[j0 + 3][c0], ref);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      load4(&st.r[sw(i0 + a, c0)], rr[a]);
      load4(&st.w[i0 + a - 1][c0], x);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) rr[a][cc] *= ex2(x[cc] - ref[cc]);
      load4(&st.k[sw(j0 + a, c0)], kk[a]);
      if (a < 3) {                          // R - P_{j0+3} = 0
        load4(&st.w[j0 + a][c0], x);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) kk[a][cc] *= ex2(ref[cc] - x[cc]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] = fmaf(rr[a][cc], kk[b][cc], acc[a][b]);
  }
  float v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = acc[e / 4][e % 4];
  reduce_round<8, 4>(v, s & 4);
  reduce_round<4, 2>(v, s & 2);
  reduce_round<2, 1>(v, s & 1);             // lane s: entries 2s, 2s + 1
  const int a = s / 2, b = 2 * (s % 2);
  put2(sm.att, i0 + a, j0 + b, v[0], v[1]);
}

// A 4 x 4 tile on the diagonal (rows and columns i0..), over 16 of the
// channels {16h + 4s..}: the pairs below its diagonal in the pairwise form
// with the clip (the ratio of neighbours, 2^(P_{i-1} - P_{i-1}), is 1) and
// the bonus b_i on it. Tile i0 / 4 takes the groups h in the order
// h ^ (i0 / 4 % 4), so that the tiles one load serves hit other banks.
__device__ __forceinline__ void diag_tile(Smem& sm, const Stage& st, int i0,
                                          int s) {
  float acc[4][4] = {};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int c0 = 16 * (h ^ (i0 / 4 % 4)) + 4 * s;
    float rr[4][4], kk[4][4], p[3][4], uu[4];
    load4(&sm.u[c0], uu);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      load4(&st.r[sw(i0 + a, c0)], rr[a]);
      load4(&st.k[sw(i0 + a, c0)], kk[a]);
      if (a < 3) load4(&st.w[i0 + a][c0], p[a]);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][a] = fmaf(rr[a][cc] * uu[cc], kk[a][cc], acc[a][a]);
        if (a > 0) acc[a][a - 1] = fmaf(rr[a][cc], kk[a - 1][cc],
                                        acc[a][a - 1]);
#pragma unroll
        for (int b = 0; b + 1 < a; ++b)
          acc[a][b] = fmaf(rr[a][cc] * kk[b][cc],
                           ex2(clip2(p[a - 1][cc] - p[b][cc])), acc[a][b]);
      }
    }
  }
  float v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = acc[e / 4][e % 4];
  reduce_round<8, 2>(v, s & 2);
  reduce_round<4, 1>(v, s & 1);             // lane s: row s of the tile
  put2(sm.att, i0 + s, i0, v[0], v[1]);
  put2(sm.att, i0 + s, i0 + 2, v[2], v[3]);
}

template <typename Tout>
__device__ __forceinline__ void store_y(Tout* y, size_t off, int col, int K,
                                        float a, float b) {
  if (K % 2 == 0 && col + 1 < K) {          // an even offset: aligned
    if constexpr (sizeof(Tout) == 4) {
      *reinterpret_cast<float2*>(y + off) = make_float2(a, b);
    } else {
      *reinterpret_cast<uint32_t*>(y + off) = rt_pack_bf16(a, b);
    }
  } else {
    if (col < K) y[off] = rt_from_f32<Tout>(a);
    if (col + 1 < K) y[off + 1] = rt_from_f32<Tout>(b);
  }
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
rwkv_chunk_tc_kernel(const __grid_constant__ Maps maps,
                     const __nv_bfloat16* __restrict__ r,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ w, const float* __restrict__ u,
                     Tout* __restrict__ y, float* __restrict__ s_out, int T,
                     int K, int u_rows, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * T * K;
  const uint32_t bar0 = rt_smem_addr(&sm.bar[0]);

  // the state starts at zero, and A's upper triangle is never written
  for (int e = tid; e < kK * kLdW; e += kThreads) (&sm.s[0][0])[e] = 0.f;
  for (int e = tid; e < kC * kLdS; e += kThreads) {
    (&sm.sx.hi[0][0])[e] = (&sm.sx.lo[0][0])[e] = __float2bfloat16(0.f);
    (&sm.att.hi[0][0])[e] = (&sm.att.lo[0][0])[e] = __float2bfloat16(0.f);
  }
  if (tid < kK)
    sm.u[tid] = tid < K ? u[static_cast<size_t>(bh % u_rows) * K + tid] : 0.f;
  if (tid == 0) {
    rt_mbar_init(bar0, 1);
    rt_mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int chunks = (T + kC - 1) / kC;
  load_chunk(sm.st[0], bar0, maps, r, k, v, w, bh, T, 0, K, vec, tid);
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * kC, n = min(kC, T - t0);
    Stage& st = sm.st[ci % 2];
    if (ci + 1 < chunks)                    // the next chunk streams in
      load_chunk(sm.st[(ci + 1) % 2], bar0 + 8 * ((ci + 1) % 2), maps, r, k,
                 v, w, bh, T, t0 + kC, K, vec, tid);
    if (vec) rt_mbar_wait(bar0 + 8 * (ci % 2), (ci / 2) % 2);
    __syncthreads();

    // P, in place of w: thread (cp, q) scans steps 8q..8q+7 of channels
    // 2cp and 2cp + 1, then adds the sums of the eighths before its own
    const int cp = tid % 32, q = tid / 32, c2 = 2 * cp;
    {
      float2 x[kC / 8];
#pragma unroll
      for (int e = 0; e < kC / 8; ++e) {
        const int i = q * (kC / 8) + e;
        const float2 wi = *reinterpret_cast<const float2*>(&st.w[i][c2]);
        x[e] = i < n ? make_float2(log2_decay(fmaxf(wi.x, 1e-38f)),
                                   log2_decay(fmaxf(wi.y, 1e-38f)))
                     : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int e = 1; e < kC / 8; ++e) {
        x[e].x += x[e - 1].x;
        x[e].y += x[e - 1].y;
      }
      *reinterpret_cast<float2*>(&sm.part[q][c2]) = x[kC / 8 - 1];
      __syncthreads();
      float2 pre = make_float2(0.f, 0.f);
      for (int qq = 0; qq < q; ++qq) {
        const float2 pq = *reinterpret_cast<const float2*>(&sm.part[qq][c2]);
        pre.x += pq.x;
        pre.y += pq.y;
      }
#pragma unroll
      for (int e = 0; e < kC / 8; ++e)
        *reinterpret_cast<float2*>(&st.w[q * (kC / 8) + e][c2]) =
            make_float2(x[e].x + pre.x, x[e].y + pre.y);
      __syncthreads();
    }

    // the decayed operands (every exponent <= 0); thread (cp, q) takes
    // rows q + 8m of channels 2cp, 2cp + 1, so row 8m + q lies in
    // sub-chunk m / 2
    {
      float2 end[4];                        // L_J, and L = end[3]
#pragma unroll
      for (int J = 0; J < 4; ++J)
        end[J] = *reinterpret_cast<const float2*>(
            &st.w[kSub * J + kSub - 1][c2]);
      if (q == 0) {
        sm.qtot[c2] = ex2(end[3].x);
        sm.qtot[c2 + 1] = ex2(end[3].y);
      }
#pragma unroll
      for (int m = 0; m < kC / 8; ++m) {
        const int i = 8 * m + q, J = m / 2;
        const float2 rr = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&st.r[sw(i, c2)]));
        const float2 kk = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&st.k[sw(i, c2)]));
        const float2 pi = *reinterpret_cast<const float2*>(&st.w[i][c2]);
        const float2 pm = i > 0
            ? *reinterpret_cast<const float2*>(&st.w[i - 1][c2])
            : make_float2(0.f, 0.f);
        put2(sm.rq, i, c2, rr.x * ex2(pm.x), rr.y * ex2(pm.y));
        put2(sm.kd, i, c2, kk.x * ex2(end[3].x - pi.x),
             kk.y * ex2(end[3].y - pi.y));
        if (J < 3)
          put2(sm.kj, i, c2, kk.x * ex2(end[J].x - pi.x),
               kk.y * ex2(end[J].y - pi.y));
#pragma unroll
        for (int JJ = 0; JJ < J; ++JJ)
          put2(sm.rj, rj_row(JJ, i), c2, rr.x * ex2(pm.x - end[JJ].x),
               rr.y * ex2(pm.y - end[JJ].y));
      }
    }
    // the diagonal blocks: warps 0-5 the 24 tiles below the blocks'
    // diagonals (8 lanes a tile), warps 6-7 the 16 on them (4 lanes)
    if (tid < 192) {
      const int tile = tid / 8, I = tile / 6, p = tile % 6;
      const int ta = p == 0 ? 1 : p < 3 ? 2 : 3;
      const int tb = p == 0 ? 0 : p < 3 ? p - 1 : p - 3;
      diag_full_tile(sm, st, kSub * I + 4 * ta, kSub * I + 4 * tb, tid % 8);
    } else {
      const int tile = (tid - 192) / 4;
      diag_tile(sm, st, 4 * tile, tid % 4);
    }
    __syncthreads();

    // the off-diagonal blocks: A[I][J] = rj(J)_I kj_J^T, one 16 x 16 block
    // a warp (warps 0-5), two accumulators an n-tile (even and odd k)
    if (warp < 6) {
      const int I = warp == 0 ? 1 : warp < 3 ? 2 : 3;
      const int J = warp == 0 ? 0 : warp < 3 ? warp - 1 : warp - 3;
      float acc[2][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        ldsm(sm.rj, rj_row(J, kSub * I) + a_row(lane),
             16 * ks + a_col(lane), false, ah, al);
        ldsm(sm.kj, kSub * J + t_row(lane), 16 * ks + t_col(lane), false,
             bh, bl);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          rt_mma_bf16_16816(acc[nt][ks % 2], al, bh[2 * nt], bh[2 * nt + 1]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          rt_mma_bf16_16816(acc[nt][ks % 2], ah, bl[2 * nt], bl[2 * nt + 1]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          rt_mma_bf16_16816(acc[nt][ks % 2], ah, bh[2 * nt], bh[2 * nt + 1]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int row = kSub * I + g, col = kSub * J + 8 * nt + 2 * t;
        put2(sm.att, row, col, acc[nt][0][0] + acc[nt][1][0],
             acc[nt][0][1] + acc[nt][1][1]);
        put2(sm.att, row + 8, col, acc[nt][0][2] + acc[nt][1][2],
             acc[nt][0][3] + acc[nt][1][3]);
      }
    }
    __syncthreads();

    // y = (r Q) S0 + A v and S = diag(Q_C) S0 + kd^T v: warp (mt, nh) owns
    // rows 16 mt and columns 32 nh of both; the products of one k-step go
    // to the 4 n-tiles in turn
    {
      const int mt = warp % 4, nh = warp / 4;
      float ya[4][4] = {}, sa[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 16 * mt + g, vv = 32 * nh + 8 * nt + 2 * t;
        sa[nt][0] = sm.qtot[c] * sm.s[c][vv];
        sa[nt][1] = sm.qtot[c] * sm.s[c][vv + 1];
        sa[nt][2] = sm.qtot[c + 8] * sm.s[c + 8][vv];
        sa[nt][3] = sm.qtot[c + 8] * sm.s[c + 8][vv + 1];
      }
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        uint32_t ah[4], al[4], bh[2][4], bl[2][4];
        ldsm(sm.rq, 16 * mt + a_row(lane), 16 * ks + a_col(lane), false, ah,
             al);
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldsm(sm.sx, 16 * ks + b_row(lane), 32 * nh + 16 * p + b_col(lane),
               true, bh[p], bl[p]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          rt_mma_bf16_16816(ya[nt], al, bh[nt / 2][2 * (nt % 2)],
                            bh[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          rt_mma_bf16_16816(ya[nt], ah, bl[nt / 2][2 * (nt % 2)],
                            bl[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          rt_mma_bf16_16816(ya[nt], ah, bh[nt / 2][2 * (nt % 2)],
                            bh[nt / 2][2 * (nt % 2) + 1]);
      }
#pragma unroll
      for (int ks = 0; ks < kC / 16; ++ks) {
        // v rows 16 ks.., columns 32 nh..: two ldmatrix.x4.trans
        uint32_t bv[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          rt_ldmatrix_x4_trans(
              bv[p], &st.v[sw(16 * ks + b_row(lane),
                              32 * nh + 16 * p + b_col(lane))]);
        uint32_t ah[4], al[4], kh[4], kl[4];
        ldsm(sm.kd, 16 * ks + t_row(lane), 16 * mt + t_col(lane), true, kh,
             kl);
        if (ks <= mt) {                     // A is lower triangular
          ldsm(sm.att, 16 * mt + a_row(lane), 16 * ks + a_col(lane), false,
               ah, al);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            rt_mma_bf16_16816(ya[nt], al, bv[nt / 2][2 * (nt % 2)],
                              bv[nt / 2][2 * (nt % 2) + 1]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          rt_mma_bf16_16816(sa[nt], kl, bv[nt / 2][2 * (nt % 2)],
                            bv[nt / 2][2 * (nt % 2) + 1]);
        if (ks <= mt) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            rt_mma_bf16_16816(ya[nt], ah, bv[nt / 2][2 * (nt % 2)],
                              bv[nt / 2][2 * (nt % 2) + 1]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          rt_mma_bf16_16816(sa[nt], kh, bv[nt / 2][2 * (nt % 2)],
                            bv[nt / 2][2 * (nt % 2) + 1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int i = 16 * mt + g, col = 32 * nh + 8 * nt + 2 * t;
        if (i < n)
          store_y(y, base + static_cast<size_t>(t0 + i) * K + col, col, K,
                  ya[nt][0], ya[nt][1]);
        if (i + 8 < n)
          store_y(y, base + static_cast<size_t>(t0 + i + 8) * K + col, col,
                  K, ya[nt][2], ya[nt][3]);
      }
      __syncthreads();                      // every warp has read S0
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 16 * mt + g, vv = 32 * nh + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(&sm.s[c][vv]) =
            make_float2(sa[nt][0], sa[nt][1]);
        *reinterpret_cast<float2*>(&sm.s[c + 8][vv]) =
            make_float2(sa[nt][2], sa[nt][3]);
        put2(sm.sx, c, vv, sa[nt][0], sa[nt][1]);
        put2(sm.sx, c + 8, vv, sa[nt][2], sa[nt][3]);
      }
    }
    // the stage's next TMA writes come after these generic-proxy writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                        // S and the stage are free
  }
  for (int e = tid; e < K * K; e += kThreads)
    s_out[static_cast<size_t>(bh) * K * K + e] = sm.s[e / K][e % K];
}

// (64, T, BH) at `base` in bf16 (128-byte swizzle) or f32 (none)
bool encode_map(CUtensorMap* map, const void* base, bool bf16, int T,
                int BH) {
  const RtEncodeTiled encode = rt_encode_tiled();
  if (!encode) return false;
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {kK, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {kK * es, (cuuint64_t)T * kK * es};
  const cuuint32_t box[3] = {kK, kC, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Tout>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* y, void* s_out, int BH, int T, int K,
                   int u_rows, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_chunk_tc_kernel<Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const uintptr_t align = reinterpret_cast<uintptr_t>(r) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(w);
  const int vec = K == kK && align % 16 == 0;
  Maps maps = {};
  if (vec && !(encode_map(&maps.r, r, true, T, BH) &&
               encode_map(&maps.k, k, true, T, BH) &&
               encode_map(&maps.v, v, true, T, BH) &&
               encode_map(&maps.w, w, false, T, BH)))
    return cudaErrorInvalidValue;
  rwkv_chunk_tc_kernel<Tout><<<BH, kThreads, smem, stream>>>(
      maps, static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<Tout*>(y),
      static_cast<float*>(s_out), T, K, u_rows, vec);
  return cudaGetLastError();
}

}  // namespace tc

// r, k, v: (BH, T, K) of in_dtype; w: (BH, T, K) f32; u: (u_rows, K) f32,
// row bh reads u[bh % u_rows]; y: (BH, T, K) of out_dtype; s_out:
// (BH, K, K) f32. All contiguous; 1 <= K <= 64, T >= 1.
extern "C" int rwkv_chunk_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* y,
                                 void* s_out, int BH, int T, int K,
                                 int u_rows, int in_dtype, int out_dtype,
                                 void* stream) {
  if (BH < 1 || T < 1 || K < 1 || K > kMaxK || u_rows < 1 || BH % u_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == RT_F32 && out_dtype == RT_F32)
    return static_cast<int>(launch_typed<float, float>(r, k, v, w, u, y, s_out, BH, T, K, u_rows, s));
  if (in_dtype == RT_BF16 && out_dtype == RT_F32)
    return static_cast<int>(tc::launch<float>(r, k, v, w, u, y, s_out, BH, T, K, u_rows, s));
  if (in_dtype == RT_F32 && out_dtype == RT_BF16)
    return static_cast<int>(launch_typed<float, __nv_bfloat16>(r, k, v, w, u, y, s_out, BH, T, K, u_rows, s));
  if (in_dtype == RT_BF16 && out_dtype == RT_BF16)
    return static_cast<int>(tc::launch<__nv_bfloat16>(r, k, v, w, u, y, s_out, BH, T, K, u_rows, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
