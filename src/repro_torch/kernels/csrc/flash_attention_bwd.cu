// flash_attention_bwd: the recomputing flash-attention backward, the
// gradient of flash_attention.cu's static mode (causal or not, q_offset 0)
// on the training path.
//
// Replaces no TPU kernel: the reference's backward,
// repro/models/attention.py::_flash_bwd (the custom VJP of
// flash_attention_fused), is XLA, not Pallas. On the card the forward it
// differentiates is a hand-written kernel, so its gradient is one too. It
// computes what _flash_bwd computes (ref.flash_attention_bwd_ref is the
// plain version): from q, k, v, the forward's output o and its per-row
// log-sum-exp lse (natural log of the scaled scores), and dO,
//   D = rowsum(dO o), P = exp(s - lse), dV = P^T dO, dP = dO V^T,
//   dS = P (dP - D), dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd),
// where a KV head's dK and dV sum over its G query heads (GQA).
//
// Bound on an H100 SXM: operations. llama3.2-1b's training shape (B 4,
// H 32 / KH 8, S 1024 causal, D 64) has 4 * 32 * 524,800 (query, key)
// pairs; the five products take 10 D FLOPs a pair, 4.3e10, 0.043 ms at
// 989 TFLOP/s, against 50 MB of q, k, v, o, dO, lse in and dq, dk, dv out
// (0.015 ms).
//
// Design, chosen to be right and deterministic before fast: three kernels
// in one launch call, no atomics, every sum in a fixed order, so two calls
// give the same bits.
//  * bwd_delta_kernel: D = rowsum(dO o) in f32, one warp a row, into a
//    (B, H, S) f32 scratch buffer.
//  * the dK/dV pass: one CTA per (tile of keys, KV head, batch row) holds
//    its keys' K and V rows and their dK, dV accumulators in registers
//    (FlashAttention-2's KV-parallel loop) and walks the query rows of all
//    G heads of its group that can see a key of the tile (from the tile's
//    first key on when causal), 32 rows a round staged in shared memory,
//    recomputing P and dS for each (key, query) pair.
//  * the dQ pass: one CTA per (tile of query rows, head, batch row) holds
//    its rows' q, dO, lse and D and a dQ accumulator in registers and walks
//    the keys up to its causal frontier, 32 a round staged in shared
//    memory, recomputing P and dS; the tiles with the most keys first.
// Two routes, by dtype and head dim:
//  * bf16 at D 16, 32 and 64 (llama3.2-1b's 64, the reduced configs' 16):
//    bwd_dkdv_mma_kernel and bwd_dq_mma_kernel on the tensor cores,
//    mma.sync.m16n8k16 with f32 accumulators (the decode kernel's
//    fragments): a warp owns 16 keys (or query rows), its K and V (or q
//    and dO) rows as A fragments in registers, the staged rows read by
//    ldmatrix (ldmatrix.trans for the second product); S^T = K Q^T and
//    dP^T = V dO^T, then P^T and dS^T from the f32 accumulators in place
//    (the accumulator layout of the first product is the A layout of the
//    second), times dO and Q into dV and dK; the dQ pass alike. P and dS
//    enter the second products as two bf16 halves each (hi and what hi
//    leaves out, as rwkv_chunk's tensor-core route splits its operands):
//    rounding them to one bf16, FlashAttention-2's way, missed the bf16
//    bound 1e-2 + 2e-2 |want| at B 4, S 1000 (an error of 0.0625: dK and
//    dV sum up to 4,000 terms a key); the split keeps them to about 2^-17
//    for 40 % more tensor-core work.
//  * f32, and bf16 at D 128: bwd_dkdv_kernel and bwd_dq_kernel on the CUDA
//    cores in f32 (every product in f32, as the plain version and the
//    reference compute them: the float32 route is held to 1e-4). A row of
//    D elements belongs to D / 16 threads (16 dims each, as four 16-byte
//    chunks interleaved so that the threads of a row read neighbouring
//    chunks), whose partial dot products meet in an xor butterfly (every
//    lane ends with the same sum). D in {16, 32, 64, 128}.
// wgmma and TMA, the forward's design, are the next step.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kDims = 16;     // head dims a thread owns: 4 chunks of 4
constexpr int kTile = 32;     // query rows (dk/dv) or keys (dq) a round

template <int D> constexpr int kTpr = D / kDims;              // threads a row
template <int D> constexpr int kRows = kThreads / kTpr<D>;    // rows a CTA

// the 4-element chunk i (0..3) of thread `part`'s dims
template <int D>
__device__ __forceinline__ int chunk_of(int part, int i) {
  return part + kTpr<D> * i;
}

template <typename T, int D>
__device__ __forceinline__ void load_row(const T* row, int part, bool ok,
                                         float (&r)[kDims]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[4 * i + e] = ok ? rt_to_f32(row[4 * chunk_of<D>(part, i) + e]) : 0.f;
}

// the full dot product of a row held in registers with a staged row,
// summed over the row's threads
template <int D>
__device__ __forceinline__ float dot_row(const float (&r)[kDims],
                                         const float* srow, int part) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(srow)[chunk_of<D>(part, i)];
    d = fmaf(r[4 * i], x.x, d);
    d = fmaf(r[4 * i + 1], x.y, d);
    d = fmaf(r[4 * i + 2], x.z, d);
    d = fmaf(r[4 * i + 3], x.w, d);
  }
#pragma unroll
  for (int o = 1; o < kTpr<D>; o <<= 1)
    d += __shfl_xor_sync(RT_FULL_MASK, d, o);
  return d;
}

// acc += a * (a staged row's dims of this thread)
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[kDims], float a,
                                         const float* srow, int part) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(srow)[chunk_of<D>(part, i)];
    acc[4 * i] = fmaf(a, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(a, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a, x.w, acc[4 * i + 3]);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* row, int part,
                                          const float (&r)[kDims], float s) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      row[4 * chunk_of<D>(part, i) + e] = rt_from_f32<T>(r[4 * i + e] * s);
}

// `rows` rows of D elements from `src` (row 0 at `first`, rows past `n`
// zero) into shared memory as f32
template <typename T, int D>
__device__ __forceinline__ void stage(float (*dst)[D], const T* src,
                                      int first, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r][c] = r < n ? rt_to_f32(src[(size_t)(first + r) * D + c]) : 0.f;
  }
}

// D = rowsum(dO o), one warp a row of (B, H, S)
template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float d = 0.f;
  for (int c = lane; c < D; c += 32)
    d = fmaf(rt_to_f32(o[row * D + c]), rt_to_f32(dout[row * D + c]), d);
  d = rt_warp_sum(d);
  if (lane == 0) delta[row] = d;
}

// dK, dV of a tile of kRows keys of one (batch row, KV head)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int H, int KH, int S, int Skv,
                int causal, float scale) {
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float del_s[kTile];

  const int kh = blockIdx.y, b = blockIdx.z, G = H / KH;
  const int row = threadIdx.x / kTpr<D>, part = threadIdx.x % kTpr<D>;
  const int k0 = blockIdx.x * kRows<D>;
  const int key = k0 + row;
  const bool key_ok = key < Skv;
  const size_t kv_row = ((size_t)b * KH + kh) * Skv + (key_ok ? key : 0);

  float kr[kDims], vr[kDims], dk_acc[kDims], dv_acc[kDims];
  load_row<T, D>(k + kv_row * D, part, key_ok, kr);
  load_row<T, D>(v + kv_row * D, part, key_ok, vr);
#pragma unroll
  for (int i = 0; i < kDims; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // no query before the tile's first key sees it under the causal mask
  const int q_first = causal ? (min(k0, S) / kTile) * kTile : 0;
  for (int g = 0; g < G; ++g) {
    const size_t head = (size_t)b * H + (size_t)kh * G + g;   // q's head
    for (int q0 = q_first; q0 < S; q0 += kTile) {
      const int n = min(kTile, S - q0);
      __syncthreads();   // the previous round's reads are done
      stage<T, D>(qs, q + head * S * D, q0, n);
      stage<T, D>(dos, dout + head * S * D, q0, n);
      if (threadIdx.x < kTile) {
        const bool in = threadIdx.x < n;
        lse_s[threadIdx.x] = in ? lse[head * S + q0 + threadIdx.x] : 0.f;
        del_s[threadIdx.x] = in ? delta[head * S + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        const float s = dot_row<D>(kr, qs[i], part);
        const float dp = dot_row<D>(vr, dos[i], part);
        const bool keep = key_ok && (!causal || key <= q0 + i);
        const float p = keep ? expf(s * scale - lse_s[i]) : 0.f;
        const float ds = p * (dp - del_s[i]);
        axpy_row<D>(dv_acc, p, dos[i], part);
        axpy_row<D>(dk_acc, ds, qs[i], part);
      }
    }
  }
  if (key_ok) {
    store_row<T, D>(dk + kv_row * D, part, dk_acc, scale);
    store_row<T, D>(dv + kv_row * D, part, dv_acc, 1.f);
  }
}

// dQ of a tile of kRows query rows of one (batch row, head); the last
// tiles (most keys under the causal mask) first
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int KH, int S, int Skv, int causal,
              float scale) {
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);
  const int row = threadIdx.x / kTpr<D>, part = threadIdx.x % kTpr<D>;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows<D>;
  const int qi = q0 + row;
  const bool q_ok = qi < S;
  const size_t q_row = ((size_t)b * H + h) * S + (q_ok ? qi : 0);

  float qr[kDims], dor[kDims], dq_acc[kDims];
  load_row<T, D>(q + q_row * D, part, q_ok, qr);
  load_row<T, D>(dout + q_row * D, part, q_ok, dor);
#pragma unroll
  for (int i = 0; i < kDims; ++i) dq_acc[i] = 0.f;
  const float row_lse = q_ok ? lse[q_row] : 0.f;
  const float row_del = q_ok ? delta[q_row] : 0.f;

  const int kv_end = causal ? min(Skv, min(S, q0 + kRows<D>)) : Skv;
  const size_t kv_head = ((size_t)b * KH + kh) * Skv * D;
  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    const int n = min(kTile, kv_end - t0);
    __syncthreads();
    stage<T, D>(ks, k + kv_head, t0, n);
    stage<T, D>(vs, v + kv_head, t0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float s = dot_row<D>(qr, ks[j], part);
      const float dp = dot_row<D>(dor, vs[j], part);
      const bool keep = q_ok && (!causal || t0 + j <= qi);
      const float p = keep ? expf(s * scale - row_lse) : 0.f;
      axpy_row<D>(dq_acc, p * (dp - row_del), ks[j], part);
    }
  }
  if (q_ok) store_row<T, D>(dq + q_row * D, part, dq_acc, scale);
}

// ---------------------------------------------------------------------------
// bf16 route on the tensor cores (mma.sync.m16n8k16, f32 accumulators),
// D in {16, 32, 64}. Shared-memory rows are padded by 16 bytes so that
// ldmatrix reads 8 rows without bank conflicts.
// ---------------------------------------------------------------------------
constexpr int kMmaRows = 64;   // keys (dk/dv) or query rows (dq) a CTA
constexpr int kMmaTile = 32;   // query rows (dk/dv) or keys (dq) a round

template <int D> constexpr int kPad = D + 8;

// a (16 x D) row-major bf16 block at `rows` (row stride D, rows past
// `n_ok` zero) as D / 16 A fragments
template <int D>
__device__ __forceinline__ void load_a(const __nv_bfloat16* rows, int n_ok,
                                       uint32_t (&a)[D / 16][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const __nv_bfloat16* r0 = rows + (size_t)g * D + 2 * t4;
  const __nv_bfloat16* r8 = r0 + 8 * D;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16;
    a[ks][0] = g < n_ok ? *reinterpret_cast<const uint32_t*>(r0 + c) : 0u;
    a[ks][1] = g + 8 < n_ok ? *reinterpret_cast<const uint32_t*>(r8 + c) : 0u;
    a[ks][2] = g < n_ok ? *reinterpret_cast<const uint32_t*>(r0 + c + 8) : 0u;
    a[ks][3] =
        g + 8 < n_ok ? *reinterpret_cast<const uint32_t*>(r8 + c + 8) : 0u;
  }
}

// kMmaTile rows of D bf16 from `src` (row 0 at `first`, rows past `n`
// zero) into padded shared memory, 16 bytes a thread at a time
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16 (*dst)[kPad<D>],
                                           const __nv_bfloat16* src,
                                           int first, int n) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < kMmaTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(first + r) * D +
                                          c * 8);
    *reinterpret_cast<uint4*>(&dst[r][c * 8]) = x;
  }
}

// c (16 x kMmaTile, f32) = A (16 x D, fragments) B^T, B the staged rows
// (kMmaTile x D): the rows are B's n index, D its k index
template <int D>
__device__ __forceinline__ void mma_abt(const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16 (*b)[kPad<D>],
                                        float (&c)[kMmaTile / 8][4]) {
  const int lane = threadIdx.x % 32, j8 = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int n = 0; n < kMmaTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int n = 0; n < kMmaTile / 8; n += 2) {
      uint32_t bf[4];
      rt_ldmatrix_x4(bf, &b[n * 8 + (j8 >> 1) * 8 + r8][ks * 16 + (j8 & 1) * 8]);
      rt_mma_bf16_16816(c[n], a[ks], bf[0], bf[1]);
      rt_mma_bf16_16816(c[n + 1], a[ks], bf[2], bf[3]);
    }
}

// two f32 values as the bf16 pair hi and the bf16 pair of what hi leaves
// out: hi + lo holds about 16 of f32's 24 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = rt_pack_bf16(x0 - f.x, x1 - f.y);
}

// acc (16 x D, f32) += P (16 x kMmaTile, the f32 fragments of an mma_abt)
// B, B the staged rows (kMmaTile x D): the rows are B's k index. The
// accumulator layout of the first product is the A layout of this one; P
// enters as two bf16 halves, each times B, so the product keeps P's f32
// precision to about 2^-17 (B is bf16 already)
template <int D>
__device__ __forceinline__ void mma_pb(const float (&p)[kMmaTile / 8][4],
                                       const __nv_bfloat16 (*b)[kPad<D>],
                                       float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x % 32, j8 = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int kk = 0; kk < kMmaTile / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* f = p[2 * kk + (e >> 1)];
      split_bf16(f[2 * (e & 1)], f[2 * (e & 1) + 1], hi[e], lo[e]);
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      uint32_t bf[4];
      rt_ldmatrix_x4_trans(
          bf, &b[kk * 16 + (j8 & 1) * 8 + r8][(nd + (j8 >> 1)) * 8]);
      rt_mma_bf16_16816(acc[nd], hi, bf[0], bf[1]);
      rt_mma_bf16_16816(acc[nd], lo, bf[0], bf[1]);
      rt_mma_bf16_16816(acc[nd + 1], hi, bf[2], bf[3]);
      rt_mma_bf16_16816(acc[nd + 1], lo, bf[2], bf[3]);
    }
  }
}

// a (16 x D) f32 accumulator times s, as bf16 rows of D at `rows` (rows
// past n_ok not written)
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* rows, int n_ok,
                                          const float (&acc)[D / 8][4],
                                          float s) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (g + 8 * h >= n_ok) continue;
    __nv_bfloat16* r = rows + (size_t)(g + 8 * h) * D + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(r + nd * 8) = __floats2bfloat162_rn(
          acc[nd][2 * h] * s, acc[nd][2 * h + 1] * s);
  }
}

// dK, dV of kMmaRows keys of one (batch row, KV head): warp w owns keys
// 16 w..16 w + 15 (their K and V rows as A fragments in registers) and
// walks the query rows of the group's G heads, kMmaTile a round: S^T =
// K Q^T, dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int H, int KH, int S,
                    int Skv, int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kMmaTile][kPad<D>];
  __shared__ __align__(16) __nv_bfloat16 dos[kMmaTile][kPad<D>];
  __shared__ float lse_s[kMmaTile];
  __shared__ float del_s[kMmaTile];

  const int kh = blockIdx.y, b = blockIdx.z, G = H / KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = blockIdx.x * kMmaRows, kw = k0 + warp * 16;
  const size_t kv_head = (size_t)b * KH + kh;
  const int n_keys = max(0, min(16, Skv - kw));
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(k + (kv_head * Skv + min(kw, Skv - 1)) * D, n_keys, ka);
  load_a<D>(v + (kv_head * Skv + min(kw, Skv - 1)) * D, n_keys, va);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  const int q_first = causal ? (min(k0, S) / kMmaTile) * kMmaTile : 0;
  for (int gi = 0; gi < G; ++gi) {
    const size_t head = (size_t)b * H + (size_t)kh * G + gi;
    for (int q0 = q_first; q0 < S; q0 += kMmaTile) {
      const int n = min(kMmaTile, S - q0);
      __syncthreads();   // the previous round's reads are done
      stage_bf16<D>(qs, q + head * S * D, q0, n);
      stage_bf16<D>(dos, dout + head * S * D, q0, n);
      if (threadIdx.x < kMmaTile) {
        const bool in = threadIdx.x < n;
        lse_s[threadIdx.x] = in ? lse[head * S + q0 + threadIdx.x] : 0.f;
        del_s[threadIdx.x] = in ? delta[head * S + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      if (causal && q0 + n - 1 < kw) continue;   // no row sees these keys
      float st[kMmaTile / 8][4], dpt[kMmaTile / 8][4];
      mma_abt<D>(ka, qs, st);
      mma_abt<D>(va, dos, dpt);
      // element (n, e): key kw + g + 8 (e / 2), query q0 + 8 n + 2 t4 + e % 2
#pragma unroll
      for (int nn = 0; nn < kMmaTile / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + g + 8 * (e >> 1);
          const int col = 8 * nn + 2 * t4 + (e & 1), qi = q0 + col;
          const bool keep = key < Skv && col < n && (!causal || key <= qi);
          const float p = keep ? expf(st[nn][e] * scale - lse_s[col]) : 0.f;
          st[nn][e] = p;
          dpt[nn][e] = p * (dpt[nn][e] - del_s[col]);
        }
      mma_pb<D>(st, dos, dv_acc);
      mma_pb<D>(dpt, qs, dk_acc);
    }
  }
  if (n_keys > 0) {
    store_acc<D>(dk + (kv_head * Skv + kw) * D, n_keys, dk_acc, scale);
    store_acc<D>(dv + (kv_head * Skv + kw) * D, n_keys, dv_acc, 1.f);
  }
}

// dQ of kMmaRows query rows of one (batch row, head): warp w owns rows
// 16 w..16 w + 15 (their q and dO rows as A fragments) and walks the keys
// up to the CTA's causal frontier, kMmaTile a round: S = Q K^T, dP = dO
// V^T, dQ += dS K; the last row tiles first
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int H, int KH, int S,
                  int Skv, int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaTile][kPad<D>];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaTile][kPad<D>];

  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows, qw = q0 + warp * 16;
  const size_t head = (size_t)b * H + h;
  const int n_rows = max(0, min(16, S - qw));
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(q + (head * S + min(qw, S - 1)) * D, n_rows, qa);
  load_a<D>(dout + (head * S + min(qw, S - 1)) * D, n_rows, da);
  float row_lse[2], row_del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + g + 8 * r;
    row_lse[r] = qi < S ? lse[head * S + qi] : 0.f;
    row_del[r] = qi < S ? delta[head * S + qi] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[nd][e] = 0.f;

  const int kv_end = causal ? min(Skv, min(S, q0 + kMmaRows)) : Skv;
  const size_t kv_head = ((size_t)b * KH + kh) * Skv * D;
  for (int t0 = 0; t0 < kv_end; t0 += kMmaTile) {
    const int n = min(kMmaTile, kv_end - t0);
    __syncthreads();
    stage_bf16<D>(ks, k + kv_head, t0, n);
    stage_bf16<D>(vs, v + kv_head, t0, n);
    __syncthreads();
    if (n_rows == 0 || (causal && t0 > qw + n_rows - 1)) continue;
    float s[kMmaTile / 8][4], dp[kMmaTile / 8][4];
    mma_abt<D>(qa, ks, s);
    mma_abt<D>(da, vs, dp);
    // element (n, e): row qw + g + 8 (e / 2), key t0 + 8 n + 2 t4 + e % 2
#pragma unroll
    for (int nn = 0; nn < kMmaTile / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qi = qw + g + 8 * r;
        const int col = 8 * nn + 2 * t4 + (e & 1), key = t0 + col;
        const bool keep = qi < S && col < n && (!causal || key <= qi);
        const float p = keep ? expf(s[nn][e] * scale - row_lse[r]) : 0.f;
        s[nn][e] = p * (dp[nn][e] - row_del[r]);
      }
    mma_pb<D>(s, ks, dq_acc);
  }
  if (n_rows > 0) store_acc<D>(dq + (head * S + qw) * D, n_rows, dq_acc, scale);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       int H, int KH, int S, int Skv, int causal, float scale,
                       cudaStream_t s) {
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  const long long rows = (long long)B * H * S;
  bwd_delta_kernel<bf, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const bf*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((Skv + kMmaRows - 1) / kMmaRows, KH, B);
  bwd_dkdv_mma_kernel<D><<<kv_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      H, KH, S, Skv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((S + kMmaRows - 1) / kMmaRows, H, B);
  bwd_dq_mma_kernel<D><<<q_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dq), H, KH, S, Skv,
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_all(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       int H, int KH, int S, int Skv, int causal, float scale,
                       cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)B * H * S;
  bwd_delta_kernel<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((Skv + kRows<D> - 1) / kRows<D>, KH, B);
  bwd_dkdv_kernel<T, D><<<kv_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, KH, S, Skv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((S + kRows<D> - 1) / kRows<D>, H, B);
  bwd_dq_kernel<T, D><<<q_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), H, KH, S, Skv,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       int H, int KH, int S, int Skv, int causal, float scale,
                       cudaStream_t s) {
#define RT_BWD_CASE(DIM)                                                    \
  case DIM:                                                                 \
    if constexpr (std::is_same<T, __nv_bfloat16>::value && DIM <= 64)       \
      return launch_mma<DIM>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,   \
                             H, KH, S, Skv, causal, scale, s);              \
    else                                                                    \
      return launch_all<T, DIM>(q, k, v, o, lse, dout, dq, dk, dv, delta,  \
                                B, H, KH, S, Skv, causal, scale, s);
  switch (D) {
    RT_BWD_CASE(16)
    RT_BWD_CASE(32)
    RT_BWD_CASE(64)
    RT_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_BWD_CASE
}

}  // namespace

// q, o, dout, dq: (B, H, S, D); k, v, dk, dv: (B, KH, Skv, D); all
// contiguous, of one dtype (RT_F32 or RT_BF16). lse: the forward's (B, H,
// S) f32 log-sum-exp; delta: (B, H, S) f32 scratch. Queries at positions
// [0, S), keys [0, Skv); causal masks key > query. D in {16, 32, 64, 128}.
// Three kernels on `stream`; returns the first launch error.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int B, int H, int KH, int S, int Skv, int D, int causal,
    float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || S < 1 || Skv < 1 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return static_cast<int>(launch_dim<float>(D, q, k, v, o, lse, dout, dq,
                                              dk, dv, delta, B, H, KH, S, Skv,
                                              causal, scale, s));
  if (dtype == RT_BF16)
    return static_cast<int>(launch_dim<__nv_bfloat16>(
        D, q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, KH, S, Skv, causal,
        scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
