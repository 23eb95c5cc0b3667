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
// Bound on an H100: operations, not bytes. At the full-sequence prefill of
// rwkv6-7b (BH 128, T 2048, K 64) the inputs are 168 MB with r, k, v in
// bf16 (0.05 ms at 3.35 TB/s), but the pairwise decay ratios need one exp
// per (i, j<i, c): C(C-1)/2 * K = 129,024 per chunk, 0.53e9 in all (the TPU
// kernel computes the full C*C*K square, 1.07e9, and masks half), on the
// SFUs, beside about 3.5 * C * C * K FMAs per chunk for the products.
//
// Design: one block per (b, h) row, which walks its chunks in order (the
// TPU grid's sequential chunk axis becomes a loop inside the block), with
// the K x K f32 state in shared memory across chunks. A chunk's r, k, v,
// log-decays and the C x C attention tile sit in shared memory as f32,
// rows padded to K + 1 floats so that a warp reading one column across 32
// rows hits 32 banks. Threads own a column (j, or the value channel) and
// every fourth row, so each product reads one operand as a broadcast and
// the other as consecutive words. r, k and v are read once, as bf16 or f32;
// w is f32 (decays near 1 would round to 1 in bf16). The ragged last chunk
// is masked in the kernel: rows past T load r = k = v = 0 and log w = 0,
// so they add nothing to y or the state. Simple first: the products run on
// the CUDA cores in f32 and the exps use the accurate expf.
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
    return static_cast<int>(launch_typed<__nv_bfloat16, float>(r, k, v, w, u, y, s_out, BH, T, K, u_rows, s));
  if (in_dtype == RT_F32 && out_dtype == RT_BF16)
    return static_cast<int>(launch_typed<float, __nv_bfloat16>(r, k, v, w, u, y, s_out, BH, T, K, u_rows, s));
  if (in_dtype == RT_BF16 && out_dtype == RT_BF16)
    return static_cast<int>(launch_typed<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, y, s_out, BH, T, K, u_rows, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
