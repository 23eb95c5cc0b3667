// rwkv_chunk_bwd: the gradient of the RWKV6 wkv from a zero state.
//
// Replaces no TPU kernel: the reference differentiates its wkv
// (repro/models/ssm.py::_wkv_scan) with XLA. On the card the forward it
// differentiates is the hand-written csrc/rwkv_chunk.cu, so its gradient
// is this kernel. The forward, per row bh and step t (K x K state S,
// k-major, S_{-1} = 0):
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Its adjoint runs over G_t, the gradient of S_t (G_{T-1} = dS_T):
//
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T
//   dr_t[i] = sum_j (S_{t-1}[i,j] + u_i k_t[i] v_t[j]) dy_t[j]
//   dk_t[i] = sum_j G_t[i,j] v_t[j] + u_i r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i,j] k_t[i] + dy_t[j] sum_i r_t[i] u_i k_t[i]
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   = sum_t r_t[i] k_t[i] (v_t . dy_t)
//
// Every element (i, j) of S and of G is a scalar recurrence of its own
// (S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j]); the rows and columns
// meet only in the sums above. dw needs S_{t-1} and G_t at once, the one
// walking forward and the other back. The decays run from about 2e-24 to
// 1 - 4.5e-5 a step, so S_{t-1} is never recovered from S_t by dividing
// by w_t (nor by any product of decays, as chunked forms do): it is
// checkpointed and recomputed.
//
// Design: one block of 256 threads per row bh; each thread owns 16
// elements of S and G in registers (rows ig*4 .. ig*4+3, columns jg, jg+16,
// jg+32, jg+48 with ig = tid / 16, jg = tid % 16). The block walks the
// steps in sub-chunks of 8, staged in shared memory in f32:
//  * forward: it writes S before each sub-chunk to a checkpoint in device
//    memory (scratch of BH x ceil(T/8) x 16 KB), and takes dr and du on the
//    way (they need only S_{t-1});
//  * reverse, sub-chunk by sub-chunk from the last: it reloads the
//    checkpoint, walks the 8 steps forward again keeping each S_{t-1} in
//    a shared-memory slot of its own, then walks them back with G, taking
//    dk, dw and dv.
// The sums over j (dr, dk, dw) run over the 16 lanes of a half-warp by
// shuffles; the sums over i (dv) over the two half-warps by a shuffle and
// over the 8 warps through shared memory; du over a row's steps in each
// thread, over the block's threads and, where rows share u[bh % U], over
// those rows in a second small kernel. Every sum is taken in a fixed
// order, with no atomics: two calls give the same bits.
//
// Bound on an H100: operations. At rwkv6-7b's full-sequence training
// shape (BH 128, T 2048, K 64; r, k, v bf16, w and dy f32) it reads 235 MB
// and writes 168 MB (dr, dk, dv bf16, dw f32): 0.12 ms at 3.35 TB/s; the
// recurrences take 14 flops an element of S a step (the state and G
// advanced, 3 each; S dy, G v, G^T k and G * S, 2 each), 15.0 GFLOP: 0.22
// ms at the f32 rate of 67 TFLOP/s. What holds it above that (PERF.md):
// one block per row puts 8 warps on an SM, each step is a chain of
// dependent FMAs and shuffles, the reverse walks every step twice, and the
// checkpoints add 1 GB of writes and reads.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK = 64;       // the state's width; K < 64 runs zero channels
constexpr int kSub = 8;      // steps staged at once, and between checkpoints
constexpr int kE = 16;       // state elements a thread owns (4 rows x 4 cols)
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == kSub, "warp s sums step s's dot products");

struct Smem {
  float r[kSub][kK], k[kSub][kK], v[kSub][kK], w[kSub][kK], dy[kSub][kK];
  float vdy[kSub];              // v_t . dy_t
  float ruk[kSub];              // sum_i r_t[i] u_i k_t[i]
  float u[kK];
  float red_a[kSub][kK];        // dr (forward) or dk (reverse): sums over j
  float red_w[kSub][kK];        // dw: sums over j
  float red_v[kWarps][kSub][kK];  // dv: each warp's sum over its 8 rows
  float du[kThreads / kK][kK];
  float hist[kSub][kE][kThreads];  // S_{t-1} of the sub-chunk's steps
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(RT_FULL_MASK, x, o);
  return x;
}

// Stage steps [t0, t0 + n) of r, k, v, w, dy as f32 (zero past n and K),
// then (after a barrier) warp s takes step s's two dot products.
template <typename Tin, typename Tdy>
__device__ void stage(Smem& sm, const Tin* r, const Tin* k, const Tin* v,
                      const float* w, const Tdy* dy, size_t base, int t0,
                      int n, int K) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kSub * kK; e += kThreads) {
    const int s = e / kK, c = e % kK;
    const bool ok = s < n && c < K;
    const size_t g = base + static_cast<size_t>(t0 + s) * K + c;
    sm.r[s][c] = ok ? rt_to_f32(r[g]) : 0.f;
    sm.k[s][c] = ok ? rt_to_f32(k[g]) : 0.f;
    sm.v[s][c] = ok ? rt_to_f32(v[g]) : 0.f;
    sm.w[s][c] = ok ? w[g] : 0.f;
    sm.dy[s][c] = ok ? rt_to_f32(dy[g]) : 0.f;
  }
  __syncthreads();
  const int s = tid / 32, lane = tid % 32;
  float vd = sm.v[s][lane] * sm.dy[s][lane]
             + sm.v[s][lane + 32] * sm.dy[s][lane + 32];
  float rk = sm.r[s][lane] * sm.u[lane] * sm.k[s][lane]
             + sm.r[s][lane + 32] * sm.u[lane + 32] * sm.k[s][lane + 32];
  vd = rt_warp_sum(vd);
  rk = rt_warp_sum(rk);
  if (lane == 0) {
    sm.vdy[s] = vd;
    sm.ruk[s] = rk;
  }
}

template <typename Tin, typename Tdy>
__global__ void __launch_bounds__(kThreads, 1)
rwkv_chunk_bwd_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                      const Tin* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const Tdy* __restrict__ dy,
                      const float* __restrict__ ds, Tin* __restrict__ dr,
                      Tin* __restrict__ dk, Tin* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_rows,
                      float* __restrict__ ck, int T, int K, int u_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int ig = tid / 16, jg = tid % 16, warp = tid / 32;
  const int nsub = (T + kSub - 1) / kSub;
  const size_t base = static_cast<size_t>(bh) * T * K;
  float* ckb = ck + static_cast<size_t>(bh) * nsub * kE * kThreads + tid;

  if (tid < kK)
    sm.u[tid] = tid < K ? u[static_cast<size_t>(bh % u_rows) * K + tid] : 0.f;
  float S[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) S[e] = 0.f;
  float du_acc = 0.f;

  // forward: checkpoints, dr and du
  for (int c = 0; c < nsub; ++c) {
    const int t0 = c * kSub, n = min(kSub, T - t0);
    __syncthreads();                        // the last sub-chunk is done
    stage(sm, r, k, v, w, dy, base, t0, n, K);
#pragma unroll
    for (int e = 0; e < kE; ++e)
      ckb[(static_cast<size_t>(c) * kE + e) * kThreads] = S[e];
    for (int s = 0; s < n; ++s) {
      const float4 kk = ld4(&sm.k[s][ig * 4]), ww = ld4(&sm.w[s][ig * 4]);
      const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
      const float wa[4] = {ww.x, ww.y, ww.z, ww.w};
      float vb[4], yb[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        vb[b] = sm.v[s][jg + 16 * b];
        yb[b] = sm.dy[s][jg + 16 * b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float p = 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) p += S[a * 4 + b] * yb[b];
        p = sum16(p);
        if (jg == 0) sm.red_a[s][ig * 4 + a] = p;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          S[a * 4 + b] = wa[a] * S[a * 4 + b] + ka[a] * vb[b];
      }
    }
    __syncthreads();
    for (int e = tid; e < n * kK; e += kThreads) {
      const int s = e / kK, i = e % kK;
      if (i >= K) continue;
      const float kv = sm.k[s][i] * sm.vdy[s];
      dr[base + static_cast<size_t>(t0 + s) * K + i] =
          rt_from_f32<Tin>(sm.red_a[s][i] + sm.u[i] * kv);
      du_acc += sm.r[s][i] * kv;
    }
  }
  // du of this row: each thread's steps, then the 4 threads of a channel
  sm.du[tid / kK][tid % kK] = du_acc;
  __syncthreads();
  if (tid < K)
    du_rows[static_cast<size_t>(bh) * K + tid] =
        sm.du[0][tid] + sm.du[1][tid] + sm.du[2][tid] + sm.du[3][tid];

  // reverse: dk, dv, dw, from G_{T-1} = dS_T
  float G[kE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = ig * 4 + a, j = jg + 16 * b;
      G[a * 4 + b] = ds != nullptr && i < K && j < K
          ? ds[(static_cast<size_t>(bh) * K + i) * K + j] : 0.f;
    }
  for (int c = nsub - 1; c >= 0; --c) {
    const int t0 = c * kSub, n = min(kSub, T - t0);
    __syncthreads();
    stage(sm, r, k, v, w, dy, base, t0, n, K);
    // S_{t-1} of each step, recomputed from the checkpoint; each thread
    // reads back only its own slots
#pragma unroll
    for (int e = 0; e < kE; ++e)
      S[e] = ckb[(static_cast<size_t>(c) * kE + e) * kThreads];
    for (int s = 0; s < n; ++s) {
      const float4 kk = ld4(&sm.k[s][ig * 4]), ww = ld4(&sm.w[s][ig * 4]);
      const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
      const float wa[4] = {ww.x, ww.y, ww.z, ww.w};
      float vb[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) vb[b] = sm.v[s][jg + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int e = a * 4 + b;
          sm.hist[s][e][tid] = S[e];
          S[e] = wa[a] * S[e] + ka[a] * vb[b];
        }
    }
    for (int s = n - 1; s >= 0; --s) {
      const float4 kk = ld4(&sm.k[s][ig * 4]), ww = ld4(&sm.w[s][ig * 4]);
      const float4 rr = ld4(&sm.r[s][ig * 4]);
      const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
      const float wa[4] = {ww.x, ww.y, ww.z, ww.w};
      const float ra[4] = {rr.x, rr.y, rr.z, rr.w};
      float vb[4], yb[4], pv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        vb[b] = sm.v[s][jg + 16 * b];
        yb[b] = sm.dy[s][jg + 16 * b];
        pv[b] = 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float pk = 0.f, pw = 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int e = a * 4 + b;
          pk += G[e] * vb[b];
          pw += G[e] * sm.hist[s][e][tid];
          pv[b] += G[e] * ka[a];
          G[e] = wa[a] * G[e] + ra[a] * yb[b];
        }
        pk = sum16(pk);
        pw = sum16(pw);
        if (jg == 0) {
          sm.red_a[s][ig * 4 + a] = pk;
          sm.red_w[s][ig * 4 + a] = pw;
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = pv[b] + __shfl_xor_sync(RT_FULL_MASK, pv[b], 16);
        if (tid % 32 < 16) sm.red_v[warp][s][jg + 16 * b] = p;
      }
    }
    __syncthreads();
    for (int e = tid; e < n * kK; e += kThreads) {
      const int s = e / kK, i = e % kK;
      if (i >= K) continue;
      const size_t g = base + static_cast<size_t>(t0 + s) * K + i;
      float sv = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) sv += sm.red_v[q][s][i];
      dk[g] = rt_from_f32<Tin>(sm.red_a[s][i]
                               + sm.u[i] * sm.r[s][i] * sm.vdy[s]);
      dv[g] = rt_from_f32<Tin>(sv + sm.dy[s][i] * sm.ruk[s]);
      dw[g] = sm.red_w[s][i];
    }
  }
}

// du[q][i] = sum over m of du_rows[m * U + q][i], m in order: the rows
// bh that take u[bh % U]
__global__ void rwkv_du_kernel(const float* __restrict__ du_rows,
                               float* __restrict__ du, int BH, int K, int U) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= U * K) return;
  float acc = 0.f;
  for (int m = 0; m < BH / U; ++m)
    acc += du_rows[static_cast<size_t>(m) * U * K + idx];
  du[idx] = acc;
}

template <typename Tin, typename Tdy>
cudaError_t launch_typed(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const void* dy,
                         const float* ds, void* dr, void* dk, void* dv,
                         float* dw, float* du, float* du_rows, float* ck,
                         int BH, int T, int K, int U, cudaStream_t stream) {
  auto kernel = rwkv_chunk_bwd_kernel<Tin, Tdy>;
  static cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (configured != cudaSuccess) return configured;
  kernel<<<BH, kThreads, sizeof(Smem), stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), w, u, static_cast<const Tdy*>(dy), ds,
      static_cast<Tin*>(dr), static_cast<Tin*>(dk), static_cast<Tin*>(dv),
      dw, du_rows, ck, T, K, U);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rwkv_du_kernel<<<(U * K + 255) / 256, 256, 0, stream>>>(du_rows, du, BH,
                                                          K, U);
  return cudaGetLastError();
}

}  // namespace

// r, k, v: (BH, T, K) of in_dtype; w: (BH, T, K) f32; u: (U, K) f32 with
// BH % U == 0; dy: (BH, T, K) of dy_dtype; ds: (BH, K, K) f32 or null.
// Out: dr, dk, dv (BH, T, K) of in_dtype; dw (BH, T, K) f32; du (U, K)
// f32. Scratch: du_rows (BH, K) f32 and ck (BH, ceil(T/8), 16, 256) f32.
// All contiguous; 1 <= K <= 64, T >= 1.
extern "C" int rwkv_chunk_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* dy, const void* ds, void* dr, void* dk,
    void* dv, void* dw, void* du, void* du_rows, void* ck, int BH, int T,
    int K, int U, int in_dtype, int dy_dtype, void* stream) {
  if (BH < 1 || T < 1 || K < 1 || K > kK || U < 1 || BH % U)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *wf = static_cast<const float*>(w),
              *uf = static_cast<const float*>(u),
              *dsf = static_cast<const float*>(ds);
  float *dwf = static_cast<float*>(dw), *duf = static_cast<float*>(du),
        *rows = static_cast<float*>(du_rows), *ckf = static_cast<float*>(ck);
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == RT_F32 && dy_dtype == RT_F32)
    err = launch_typed<float, float>(r, k, v, wf, uf, dy, dsf, dr, dk, dv,
                                     dwf, duf, rows, ckf, BH, T, K, U, s);
  else if (in_dtype == RT_BF16 && dy_dtype == RT_F32)
    err = launch_typed<__nv_bfloat16, float>(r, k, v, wf, uf, dy, dsf, dr,
                                             dk, dv, dwf, duf, rows, ckf, BH,
                                             T, K, U, s);
  else if (in_dtype == RT_BF16 && dy_dtype == RT_BF16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        r, k, v, wf, uf, dy, dsf, dr, dk, dv, dwf, duf, rows, ckf, BH, T, K,
        U, s);
  else if (in_dtype == RT_F32 && dy_dtype == RT_BF16)
    err = launch_typed<float, __nv_bfloat16>(r, k, v, wf, uf, dy, dsf, dr, dk,
                                             dv, dwf, duf, rows, ckf, BH, T,
                                             K, U, s);
  return static_cast<int>(err);
}
