// mamba_chunk_bwd: the gradient of the Mamba selective scan from a zero
// state.
//
// Replaces no TPU kernel: the reference differentiates mamba_mix's scan
// (repro/models/ssm.py, chunked_linear_scan) with XLA. On the card the
// forward it differentiates is the hand-written csrc/mamba_chunk.cu, so
// its gradient is this kernel. The forward, per batch row b, channel c and
// state index s (h_{-1} = 0):
//
//   h_t[c, s] = a_t[c, s] * h_{t-1}[c, s] + u_t[c, s]
//   y_t[c]    = sum_s h_t[c, s] * C_t[s]
//
// Its adjoint, with g_t the gradient of h_t (g_{T-1} adds dh_T):
//
//   g_t     = dy_t[c] * C_t[s] + a_{t+1} * g_{t+1}
//   da_t    = g_t * h_{t-1};   du_t = g_t
//   dC_t[s] = sum_c h_t[c, s] * dy_t[c]
//
// a = exp(dt A) underflows to 0, so h_{t-1} is never recovered as
// (h_t - u_t) / a_t: it is checkpointed and recomputed.
//
// Design: the forward's layout, one thread per (b, c, s) element in a
// register, a channel's n states in a group of G lanes (G = n rounded up
// to a power of two). The forward kernel, run under a gradient, has
// written h before every 16 steps (ck, B x ceil(T/16) x d x n f32), so
// this kernel walks once, in reverse, reading a and u once: for each
// stretch of 16 steps from the last, a thread loads its 16 steps of a, u
// and dy, recomputes the stretch's states in registers from the
// checkpoint, takes dC's products h_t dy_t, and runs g down the stretch,
// writing da and du. dC sums over the d channels in a fixed order: over a
// warp's channels by shuffles, over the block's 8 warps through shared
// memory, into one partial a block and step (B x blocks x T x n f32),
// which a second kernel adds over the blocks in order. That second kernel
// stays: a cluster (at most 8 portable blocks, 128 of jamba's 8,192
// channels) could sum only part of the channels in distributed shared
// memory and would still leave a pass over the clusters, for 0.08 ms of
// partials' bytes at jamba's shape. No atomics: two calls give the same
// bits.
//
// Bound on an H100: bytes. At jamba-v0.1-52b's training shape (B 2, T
// 2048, d 8192, n 16, f32) a, u, da and du are 2.15 GB each, C, dC, dy
// small: 8.7 GB, 2.60 ms at 3.35 TB/s, against 0.04 ms of flops. This
// kernel moves those once, plus the checkpoints (0.13 GB) and dC's
// partials (0.13 GB each way); a backward that made its own checkpoints
// would read a and u twice.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCk = 16;      // steps between checkpoints (mamba_chunk.cu)

// two blocks an SM (128 registers) where the groups are narrower than a
// warp; a 32-lane group (d_state above 16, on no model's path) would
// spill there
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, G < 32 ? 2 : 1)
mamba_chunk_bwd_kernel(const T* __restrict__ a, const T* __restrict__ u,
                       const T* __restrict__ C, const T* __restrict__ dy,
                       const float* __restrict__ dh,
                       const float* __restrict__ ck, T* __restrict__ da,
                       T* __restrict__ du, float* __restrict__ dc_part,
                       int steps, int d, int n) {
  // dC's per-warp sums of a stretch, two stretches in turn, so that one
  // barrier a stretch separates a buffer's writes from its readers
  __shared__ float red[2][kWarps][kCk][G];
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = blk * kThreads + tid;
  const int ch = gid / G, s = gid % G;
  const bool live = ch < d && s < n;
  const size_t dn = static_cast<size_t>(d) * n;
  const int dn32 = d * n;      // a stretch's offsets, 16 dn, fit an int
  const size_t elem = static_cast<size_t>(live ? ch : 0) * n + (live ? s : 0);
  const size_t base = static_cast<size_t>(b) * steps * dn + elem;
  const T* cb = C + static_cast<size_t>(b) * steps * n + (live ? s : 0);
  const T* yb = dy + static_cast<size_t>(b) * steps * d + (live ? ch : 0);
  const int nck = (steps + kCk - 1) / kCk;
  const float* ckb = ck + static_cast<size_t>(b) * nck * dn + elem;
  float* pb = dc_part + (static_cast<size_t>(b) * nblk + blk) * steps * n;

  float g = dh != nullptr && live
      ? dh[static_cast<size_t>(b) * dn + elem] : 0.f;
  float a_next = 1.f;
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kCk, buf = c & 1;
    const T* ap = a + base + t0 * dn;
    const T* up = u + base + t0 * dn;
    const T* yp = yb + static_cast<size_t>(t0) * d;
    const T* cp = cb + static_cast<size_t>(t0) * n;
    // the stretch's inputs, all loads in flight at once: a, u, dy and
    // C (padded steps decay by 1 and add nothing)
    float av[kCk], hist[kCk + 1], yv[kCk], fv[kCk];
    hist[0] = live ? ckb[static_cast<size_t>(c) * dn] : 0.f;
#pragma unroll
    for (int i = 0; i < kCk; ++i) {
      const int t = t0 + i;
      const bool ok = live && t < steps;
      av[i] = ok ? rt_to_f32(ap[i * dn32]) : 1.f;
      hist[i + 1] = ok ? rt_to_f32(up[i * dn32]) : 0.f;
      yv[i] = ok ? rt_to_f32(yp[i * d]) : 0.f;
      fv[i] = ok ? rt_to_f32(cp[i * n]) : 0.f;
    }
    // the stretch's states, h_{t-1} = hist[i] and h_t = hist[i + 1]; dC's
    // products summed over the warp's channels; g's forcing dy_t C_t
#pragma unroll
    for (int i = 0; i < kCk; ++i) {
      hist[i + 1] = av[i] * hist[i] + hist[i + 1];
      float p = hist[i + 1] * yv[i];
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
        p += __shfl_xor_sync(RT_FULL_MASK, p, o);
      if (lane < G) red[buf][warp][i][lane] = p;
      fv[i] *= yv[i];
    }
    // g down the stretch
    T* dap = da + base + t0 * dn;
    T* dup = du + base + t0 * dn;
#pragma unroll
    for (int i = kCk - 1; i >= 0; --i) {
      if (!live || t0 + i >= steps) continue;
      g = fv[i] + a_next * g;
      dap[i * dn32] = rt_from_f32<T>(g * hist[i]);
      dup[i * dn32] = rt_from_f32<T>(g);
      a_next = av[i];
    }
    __syncthreads();
    const int m = min(kCk, steps - t0);
    for (int e = tid; e < m * n; e += kThreads) {
      const int i = e / n, q = e % n;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += red[buf][w][i][q];
      pb[static_cast<size_t>(t0 + i) * n + q] = acc;
    }
  }
}

// dC[b][t][s] = sum over the blocks of dc_part[b][blk][t][s], in order
template <typename T>
__global__ void mamba_dc_kernel(const float* __restrict__ dc_part,
                                T* __restrict__ dC, int B, int steps, int n,
                                int nblk) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
  const size_t per_b = static_cast<size_t>(steps) * n;
  if (idx >= B * per_b) return;
  const size_t b = idx / per_b, r = idx % per_b;
  const float* p = dc_part + b * nblk * per_b + r;
  float acc = 0.f;
  for (int blk = 0; blk < nblk; ++blk) acc += p[blk * per_b];
  dC[idx] = rt_from_f32<T>(acc);
}

template <typename T, int G>
cudaError_t launch_typed(const void* a, const void* u, const void* C,
                         const void* dy, const float* dh, const float* ck,
                         void* da, void* du, void* dC, float* dc_part, int B,
                         int steps, int d, int n, cudaStream_t stream) {
  const long long threads = static_cast<long long>(d) * G;
  const int nblk = static_cast<int>((threads + kThreads - 1) / kThreads);
  mamba_chunk_bwd_kernel<T, G><<<dim3(nblk, B), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u),
      static_cast<const T*>(C), static_cast<const T*>(dy), dh, ck,
      static_cast<T*>(da), static_cast<T*>(du), dc_part, steps, d, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outs = static_cast<long long>(B) * steps * n;
  mamba_dc_kernel<T><<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                       stream>>>(dc_part, static_cast<T*>(dC), B, steps, n,
                                 nblk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_group(const void* a, const void* u, const void* C,
                         const void* dy, const float* dh, const float* ck,
                         void* da, void* du, void* dC, float* dc_part, int B,
                         int steps, int d, int n, cudaStream_t s) {
#define RT_MAMBA_BWD(G)                                                    \
  return launch_typed<T, G>(a, u, C, dy, dh, ck, da, du, dC, dc_part, B,  \
                            steps, d, n, s)
  if (n <= 1) RT_MAMBA_BWD(1);
  if (n <= 2) RT_MAMBA_BWD(2);
  if (n <= 4) RT_MAMBA_BWD(4);
  if (n <= 8) RT_MAMBA_BWD(8);
  if (n <= 16) RT_MAMBA_BWD(16);
  RT_MAMBA_BWD(32);
#undef RT_MAMBA_BWD
}

}  // namespace

// a, u: (B, T, d, n); C: (B, T, n); dy: (B, T, d), all of dtype; dh: (B,
// d, n) f32 or null; ck: (B, ceil(T/16), d, n) f32, h before every 16
// steps as mamba_chunk_launch writes it. Out: da, du (B, T, d, n) and dC
// (B, T, n) of dtype. Scratch: dc_part (B, ceil(d G / 256), T, n) f32 (G:
// n rounded up to a power of two). All contiguous; 1 <= n <= 32, T >= 1,
// 1 <= B <= 65535.
extern "C" int mamba_chunk_bwd_launch(const void* a, const void* u,
                                      const void* C, const void* dy,
                                      const void* dh, const void* ck,
                                      void* da, void* du, void* dC,
                                      void* dc_part, int B, int steps, int d,
                                      int n, int dtype, void* stream) {
  if (B < 1 || B > 65535 || steps < 1 || d < 1 || n < 1 || n > 32
      || ck == nullptr || static_cast<long long>(d) * n * kCk > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *dhf = static_cast<const float*>(dh),
              *ckf = static_cast<const float*>(ck);
  float* part = static_cast<float*>(dc_part);
  if (dtype == RT_F32)
    return static_cast<int>(launch_group<float>(
        a, u, C, dy, dhf, ckf, da, du, dC, part, B, steps, d, n, s));
  if (dtype == RT_BF16)
    return static_cast<int>(launch_group<__nv_bfloat16>(
        a, u, C, dy, dhf, ckf, da, du, dC, part, B, steps, d, n, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
