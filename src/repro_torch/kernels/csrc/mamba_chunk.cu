// mamba_chunk: the Mamba selective scan from a zero state.
//
// Replaces the TPU kernel repro/kernels/mamba_chunk.py::mamba_chunk
// (_kernel). Per batch row b, channel c and state index s:
//
//   h_t[c, s] = a_t[c, s] * h_{t-1}[c, s] + u_t[c, s],   h_0 = 0
//   y_t[c]    = sum_s h_t[c, s] * C_t[s]
//
// and h_T is returned beside y.
//
// Bound on an H100: bytes. At jamba-v0.1-52b's full-sequence prefill
// (B 2, T 2048, d 8192, n 16, f32) a and u are 2.15 GB each and y 0.13 GB:
// 4.43 GB, 1.32 ms at 3.35 TB/s, against 2.1 GFLOP (0.03 ms in f32).
//
// Design: the TPU grid walks (B, d tiles, chunks) with the chunk axis
// innermost so that the (d_tile, n) state stays in VMEM. On the H100 each
// state element is independent, so one thread owns one h element in a
// register and walks t = 0 .. T-1; no block waits for another. A channel's
// n states sit in a group of G lanes (G = n rounded up to a power of two,
// at most 32), so neighbouring threads read neighbouring (c, s) elements
// of a_t and u_t and the loads coalesce; C_t[s] is one small broadcast
// read. y_t[c] is a shuffle sum over the group, written by its first lane.
// Each thread loads kUnroll steps of a and u before it uses them, so that
// many loads are in flight at once. Lanes past n (or past d) carry h = 0
// and write nothing; steps past T multiply by 1 and add 0. At the main
// shape that is 262,144 threads, 1,024 blocks of 256 for 132 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
mamba_chunk_kernel(const T* __restrict__ a, const T* __restrict__ u,
                   const T* __restrict__ C, T* __restrict__ y,
                   float* __restrict__ h_out, int steps, int d, int n) {
  const int b = blockIdx.y;
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  const int ch = gid / G;                   // channel
  const int s = gid % G;                    // state index
  const bool live = ch < d && s < n;
  const size_t dn = static_cast<size_t>(d) * n;
  const size_t base = static_cast<size_t>(b) * steps * dn
                      + static_cast<size_t>(live ? ch : 0) * n
                      + (live ? s : 0);
  const T* cb = C + static_cast<size_t>(b) * steps * n + (live ? s : 0);
  T* yb = y + static_cast<size_t>(b) * steps * d + (ch < d ? ch : 0);
  const bool writer = s == 0 && ch < d;
  float h = 0.f;
  for (int t0 = 0; t0 < steps; t0 += kUnroll) {
    float av[kUnroll], uv[kUnroll], cv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 + i;
      const bool ok = live && t < steps;
      av[i] = ok ? rt_to_f32(a[base + t * dn]) : 1.f;
      uv[i] = ok ? rt_to_f32(u[base + t * dn]) : 0.f;
      cv[i] = ok ? rt_to_f32(cb[static_cast<size_t>(t) * n]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = av[i] * h + uv[i];
      float p = h * cv[i];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(RT_FULL_MASK, p, o);
      if (writer && t0 + i < steps)
        yb[static_cast<size_t>(t0 + i) * d] = rt_from_f32<T>(p);
    }
  }
  if (live) h_out[(static_cast<size_t>(b) * d + ch) * n + s] = h;
}

template <typename T, int G>
cudaError_t launch_typed(const void* a, const void* u, const void* C,
                         void* y, void* h_out, int B, int steps, int d, int n,
                         cudaStream_t stream) {
  const long long threads = static_cast<long long>(d) * G;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  mamba_chunk_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u),
      static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(h_out), steps, d, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_group(const void* a, const void* u, const void* C,
                         void* y, void* h_out, int B, int steps, int d, int n,
                         cudaStream_t s) {
  if (n <= 1) return launch_typed<T, 1>(a, u, C, y, h_out, B, steps, d, n, s);
  if (n <= 2) return launch_typed<T, 2>(a, u, C, y, h_out, B, steps, d, n, s);
  if (n <= 4) return launch_typed<T, 4>(a, u, C, y, h_out, B, steps, d, n, s);
  if (n <= 8) return launch_typed<T, 8>(a, u, C, y, h_out, B, steps, d, n, s);
  if (n <= 16) return launch_typed<T, 16>(a, u, C, y, h_out, B, steps, d, n, s);
  return launch_typed<T, 32>(a, u, C, y, h_out, B, steps, d, n, s);
}

}  // namespace

// a, u: (B, T, d, n) of dtype; C: (B, T, n) of dtype; y: (B, T, d) of
// dtype; h_out: (B, d, n) f32. All contiguous; 1 <= n <= 32, T >= 1,
// 1 <= B <= 65535.
extern "C" int mamba_chunk_launch(const void* a, const void* u, const void* C,
                                  void* y, void* h_out, int B, int steps,
                                  int d, int n, int dtype, void* stream) {
  if (B < 1 || B > 65535 || steps < 1 || d < 1 || n < 1 || n > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return static_cast<int>(
        launch_group<float>(a, u, C, y, h_out, B, steps, d, n, s));
  if (dtype == RT_BF16)
    return static_cast<int>(
        launch_group<__nv_bfloat16>(a, u, C, y, h_out, B, steps, d, n, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
