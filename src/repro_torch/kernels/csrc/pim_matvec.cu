// pim_matvec: weight-streaming GEMV  out = act(x @ W + bias).
//
// Replaces the TPU kernel repro/kernels/pim_matvec.py::pim_matvec (_kernel).
// Bound on an H100: the bytes of W. At decode the token batch x has n <= 8
// rows, so the product does 2n FLOPs per weight element read -- far below
// the ~295 FLOP/byte the card needs before compute matters. Design: each
// block owns a slab of output columns and streams those columns of W once,
// every row read as 128 contiguous bytes (8 threads x one 16-byte load);
// the block's 32 row lanes walk d_in in k-tiles while the tile's x columns
// sit in shared memory as f32. Partial sums stay in registers, reduce by
// warp shuffles and one shared-memory pass, and the bias + activation
// epilogue runs once on the f32 sum. Edges of d_in and d_out are masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColGroups = 8;                  // 8 x 16 B = one 128 B line of a W row
constexpr int kRowLanes = kThreads / kColGroups;
constexpr int kTileK = 128;                    // rows of W per shared x tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;                    // rows of x per launch

enum { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2 };

__device__ __forceinline__ float activate(float s, int act) {
  if (act == ACT_GELU) {  // tanh form, as jax.nn.gelu's default
    return 0.5f * s * (1.f + tanhf(0.7978845608028654f * (s + 0.044715f * s * s * s)));
  }
  if (act == ACT_SILU) return s / (1.f + expf(-s));
  return s;
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
pim_matvec_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ out, int n,
                  int d_in, int d_out, int act, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int SLAB = kColGroups * VEC;       // output columns per block
  __shared__ float xs[NMAX][kTileK];
  __shared__ float red[kWarps][NMAX][SLAB];

  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int rl = tid / kColGroups;
  const int slab0 = blockIdx.x * SLAB;
  const int col0 = slab0 + cg * VEC;

  float acc[NMAX][VEC];
#pragma unroll
  for (int i = 0; i < NMAX; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d_in; k0 += kTileK) {
    const int kt = min(kTileK, d_in - k0);
    __syncthreads();  // the previous tile's reads of xs are done
    for (int e = tid; e < NMAX * kTileK; e += kThreads) {
      const int i = e / kTileK, kk = e % kTileK;
      xs[i][kk] = (i < n && kk < kt) ? rt_to_f32(x[(size_t)i * d_in + k0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int kk = rl; kk < kt; kk += kRowLanes) {
      const T* wrow = w + (size_t)(k0 + kk) * d_out;
      float wv[VEC];
      if (vec_ok && col0 + VEC <= d_out) {
        const uint4 raw = *reinterpret_cast<const uint4*>(wrow + col0);
        const T* p = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) wv[j] = rt_to_f32(p[j]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          wv[j] = (col0 + j < d_out) ? rt_to_f32(wrow[col0 + j]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NMAX; ++i) {
        const float xv = xs[i][kk];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
      }
    }
  }

  // sum the 4 row lanes of each warp (lanes 8 and 16 apart), then the warps
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < NMAX; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(RT_FULL_MASK, v, 8);
      v += __shfl_xor_sync(RT_FULL_MASK, v, 16);
      acc[i][j] = v;
    }
  if (lane < kColGroups) {
#pragma unroll
    for (int i = 0; i < NMAX; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[warp][i][cg * VEC + j] = acc[i][j];
  }
  __syncthreads();
  for (int e = tid; e < n * SLAB; e += kThreads) {
    const int i = e / SLAB, c = e % SLAB, col = slab0 + c;
    if (col >= d_out) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][i][c];
    if (bias != nullptr) s += rt_to_f32(bias[col]);
    out[(size_t)i * d_out + col] = rt_from_f32<T>(activate(s, act));
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, const void* bias,
                         void* out, int n, int d_in, int d_out, int act,
                         int vec_ok, cudaStream_t stream) {
  constexpr int SLAB = kColGroups * (16 / sizeof(T));
  const dim3 grid((d_out + SLAB - 1) / SLAB);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if (n <= 1)
    pim_matvec_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xp, wp, bp, op, n, d_in, d_out, act, vec_ok);
  else if (n <= 2)
    pim_matvec_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xp, wp, bp, op, n, d_in, d_out, act, vec_ok);
  else if (n <= 4)
    pim_matvec_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xp, wp, bp, op, n, d_in, d_out, act, vec_ok);
  else
    pim_matvec_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xp, wp, bp, op, n, d_in, d_out, act, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// x: (n, d_in), w: (d_in, d_out), bias: (d_out,) or null, out: (n, d_out),
// all contiguous and of one dtype; 1 <= n <= 8 rows per launch.
extern "C" int pim_matvec_launch(const void* x, const void* w,
                                 const void* bias, void* out, int n, int d_in,
                                 int d_out, int act, int dtype, int vec_ok,
                                 void* stream) {
  if (n < 1 || n > kMaxRows || d_in < 1 || d_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return static_cast<int>(launch_typed<float>(x, w, bias, out, n, d_in, d_out, act, vec_ok, s));
  if (dtype == RT_BF16)
    return static_cast<int>(launch_typed<__nv_bfloat16>(x, w, bias, out, n, d_in, d_out, act, vec_ok, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
