// decode_attention: flash-decode of one query token per slot against the
// KV cache, masking positions >= lengths[b].
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_kernel). Bound on an H100: the bytes of K and V up to each row's length
// (2 FLOPs per byte at G = 4 grouped heads). Design: one block per
// (kv-head, batch row) holding that kv-head's G query heads (head h reads
// kv-head h // G), so every K/V byte is read once for all G heads. The
// block streams 32-position tiles of K and V through shared memory as f32
// and loops only to lengths[b], which replaces the TPU kernel's skip of
// blocks past the valid prefix; the tile that holds the length is masked,
// so S need not be a multiple of the tile. Per head, one warp folds the
// tile's scores into the running max and sum (online softmax in f32).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;      // one score per lane in the softmax pass
constexpr int kMaxGD = 1024;   // G * D per block (q and accumulator in smem)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ o,
                        int H, int KH, int S, float scale) {
  constexpr int kMaxG = kMaxGD / D;
  __shared__ float ks[kTile][D + 1];  // padded: a warp reads one column
  __shared__ float vs[kTile][D];
  __shared__ float qs[kMaxGD];
  __shared__ float accs[kMaxGD];
  __shared__ float ss[kMaxG * kTile];
  __shared__ float ms[kMaxG], ls[kMaxG], cs[kMaxG];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH, GD = G * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // heads kh*G .. kh*G + G - 1 are contiguous rows of q (B, H, D)
  const size_t qrow = ((size_t)b * H + (size_t)kh * G) * D;
  for (int e = tid; e < GD; e += kThreads) {
    qs[e] = rt_to_f32(q[qrow + e]) * scale;
    accs[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = RT_NEG_INF;
    ls[g] = 0.f;
  }
  const int len = min(max(lengths[b], 0), S);
  const size_t head = ((size_t)b * KH + kh) * (size_t)S * D;
  const T* kb = k + head;
  const T* vb = v + head;

  for (int t0 = 0; t0 < len; t0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D, c = e % D, j = t0 + r;
      const bool in = j < len;
      ks[r][c] = in ? rt_to_f32(kb[(size_t)j * D + c]) : 0.f;
      vs[r][c] = in ? rt_to_f32(vb[(size_t)j * D + c]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile, j = e % kTile;
      float d = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) d = fmaf(qs[g * D + c], ks[j][c], d);
      ss[e] = (t0 + j < len) ? d : RT_NEG_INF;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      const float sv = ss[g * kTile + lane];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, rt_warp_max(sv));
      const float p = expf(sv - m_new);
      ss[g * kTile + lane] = p;
      const float psum = rt_warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < GD; e += kThreads) {
      const int g = e / D, c = e % D;
      float a = accs[e] * cs[g];
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) a = fmaf(ss[g * kTile + j], vs[j][c], a);
      accs[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < GD; e += kThreads)
    o[qrow + e] = rt_from_f32<T>(accs[e] / fmaxf(ls[e / D], 1e-30f));
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* lengths, void* o, int B, int H, int KH,
                         int S, int D, float scale, cudaStream_t stream) {
  const dim3 grid(KH, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
#define RT_DECODE_CASE(DIM)                                                   \
  case DIM:                                                                   \
    decode_attention_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(           \
        qp, kp, vp, lengths, op, H, KH, S, scale);                            \
    break;
  switch (D) {
    RT_DECODE_CASE(16)
    RT_DECODE_CASE(32)
    RT_DECODE_CASE(64)
    RT_DECODE_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_DECODE_CASE
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, H, D); k, v: (B, KH, S, D); lengths: (B,) int32; all
// contiguous. D in {16, 32, 64, 128}; (H / KH) * D <= 1024.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* o, int B, int H, int KH, int S,
                                       int D, float scale, int dtype,
                                       void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || S < 1 || B > 65535 ||
      (H / KH) * D > kMaxGD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lp = static_cast<const int*>(lengths);
  if (dtype == RT_F32)
    return static_cast<int>(launch_typed<float>(q, k, v, lp, o, B, H, KH, S, D, scale, s));
  if (dtype == RT_BF16)
    return static_cast<int>(launch_typed<__nv_bfloat16>(q, k, v, lp, o, B, H, KH, S, D, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
