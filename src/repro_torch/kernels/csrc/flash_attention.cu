// flash_attention: blocked GQA attention with an online softmax, in two
// masking modes of one kernel template.
//
// Static mode: causal, queries at global positions [q_offset, q_offset + S)
// against keys [0, Skv) (the chunked serving-prefill case). Replaces the TPU
// kernel repro/kernels/flash_attention.py::flash_attention in its static
// q_offset mode (_kernel). Bound on an H100: operations --
// 4 * B * H * S * Skv_eff * D FLOPs over a few MB of q/k/v.
//
// Segmented mode (SEG): the packed-prefill mask. Replaces the TPU kernel's
// segment_info mode (_kernel_segmented). A query attends a key iff
// q_seg == kv_seg && q_pos >= kv_pos, from four int32 arrays of shape
// (B, S) and (B, Skv), read per batch row for all of its KV heads (the TPU
// kernel repeats them per head). There is no static causal frontier, so
// every KV tile runs, as on the TPU. Keys past Skv at the ragged tile edge
// are left out entirely (probability 0, not a -1e30 score), so a query that
// matches no key (padding, q_seg -2) averages exactly the Skv real keys, as
// the plain version does. Bound at the packed main path's largest shape
// (R 8 lanes, C 128, Skv = prefix span 512 + 128, H 32 / KH 8, D 64,
// bf16): 4 * 8 * 32 * 128 * 640 * 64 = 5.4 GFLOP if every pair counted,
// 0.0054 ms at 989 TFLOP/s; 19 MB of q/k/v/o, 0.0056 ms at 3.35 TB/s. So
// bytes and operations bound it about equally, and only the tensor cores
// could reach either.
//
// Design (both modes): this first version runs the products on the CUDA
// cores in f32, not the tensor cores (wgmma is later work), so it sits far
// above that bound. One block per (query tile of 32 rows, head, batch row);
// four threads share a query row, each owning every fourth dimension of q
// and of the f32 accumulator, so a warp's shared-memory reads of a key row
// hit four distinct banks and are broadcast across rows. The block stages
// 32-key tiles of K and V in shared memory as f32 (and, in SEG mode, the
// tile's key positions and segment ids beside them); scores never leave
// registers. The static mode loops only up to the causal frontier
// q_offset + (tile end), which replaces the TPU grid's block skip. Ragged S
// and Skv are masked in the kernel; masked scores are -1e30 (not -inf) and
// the row sum is clamped at 1e-30, as in the TPU kernel, so padded query
// rows stay finite.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 32;
constexpr int kThreadsPerRow = kThreads / kRowsPerBlock;  // 4
constexpr int kTileKV = 32;
// -inf: the score of a key that takes no part (past Skv, segmented mode)
#define RT_EXCLUDED __int_as_float(static_cast<int>(0xff800000u))

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const int* __restrict__ q_pos_ids,
                       const int* __restrict__ q_seg_ids,
                       const int* __restrict__ kv_pos_ids,
                       const int* __restrict__ kv_seg_ids, int H, int KH,
                       int S, int Skv, long long kv_head_stride, int q_offset,
                       int causal, float scale) {
  constexpr int DT = D / kThreadsPerRow;
  __shared__ float ks[kTileKV][D];
  __shared__ float vs[kTileKV][D];
  __shared__ int kps[SEG ? kTileKV : 1];
  __shared__ int kss[SEG ? kTileKV : 1];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow, part = tid % kThreadsPerRow;
  const int qi = qt * kRowsPerBlock + row;
  const bool row_ok = qi < S;
  int q_pos = q_offset + qi, q_seg = 0;
  if (SEG) {
    const size_t ids = (size_t)b * S + (row_ok ? qi : 0);
    q_pos = q_pos_ids[ids];
    q_seg = row_ok ? q_seg_ids[ids] : -2;
  }

  const T* qp = q + (((size_t)b * H + h) * S + (row_ok ? qi : 0)) * D;
  float qr[DT], acc[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    qr[i] = rt_to_f32(qp[part + kThreadsPerRow * i]) * scale;
    acc[i] = 0.f;
  }
  float m = RT_NEG_INF, l = 0.f;

  int kv_end = Skv;
  if (!SEG && causal)
    kv_end = min(Skv, q_offset + min(S, (qt + 1) * kRowsPerBlock));
  const size_t head = (size_t)b * KH + kh;
  const T* kb = k + head * kv_head_stride;
  const T* vb = v + head * kv_head_stride;

  for (int t0 = 0; t0 < kv_end; t0 += kTileKV) {
    __syncthreads();  // the previous tile's reads are done
    for (int e = tid; e < kTileKV * D; e += kThreads) {
      const int r = e / D, c = e % D, j = t0 + r;
      const bool in = j < kv_end;
      ks[r][c] = in ? rt_to_f32(kb[(size_t)j * D + c]) : 0.f;
      vs[r][c] = in ? rt_to_f32(vb[(size_t)j * D + c]) : 0.f;
    }
    if (SEG && tid < kTileKV) {
      const int j = t0 + tid;
      kps[tid] = j < kv_end ? kv_pos_ids[(size_t)b * Skv + j] : 0;
      kss[tid] = j < kv_end ? kv_seg_ids[(size_t)b * Skv + j] : -1;
    }
    __syncthreads();

    float s[kTileKV];
    float tmax = RT_NEG_INF;
#pragma unroll
    for (int j = 0; j < kTileKV; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DT; ++i) d = fmaf(qr[i], ks[j][part + kThreadsPerRow * i], d);
      d += __shfl_xor_sync(RT_FULL_MASK, d, 1);
      d += __shfl_xor_sync(RT_FULL_MASK, d, 2);
      if (SEG) {
        const bool keep = kss[j] == q_seg && kps[j] <= q_pos;
        // a key past Skv takes no part at all: exp(-inf - m) = 0
        s[j] = t0 + j >= kv_end ? RT_EXCLUDED : (keep ? d : RT_NEG_INF);
      } else {
        const int kv_pos = t0 + j;
        const bool keep = kv_pos < kv_end && (!causal || kv_pos <= q_pos);
        s[j] = keep ? d : RT_NEG_INF;
      }
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTileKV; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kTileKV; ++j)
#pragma unroll
      for (int i = 0; i < DT; ++i)
        acc[i] = fmaf(s[j], vs[j][part + kThreadsPerRow * i], acc[i]);
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + (((size_t)b * H + h) * S + qi) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      op[part + kThreadsPerRow * i] = rt_from_f32<T>(acc[i] / denom);
  }
}

template <typename T, bool SEG>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         const int* const* ids, int B, int H, int KH, int S,
                         int Skv, int D, long long kv_head_stride,
                         int q_offset, int causal, float scale,
                         cudaStream_t stream) {
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
#define RT_FLASH_CASE(DIM)                                                    \
  case DIM:                                                                   \
    flash_attention_kernel<T, DIM, SEG><<<grid, kThreads, 0, stream>>>(       \
        qp, kp, vp, op, ids[0], ids[1], ids[2], ids[3], H, KH, S, Skv,        \
        kv_head_stride, q_offset, causal, scale);                             \
    break;
  switch (D) {
    RT_FLASH_CASE(16)
    RT_FLASH_CASE(32)
    RT_FLASH_CASE(64)
    RT_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_FLASH_CASE
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, H, S, D) contiguous; k, v: (B, KH, Skv, D) with rows of D
// contiguous elements and kv_head_stride elements between heads (a prefix
// slice of a longer cache row is taken without a copy). D in {16, 32, 64,
// 128}; H a multiple of KH. With q_pos null the static mode runs (q_offset,
// causal); otherwise the segmented mode, with q_pos/q_seg contiguous
// (B, S) and kv_pos/kv_seg contiguous (B, Skv) int32 arrays (q_offset and
// causal are then ignored).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int* q_pos, const int* q_seg,
                                      const int* kv_pos, const int* kv_seg,
                                      int B, int H, int KH, int S, int Skv,
                                      int D, long long kv_head_stride,
                                      int q_offset, int causal, float scale,
                                      int dtype, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || S < 1 || Skv < 1 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool seg = q_pos != nullptr;
  if (seg && (!q_seg || !kv_pos || !kv_seg))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ids[4] = {q_pos, q_seg, kv_pos, kv_seg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RT_FLASH_TYPED(TYPE)                                                  \
  err = seg ? launch_typed<TYPE, true>(q, k, v, o, ids, B, H, KH, S, Skv, D,  \
                                       kv_head_stride, q_offset, causal,      \
                                       scale, s)                              \
            : launch_typed<TYPE, false>(q, k, v, o, ids, B, H, KH, S, Skv, D, \
                                        kv_head_stride, q_offset, causal,     \
                                        scale, s);
  if (dtype == RT_F32) {
    RT_FLASH_TYPED(float)
  } else if (dtype == RT_BF16) {
    RT_FLASH_TYPED(__nv_bfloat16)
  }
#undef RT_FLASH_TYPED
  return static_cast<int>(err);
}
