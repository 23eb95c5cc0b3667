// decode_attention: flash-decode of one query token per slot against the
// KV cache, masking positions >= lengths[b].
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_kernel).
//
// Bound on an H100 SXM: the bytes of K and V up to each row's length, at
// 3.35 TB/s (llama3.2-1b's B 8 x KH 8 x D 64 cache at lengths 1..1024 is
// 7.5 MB, 0.0023 ms); at G = 4 grouped heads a cache byte feeds 2 FLOPs.
// What keeps a kernel from it is parallelism and latency, not arithmetic:
// one CTA per (KV head, batch row) gives 64 CTAs on 132 SMs at B 8, each
// walking a whole row alone.
//
// Design (flash-decoding):
//  * The grid is (splits, KH x head groups, B). A head group is up to 16
//    of the G query heads that share a KV head (mma's M), so K/V bytes are
//    read once per group and G is not capped. The `splits` CTAs of one
//    (head group, KV head, row) form a thread-block cluster (splits <= 8,
//    chosen by kernels/decode_attention.py::plan). Each CTA reads
//    lengths[b] itself and takes its share of [0, len): ceil(len / splits)
//    keys rounded up to the 64-key tile (decode_attention.py::share is the
//    same arithmetic). A CTA whose share is empty still reaches both
//    cluster barriers and contributes the neutral partial (m = -inf, l = 0).
//  * Loads: 64-key tiles of K and V come in as they are stored (bf16, or
//    f32 on the float32 route) by 16-byte cp.async into a ring (3 stages in
//    bf16, 2 ahead of the product; 2 in f32), with L2's evict-first policy
//    (a step reads each cache byte once). Rows are padded by 16 bytes
//    so that ldmatrix reads 8 keys without bank conflicts. Keys past the
//    share are zero-filled, so garbage past a row's length never enters.
//  * Products (bf16): mma.sync.m16n8k16 on the tensor cores, each warp
//    taking 16 keys of a tile. S = Q K^T with the group's heads as A rows
//    (q fragments loaded once into registers, rows past the group zero)
//    and K from ldmatrix; P V with P from registers (the score fragment
//    packed to bf16 is the A fragment of the second product) and V by
//    ldmatrix.trans. The online softmax (max, rescale, sum) is in f32
//    registers; the accumulator is 16 x D f32 in registers per warp. So G
//    and D are bounded by neither shared memory nor a product of the two:
//    D in {16, 32, 64, 96, 112, 128, 160}, any G. The tensor cores were
//    taken over 8-element CUDA-core dot products because one form then
//    serves every G (granite-20b's 48 heads per KV head as well as G 4).
//  * float32 (the parity phases only) runs the same grid, split, ring and
//    combine, with the products on the CUDA cores in f32 at the same
//    fragment positions (q in shared memory, P through a per-warp tile).
//  * The combine, fixed order, no atomics: the 4 warps of a CTA merge
//    through shared memory in warp order, then every CTA of the cluster
//    merges the splits for a share of the outputs over distributed shared
//    memory in rank order:
//    o = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30). Two
//    calls on the same inputs give bitwise-equal outputs.
//  * The partial mode (lse != null, the sequence-sharded cache of layout B):
//    rank 0 of the cluster also writes each head's log-sum-exp of its
//    scaled scores, M + log(sum_s e^(m_s - M) l_s), which the combine has
//    in hand; a row of length 0 gets lse = -inf and o = 0 (every split's
//    neutral partial), so an empty shard adds nothing to a cross-shard
//    combine. Without lse the kernel takes the same path and writes o
//    alone.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // keys per tile: 16 per warp
constexpr int kHeads = 16;       // query heads per CTA (mma's M)
constexpr int kMaxSplits = 8;    // portable cluster size

template <typename T, int D>
struct DShape {
  static constexpr bool kMma = sizeof(T) == 2;
  static constexpr int kStages = kMma ? 3 : 2;
  static constexpr int kVec = 16 / sizeof(T);    // elements per chunk
  static constexpr int kDP = D + kVec;           // padded row, elements
  static constexpr size_t kTileBytes = (size_t)kTile * kDP * sizeof(T);
  static constexpr size_t kRingBytes = (size_t)kStages * 2 * kTileBytes;
  static constexpr size_t kQBytes = kMma ? 0 : (size_t)kHeads * D * 4;
  static constexpr size_t kPBytes = kMma ? 0 : (size_t)kWarps * 16 * 16 * 4;
  // one partial: m and l per head, then acc (kHeads x D), f32
  static constexpr int kPart = 2 * kHeads + kHeads * D;
  static constexpr size_t kWtsBytes = (size_t)(kMaxSplits + 1) * kHeads * 4;
  static constexpr size_t kSmem =
      kRingBytes + kQBytes + kPBytes + (size_t)kPart * 4 + kWtsBytes;
  // the 4 warps' partials go to the ring once the loads are done
  static_assert((size_t)kWarps * kPart * 4 <= kRingBytes, "ring too small");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ o,
                        float* __restrict__ lse, int H, int KH, int S,
                        float scale) {
  using DS = DShape<T, D>;
  constexpr int kDP = DS::kDP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + DS::kRingBytes);
  float* ps = reinterpret_cast<float*>(smem + DS::kRingBytes + DS::kQBytes);
  float* part = reinterpret_cast<float*>(smem + DS::kRingBytes + DS::kQBytes +
                                         DS::kPBytes);
  float* wts = part + DS::kPart;        // [kMaxSplits][kHeads], then den
  float* den = wts + kMaxSplits * kHeads;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int G = H / KH, groups = (G + kHeads - 1) / kHeads;
  const int kh = blockIdx.y / groups, hg = blockIdx.y % groups;
  const int b = blockIdx.z;
  const int h0 = kh * G + hg * kHeads;          // first head of the group
  const int gc = min(kHeads, G - hg * kHeads);  // heads in the group
  const int len = min(max(lengths[b], 0), S);
  const int per = ((len + splits - 1) / splits + kTile - 1) / kTile * kTile;
  const int lo = min(len, rank * per), hi = min(len, lo + per);
  const int ntiles = (hi - lo + kTile - 1) / kTile;
  const size_t head = ((size_t)b * KH + kh) * (size_t)S * D;
  const T* kb = k + head;
  const T* vb = v + head;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;        // fragment row, column pair
  const int j8 = lane / 8, r8 = lane % 8;       // ldmatrix matrix, row
  const int key0 = warp * 16;                   // the warp's keys in a tile

  // q: A fragments in registers (bf16), or shared memory (f32)
  uint32_t qa[DS::kMma ? D / 16 : 1][4];
  if constexpr (DS::kMma) {
    const T* q0 = q + ((size_t)b * H + h0 + g) * D + 2 * t4;
    const T* q8 = q0 + 8 * D;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks * 16;
      qa[ks][0] = g < gc ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
      qa[ks][1] = g + 8 < gc ? *reinterpret_cast<const uint32_t*>(q8 + c) : 0u;
      qa[ks][2] = g < gc ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
      qa[ks][3] = g + 8 < gc ? *reinterpret_cast<const uint32_t*>(q8 + c + 8) : 0u;
    }
  } else {
    for (int e = tid; e < kHeads * D; e += kThreads)
      qs[e] = e / D < gc ? rt_to_f32(q[((size_t)b * H + h0) * D + e]) : 0.f;
  }

  const uint64_t policy = rt_evict_first();   // the cache is read once
  auto load = [&](int t) {
    T* kt = ring + (t % DS::kStages) * 2 * kTile * kDP;
    T* vt = kt + kTile * kDP;
    const int base = lo + t * kTile;
    constexpr int cpr = D / DS::kVec;            // 16-byte chunks per row
    for (int e = tid; e < 2 * kTile * cpr; e += kThreads) {
      const int which = e / (kTile * cpr), rem = e % (kTile * cpr);
      const int r = rem / cpr, c = rem % cpr, key = base + r;
      const bool ok = key < hi;
      const T* src = (which ? vb : kb) + (size_t)key * D + c * DS::kVec;
      rt_cp_async16((which ? vt : kt) + r * kDP + c * DS::kVec, ok ? src : kb,
                    ok, policy);
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

#pragma unroll
  for (int s = 0; s < DS::kStages - 1; ++s) {
    if (s < ntiles) load(s);
    rt_cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    rt_cp_async_wait<DS::kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + DS::kStages - 1 < ntiles) load(t + DS::kStages - 1);
    rt_cp_async_commit();
    const T* kt = ring + (t % DS::kStages) * 2 * kTile * kDP;
    const T* vt = kt + kTile * kDP;

    // scores of the warp's 16 keys: s[n-tile][fragment]
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (DS::kMma) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t bk[4];
        rt_ldmatrix_x4(bk, kt + (key0 + (j8 >> 1) * 8 + r8) * kDP + ks * 16 +
                               (j8 & 1) * 8);
        rt_mma_bf16_16816(s[0], qa[ks], bk[0], bk[1]);
        rt_mma_bf16_16816(s[1], qa[ks], bk[2], bk[3]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* qr = qs + (g + (c >> 1) * 8) * D;
          const T* kr = kt + (key0 + nt * 8 + 2 * t4 + (c & 1)) * kDP;
          float d = 0.f;
#pragma unroll 8
          for (int dd = 0; dd < D; ++dd) d = fmaf(qr[dd], rt_to_f32(kr[dd]), d);
          s[nt][c] = d;
        }
    }
    // scale, mask past the share, online softmax over the 4 lanes of a row
    const int kbase = lo + t * kTile + key0 + 2 * t4;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = kbase + nt * 8 + (c & 1) < hi;
        s[nt][c] = in ? s[nt][c] * scale : -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[nt][c]);
      }
    float base[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(RT_FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(RT_FULL_MASK, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
      corr[r] = expf(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = expf(s[nt][c] - base[c >> 1]);
        l[c >> 1] += s[nt][c];
      }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nd][c] *= corr[c >> 1];

    // acc += P V
    if constexpr (DS::kMma) {
      const uint32_t pa[4] = {rt_pack_bf16(s[0][0], s[0][1]),
                              rt_pack_bf16(s[0][2], s[0][3]),
                              rt_pack_bf16(s[1][0], s[1][1]),
                              rt_pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t bv[4];
        rt_ldmatrix_x4_trans(bv, vt + (key0 + (j8 & 1) * 8 + r8) * kDP +
                                     (nd + (j8 >> 1)) * 8);
        rt_mma_bf16_16816(acc[nd], pa, bv[0], bv[1]);
        rt_mma_bf16_16816(acc[nd + 1], pa, bv[2], bv[3]);
      }
    } else {
      float* pw = ps + warp * 256;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pw[(g + (c >> 1) * 8) * 16 + nt * 8 + 2 * t4 + (c & 1)] = s[nt][c];
      __syncwarp();
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* pr = pw + (g + (c >> 1) * 8) * 16;
          const T* vc = vt + key0 * kDP + nd * 8 + 2 * t4 + (c & 1);
          float a = acc[nd][c];
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) a = fmaf(pr[jj], rt_to_f32(vc[jj * kDP]), a);
          acc[nd][c] = a;
        }
      __syncwarp();
    }
  }
  rt_cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' partials

  // each warp's partial (rows g and g + 8), l summed over the row's lanes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(RT_FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(RT_FULL_MASK, l[r], 2);
  }
  float* wp = reinterpret_cast<float*>(ring);
  float* mine = wp + warp * DS::kPart;
  if (t4 == 0) {
    mine[g] = m[0];
    mine[g + 8] = m[1];
    mine[kHeads + g] = l[0];
    mine[kHeads + g + 8] = l[1];
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      mine[2 * kHeads + (g + (c >> 1) * 8) * D + nd * 8 + 2 * t4 + (c & 1)] =
          acc[nd][c];
  __syncthreads();
  // the CTA's partial: the warps merged in warp order
  if (tid < kHeads) {
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wp[w * DS::kPart + tid]);
    float lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = M == -INFINITY ? 0.f : expf(wp[w * DS::kPart + tid] - M);
      wts[w * kHeads + tid] = e;
      lsum += e * wp[w * DS::kPart + kHeads + tid];
    }
    part[tid] = M;
    part[kHeads + tid] = lsum;
  }
  __syncthreads();
  for (int e = tid; e < gc * D; e += kThreads) {
    const int row = e / D;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w)
      a += wts[w * kHeads + row] * wp[w * DS::kPart + 2 * kHeads + e];
    part[2 * kHeads + e] = a;
  }
  cluster.sync();  // every split's partial is in its shared memory

  // merge the splits in rank order: every rank weighs the heads, then
  // writes a share of the outputs (the loads of one all issued first);
  // the loops run to kMaxSplits unrolled, so nothing is indexed at run time
  if (tid < gc) {
    float pm[kMaxSplits], M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      pm[r] = r < splits ? cluster.map_shared_rank(part, r)[tid] : -INFINITY;
      M = fmaxf(M, pm[r]);
    }
    float lsum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r >= splits) break;
      const float e = M == -INFINITY ? 0.f : expf(pm[r] - M);
      wts[r * kHeads + tid] = e;
      lsum += e * cluster.map_shared_rank(part, r)[kHeads + tid];
    }
    den[tid] = fmaxf(lsum, 1e-30f);
    if (lse != nullptr && rank == 0)
      lse[(size_t)b * H + h0 + tid] = lsum > 0.f ? M + logf(lsum) : -INFINITY;
  }
  __syncthreads();
  const int total = gc * D, mine_n = (total + splits - 1) / splits;
  for (int e = rank * mine_n + tid; e < min(total, (rank + 1) * mine_n);
       e += kThreads) {
    const int row = e / D;
    float pv[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      pv[r] = r < splits ? cluster.map_shared_rank(part, r)[2 * kHeads + e] : 0.f;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) a += wts[r * kHeads + row] * pv[r];
    o[((size_t)b * H + h0) * D + e] = rt_from_f32<T>(a / den[row]);
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
}

template <typename T, int D>
cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       const int* lengths, void* o, float* lse, int B, int H,
                       int KH, int S, float scale, int splits,
                       cudaStream_t stream) {
  using DS = DShape<T, D>;
  auto kern = decode_attention_kernel<T, D>;
  static cudaError_t configured = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DS::kSmem);
  if (configured != cudaSuccess) return configured;
  const int groups = (H / KH + kHeads - 1) / kHeads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KH * groups, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = DS::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v),
                            lengths, static_cast<T*>(o), lse, H, KH, S, scale);
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* lengths, void* o, float* lse, int B, int H,
                         int KH, int S, int D, float scale, int splits,
                         cudaStream_t s) {
#define RT_DECODE_CASE(DIM) \
  case DIM:                 \
    return launch_dim<T, DIM>(q, k, v, lengths, o, lse, B, H, KH, S, scale, splits, s);
  switch (D) {
    RT_DECODE_CASE(16)
    RT_DECODE_CASE(32)
    RT_DECODE_CASE(64)
    RT_DECODE_CASE(96)
    RT_DECODE_CASE(112)
    RT_DECODE_CASE(128)
    RT_DECODE_CASE(160)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_DECODE_CASE
}

}  // namespace

// q, o: (B, H, D); k, v: (B, KH, S, D); lengths: (B,) int32; lse: null,
// or (B, H) f32 for the partial mode; all contiguous; k and v 16-byte
// aligned, q 4-byte aligned. D in {16, 32, 64, 96, 112, 128, 160},
// H % KH == 0; 1 <= splits <= 8 CTAs per (head group, KV head, row), one
// cluster (kernels/decode_attention.py::plan).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* o, void* lse, int B, int H,
                                       int KH, int S, int D, float scale,
                                       int dtype, int splits, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || S < 1 || B > 65535 ||
      splits < 1 || splits > kMaxSplits ||
      (long long)KH * ((H / KH + kHeads - 1) / kHeads) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lp = static_cast<const int*>(lengths);
  float* ls = static_cast<float*>(lse);
  if (dtype == RT_F32)
    return static_cast<int>(launch_typed<float>(q, k, v, lp, o, ls, B, H, KH, S, D, scale, splits, s));
  if (dtype == RT_BF16)
    return static_cast<int>(launch_typed<__nv_bfloat16>(q, k, v, lp, o, ls, B, H, KH, S, D, scale, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
