// pim_matvec: weight-streaming GEMV  out = act(x @ W + bias).
//
// Replaces the TPU kernel repro/kernels/pim_matvec.py::pim_matvec (_kernel).
//
// Bound on an H100 SXM: the bytes of W. At decode the token batch x has
// n <= 8 rows (the engine decodes max_slots rows), so the product does 2n
// FLOPs per weight element read, far below the ~295 FLOP/byte at which the
// tensor cores and not the 3.35 TB/s of HBM become the limit: llama3.2-1b's
// 8192 -> 2048 is 33.6 MB of bf16 weights, 0.0100 ms. Reaching it takes
// (1) every SM streaming, (2) ~30 KB of loads in flight per SM to cover
// HBM's latency, and (3) arithmetic that costs nothing next to the bytes:
// at n = 8 a CUDA-core GEMV spends 8 FMAs plus a conversion per weight,
// about 40 % of the card's f32 FMA rate at 3.35 TB/s.
//
// Design. The grid is (splits, d_out / BN): a CTA owns BN output columns
// and one slice of d_in, and the `splits` CTAs of a column tile form one
// thread-block cluster (splits <= 8). kernels/pim_matvec.py::plan picks BN
// (128 down to 16 columns) and the split so that every served shape
// launches at least 256 CTAs, about two per SM.
//  * Loads: the CTA's slice of x (8 rows) comes in once, at the start.
//    W's tiles of TK rows x BN columns (8 KB: rows of BN * 2 bytes at stride
//    d_out) stream through a ring of 4 stages, 3 tiles ahead of the product
//    (24 KB in flight per CTA). In bf16 one thread issues every load by
//    TMA: each W tile as boxes of a 2-d tensor map (rows past d_in read as
//    zeros) completing on the stage's mbarrier, x as a bulk copy a row; the
//    other threads issue none. W's loads carry L2's evict-first policy: a
//    weight is read once a step, and streaming it then leaves L2 alone
//    (without it the kernel was at best as fast as torch.matmul). The TMA writes W's tile with its 128/64/32-
//    byte swizzle, the XOR pattern by which ldmatrix then reads it without
//    bank conflicts. W's tensor map is encoded at a weight's first call and
//    kept. (Tried on the way and dropped, PERF.md: 16-byte cp.async from
//    every thread, more stages, larger tiles, 256-column tiles, x loaded
//    with each tile; none was faster.)
//  * Product (bf16): mma.sync.m16n8k16 with W^T as A (16 output columns x
//    16 of d_in, ldmatrix.trans from the tile) and x^T as B (n = 8 is the
//    instruction's N; ldmatrix from the x slice; rows past n are zero),
//    f32 accumulators. The 4 warps split a tile's 16-column m-tiles, and
//    share one m-tile's k-steps where there are fewer than 4.
//  * Reduction, fixed order, no atomics: the warps that share an m-tile sum
//    through shared memory in warp order; then each CTA of the cluster
//    takes a share of the outputs, sums the splits' partials for it over
//    distributed shared memory in rank order, adds the bias, applies the
//    activation once and stores. (With rank 0 alone doing it, 8-row calls
//    ran slower than 1-row ones: one DSMEM latency per split and output.)
//    Two calls on the same inputs give bitwise-equal outputs.
//  * The plain-load route of the same kernel (TMA = false) fills the same
//    tiles by element loads (rows past the slice and x rows past n zero).
//    It takes float32 (the parity phases only; its product runs on the
//    CUDA cores in f32, as a TF32 product would miss the 1e-4 to which the
//    float32 paths are held) and any bf16 shape whose rows are not 16-byte
//    aligned (d_out or d_in not a multiple of 8, or an unaligned pointer).
//    The wrapper picks the route before the launch.
#include <cooperative_groups.h>
#include <cuda.h>

#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kTileBytes = 8192;   // one W tile: TK rows x BN columns
constexpr int kRows = 8;           // x rows per launch (mma's N)
constexpr int kMaxSplits = 8;      // portable cluster size
constexpr int kMaxSmem = 232448;   // an H100 CTA's shared memory

enum { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2 };

__device__ __forceinline__ float activate(float s, int act) {
  if (act == ACT_GELU) {  // tanh form, as jax.nn.gelu's default
    return 0.5f * s * (1.f + tanhf(0.7978845608028654f * (s + 0.044715f * s * s * s)));
  }
  if (act == ACT_SILU) return s / (1.f + expf(-s));
  return s;
}

template <typename T, int BN>
struct Shape {
  static constexpr bool kMma = sizeof(T) == 2;
  static constexpr int kVec = 16 / sizeof(T);        // elements per chunk
  static constexpr int kTK = kTileBytes / (BN * sizeof(T));  // tile rows
  static constexpr int kChunks = BN / kVec;          // chunks per tile row
  static constexpr int kBoxCols = BN < 64 ? BN : 64; // columns of a TMA box
  // bf16: 16-column m-tiles, a warp taking kMPW of them (BN > 64) or
  // sharing one with kGroups - 1 others, each on its own k-steps
  static constexpr int kMTiles = BN / 16;
  static constexpr int kMPW = kMma && kMTiles > kWarps ? kMTiles / kWarps : 1;
  // partial sums per CTA before the warps are summed: the bf16 route's
  // k-groups, the f32 route's row lanes
  static constexpr int kGroups =
      kMma ? (kMTiles >= kWarps ? 1 : kWarps / kMTiles) : kThreads / BN;
  static constexpr size_t kWBytes = (size_t)kStages * kTileBytes;
  static constexpr size_t kRedBytes = (size_t)kGroups * kRows * BN * 4;
  static constexpr size_t kPartBytes = (size_t)kRows * BN * 4;
  // 1 KB to align the W ring (TMA's swizzle), the ring, the partial sums,
  // the mbarriers (a stage's and x's); then x, whose size is the slice's
  static constexpr size_t kFixed =
      1024 + kWBytes + kRedBytes + kPartBytes + ((kStages + 1) * 8 + 15) / 16 * 16;
  static size_t smem(int slice) {
    return kFixed + (size_t)kRows * (slice + kVec) * sizeof(T);
  }
};

// Where chunk c (16 bytes) of W-tile row r lies, in elements from the
// tile's start. bf16 tiles are swizzled so that the 8 rows an ldmatrix
// reads (same chunk, rows r..r+7) fall in 8 distinct 16-byte bank groups:
// the pattern of TMA's 128-, 64- and 32-byte swizzles for rows of 128, 64
// and 32 bytes (the chunk's address bits XORed with those of the 128-byte
// line), so the TMA writes a tile the way ldmatrix reads it. Wider tiles
// are boxes of 64 columns side by side, each swizzled alone.
template <typename T, int BN>
__device__ __forceinline__ int w_offset(int r, int c) {
  using S = Shape<T, BN>;
  if constexpr (!S::kMma) {
    return r * BN + c * S::kVec;
  } else if constexpr (BN > 64) {
    return (c / 8) * S::kTK * 64 + r * 64 + ((c % 8) ^ (r % 8)) * 8;
  } else {
    constexpr int rows_per_line = 8 / S::kChunks;   // rows in 128 bytes
    return r * BN + (c ^ ((r / rows_per_line) % S::kChunks)) * 8;
  }
}

// TMA: the tiles arrive by TMA (bf16, aligned); else by element loads.
template <typename T, int BN, bool TMA>
__global__ void __launch_bounds__(kThreads)
pim_matvec_kernel(const __grid_constant__ CUtensorMap wmap,
                  const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ out, int n,
                  int d_in, int d_out, int act, int slice) {
  using S = Shape<T, BN>;
  constexpr int TK = S::kTK, VEC = S::kVec;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (rt_smem_addr(smem_raw) & 1023)) & 1023);
  T* wbuf = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + S::kWBytes);
  float* part = red + S::kGroups * kRows * BN;
  const uint32_t bar0 = rt_smem_addr(part + kRows * BN);  // 8 bytes a stage
  const uint32_t xbar = bar0 + 8 * kStages;
  T* xs = reinterpret_cast<T*>(smem + S::kFixed - 1024);  // (kRows, XS)
  const int XS = slice + VEC;   // x row stride: one chunk of padding

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int col0 = blockIdx.y * BN;
  const int k_begin = rank * slice;
  const int klen = min(d_in, k_begin + slice) - k_begin;   // rows of W
  const int ntiles = (klen + TK - 1) / TK;
  const int kpad = ntiles * TK;            // x columns the tiles read
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // bf16: warp -> (m-tiles mt + i * kWarps, k-group); f32: thread ->
  // (column, row lane)
  const int mt = warp % S::kMTiles, kgrp = warp / S::kMTiles;
  float acc[S::kMPW][S::kMma ? 4 : kRows];
#pragma unroll
  for (int mi = 0; mi < S::kMPW; ++mi)
#pragma unroll
    for (int i = 0; i < (S::kMma ? 4 : kRows); ++i) acc[mi][i] = 0.f;

  // W tile t into its stage: by thread 0 as TMA boxes, or by the threads
  // (rows past the slice and columns past d_out zero)
  auto issue = [&](int t) {
    T* wt = wbuf + (t % kStages) * TK * BN;
    const int k0 = k_begin + t * TK;
    if constexpr (TMA) {
      const uint32_t bar = bar0 + 8 * (t % kStages);
      rt_mbar_expect_tx(bar, kTileBytes);
#pragma unroll
      for (int b = 0; b < BN / S::kBoxCols; ++b)
        rt_tma_load_2d(rt_smem_addr(wt + b * TK * S::kBoxCols), &wmap, bar,
                       col0 + b * S::kBoxCols, k0, rt_evict_first());
    } else {
      for (int e = tid; e < TK * S::kChunks; e += kThreads) {
        const int r = e / S::kChunks, c = e % S::kChunks;
        const int kg = k0 + r, cg0 = col0 + c * VEC;
        T* dst = wt + w_offset<T, BN>(r, c);
        const T* src = w + (size_t)kg * d_out + cg0;
        const bool row_ok = r < klen - t * TK;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          dst[j] = row_ok && cg0 + j < d_out ? src[j] : rt_from_f32<T>(0.f);
      }
    }
  };

  // x's slice, once: rows past n and columns past the slice's rows zero
  // (W's rows there read as zeros, but garbage could hold a NaN)
  if constexpr (TMA) {
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&wmap) : "memory");
      for (int s = 0; s < kStages; ++s) rt_mbar_init(bar0 + 8 * s, 1);
      rt_mbar_init(xbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      rt_mbar_expect_tx(xbar, n * klen * (int)sizeof(T));
      for (int i = 0; i < n; ++i)
        rt_bulk_load(rt_smem_addr(xs + i * XS), x + (size_t)i * d_in + k_begin,
                     klen * (int)sizeof(T), xbar);
      for (int s = 0; s < kStages - 1 && s < ntiles; ++s) issue(s);
    }
    for (int e = tid; e < kRows * (kpad / VEC); e += kThreads) {
      const int i = e / (kpad / VEC), c = (e % (kpad / VEC)) * VEC;
      if (i >= n || c >= klen)
        *reinterpret_cast<uint4*>(xs + i * XS + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = tid; e < kRows * (kpad / VEC); e += kThreads) {
      const int i = e / (kpad / VEC), c = (e % (kpad / VEC)) * VEC;
      const T* src = x + (size_t)i * d_in + k_begin + c;
      T* dst = xs + i * XS + c;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        dst[j] = i < n && c + j < klen ? src[j] : rt_from_f32<T>(0.f);
    }
    for (int s = 0; s < kStages - 1 && s < ntiles; ++s) issue(s);
  }
  __syncthreads();  // the barriers' init, x and (plain) the first tiles
  if constexpr (TMA) rt_mbar_wait(xbar, 0);

  for (int t = 0; t < ntiles; ++t) {
    if constexpr (TMA) rt_mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    const int nt = t + kStages - 1;
    if (nt < ntiles && (!TMA || tid == 0)) issue(nt);
    const T* wt = wbuf + (t % kStages) * TK * BN;
    const T* xt = xs + t * TK;
    if constexpr (S::kMma) {
      constexpr int kSteps = TK / 16;
      const int j = lane / 8, r8 = lane % 8;
#pragma unroll
      for (int ks = kgrp; ks < kSteps; ks += S::kGroups) {
        const int row = ks * 16 + r8 + (j >> 1) * 8;
        uint32_t b[2];
        rt_ldmatrix_x2(b, xt + r8 * XS + ks * 16 + (j & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < S::kMPW; ++mi) {
          uint32_t a[4];
          const int c = (mt + mi * kWarps) * 2 + (j & 1);
          rt_ldmatrix_x4_trans(a, wt + w_offset<T, BN>(row, c));
          rt_mma_bf16_16816(acc[mi], a, b[0], b[1]);
        }
      }
    } else {
      const int m = tid % BN;
      for (int r = tid / BN; r < TK; r += S::kGroups) {
        const float wv = rt_to_f32(wt[r * BN + m]);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[0][i] = fmaf(rt_to_f32(xt[i * XS + r]), wv, acc[0][i]);
      }
    }
  }

  // this CTA's partial (kRows x BN), summed over its groups in order
  if constexpr (S::kMma) {
    const int i = 2 * (lane % 4);
    float* g = red + kgrp * kRows * BN;
#pragma unroll
    for (int mi = 0; mi < S::kMPW; ++mi) {
      const int m = (mt + mi * kWarps) * 16 + lane / 4;
      g[i * BN + m] = acc[mi][0];
      g[(i + 1) * BN + m] = acc[mi][1];
      g[i * BN + m + 8] = acc[mi][2];
      g[(i + 1) * BN + m + 8] = acc[mi][3];
    }
  } else {
    float* g = red + (tid / BN) * kRows * BN;
#pragma unroll
    for (int i = 0; i < kRows; ++i) g[i * BN + tid % BN] = acc[0][i];
  }
  __syncthreads();
  for (int e = tid; e < kRows * BN; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < S::kGroups; ++g) s += red[g * kRows * BN + e];
    part[e] = s;
  }
  cluster.sync();  // every split's partial is in its shared memory
  // each rank sums a share of the outputs over the splits, in rank order
  // (the loads of an output all issued before its adds)
  const float* parts[kMaxSplits];
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r)
    parts[r] = cluster.map_shared_rank(part, r < splits ? r : 0);
  const int total = n * BN, per = (total + splits - 1) / splits;
  for (int e = rank * per + tid; e < min(total, (rank + 1) * per);
       e += kThreads) {
    const int i = e / BN, col = col0 + e % BN;
    if (col >= d_out) continue;
    float v[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) v[r] = r < splits ? parts[r][e] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) s += v[r];
    if (bias != nullptr) s += rt_to_f32(bias[col]);
    out[(size_t)i * d_out + col] = rt_from_f32<T>(activate(s, act));
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
}

// W's tensor map for the bf16 route: (d_out columns, d_in rows), boxes of
// min(BN, 64) x TK, swizzled by their row of min(BN, 64) * 2 bytes. A decode step calls each
// weight with the same map, so maps are encoded once and kept, keyed by
// the weight's address and shape (a map holds nothing else): the host's
// cost per call is one lookup.
struct MapKey {
  const void* w;
  int d_in, d_out, bn;
  bool operator==(const MapKey& o) const {
    return w == o.w && d_in == o.d_in && d_out == o.d_out && bn == o.bn;
  }
};
struct MapHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.w) ^ ((size_t)k.d_in << 20) ^
           ((size_t)k.d_out << 40) ^ (size_t)k.bn;
  }
};

bool w_map(CUtensorMap* map, const void* w, int d_in, int d_out, int bn,
           int tk) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapHash> maps;
  const MapKey key{w, d_in, d_out, bn};
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  const RtEncodeTiled encode = rt_encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d_out, (cuuint64_t)d_in};
  const cuuint64_t strides[1] = {(cuuint64_t)d_out * 2};
  const int box_cols = bn < 64 ? bn : 64;
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)tk};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (maps.size() >= 4096) maps.clear();   // freed weights' entries
  maps.emplace(key, *map);
  return true;
}

template <typename T, int BN, bool TMA>
cudaError_t launch_shape(const void* x, const void* w, const void* bias,
                         void* out, int n, int d_in, int d_out, int act,
                         int splits, int slice, cudaStream_t stream) {
  using S = Shape<T, BN>;
  // a TMA box must not reach into the next split's rows; x's slice and
  // the ring must fit
  const size_t smem = S::smem(slice);
  if (slice % S::kTK != 0 || smem > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (TMA && !w_map(&map, w, d_in, d_out, BN, S::kTK))
    return cudaErrorInvalidValue;
  auto kern = pim_matvec_kernel<T, BN, TMA>;
  // once per process: the port drives one card
  static cudaError_t configured = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (configured != cudaSuccess) return configured;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (d_out + BN - 1) / BN, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, map, static_cast<const T*>(x),
                            static_cast<const T*>(w),
                            static_cast<const T*>(bias), static_cast<T*>(out),
                            n, d_in, d_out, act, slice);
}

template <typename T, bool TMA>
cudaError_t launch_route(const void* x, const void* w, const void* bias,
                         void* out, int n, int d_in, int d_out, int act,
                         int bn, int splits, int slice, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {   // the tensor-core route's wide tile
    if (bn == 128)
      return launch_shape<T, 128, TMA>(x, w, bias, out, n, d_in, d_out, act, splits, slice, s);
  }
  switch (bn) {
    case 64:
      return launch_shape<T, 64, TMA>(x, w, bias, out, n, d_in, d_out, act, splits, slice, s);
    case 32:
      return launch_shape<T, 32, TMA>(x, w, bias, out, n, d_in, d_out, act, splits, slice, s);
    case 16:
      return launch_shape<T, 16, TMA>(x, w, bias, out, n, d_in, d_out, act, splits, slice, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, const void* bias,
                         void* out, int n, int d_in, int d_out, int act,
                         int vec, int bn, int splits, int slice,
                         cudaStream_t s) {
  if (vec && sizeof(T) == 2)
    return launch_route<T, true>(x, w, bias, out, n, d_in, d_out, act, bn, splits, slice, s);
  return launch_route<T, false>(x, w, bias, out, n, d_in, d_out, act, bn, splits, slice, s);
}

}  // namespace

// x: (n, d_in), w: (d_in, d_out), bias: (d_out,) or null, out: (n, d_out),
// all contiguous and of one dtype; 1 <= n <= 8 rows per launch. The plan
// (kernels/pim_matvec.py::plan): bn output columns per CTA, `splits` CTAs
// per column tile (one cluster), each over `slice` rows of d_in (a
// multiple of the tile's rows; the slices cover d_in, none empty). vec:
// bf16 rows and pointers 16-byte aligned, so the TMA route may run.
extern "C" int pim_matvec_launch(const void* x, const void* w,
                                 const void* bias, void* out, int n, int d_in,
                                 int d_out, int act, int dtype, int vec,
                                 int bn, int splits, int slice, void* stream) {
  if (bn != 16 && bn != 32 && bn != 64 && bn != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || n > kRows || d_in < 1 || d_out < 1 || splits < 1 ||
      splits > kMaxSplits || slice < 16 || slice % 16 != 0 ||
      (long long)slice * splits < d_in || (long long)slice * (splits - 1) >= d_in ||
      (d_out + bn - 1) / bn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return static_cast<int>(launch_typed<float>(x, w, bias, out, n, d_in, d_out, act, vec, bn, splits, slice, s));
  if (dtype == RT_BF16)
    return static_cast<int>(launch_typed<__nv_bfloat16>(x, w, bias, out, n, d_in, d_out, act, vec, bn, splits, slice, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
