// The Hopper pieces that the tensor-core attention kernels share
// (flash_attention.cu's forward and flash_attention_bwd.cu's backward):
// a plain mbarrier arrive, TMA loads of a box of a 3-d tensor map, the
// wgmma shared-memory descriptors with swizzle, the bf16 wgmma products
// with f32 accumulators, and the encoder of the (columns, rows, heads)
// tensor maps they read their tiles through. The mbarrier init, expect-tx
// and wait, and the bf16 pair packing, are common.cuh's.
#pragma once
#include "common.cuh"

// rows a wgmma tile has (its M), and rows a tensor-map box holds
constexpr int kRtWgRows = 64;
// scores are taken in log2 units, for exp2f
constexpr float kRtLog2e = 1.4426950408889634f;

__device__ __forceinline__ void rt_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// a box of a 3-d tensor map (columns, rows, heads) into shared memory,
// completing on the mbarrier `bar`
__device__ __forceinline__ void rt_tma_load_3d(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int col, int row,
                                               int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets, and the swizzle of rows of `row_bytes` (128: B128, 64: B64, 32:
// B32), as the TMA wrote them.
__device__ __forceinline__ uint64_t rt_smem_desc(uint32_t addr, uint32_t lead,
                                                 uint32_t stride,
                                                 int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void rt_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void rt_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void rt_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of wgmma's registers across the
// asynchronous product
template <int N>
__device__ __forceinline__ void rt_fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for register A operands: they stay live (and unchanged) until
// the wait that follows the products reading them
template <int N>
__device__ __forceinline__ void rt_fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// moves registers between the warpgroups of a warp-specialized kernel:
// each thread of the (whole) warpgroup that runs it ends with N; ptxas
// compiles the code after it, to the end of its branch, for N
template <int N>
__device__ __forceinline__ void rt_setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void rt_setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

#define RT_F8(d, i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] (shared, K-major) * B[16 x 64] (shared,
// K-major); 32 f32 a thread. Element i of d sits at row
// 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) +
// i % 2 -- the A-operand layout of a register-A product (rt_wgmma_rs)
__device__ __forceinline__ void rt_wgmma_ss_n64(float* d, uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] (registers) * B[16 x N] (shared, MN-major)
template <int N>
__device__ __forceinline__ void rt_wgmma_rs(float* d, const uint32_t* a,
                                            uint64_t db);

template <>
__device__ __forceinline__ void rt_wgmma_rs<16>(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : RT_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void rt_wgmma_rs<32>(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void rt_wgmma_rs<64>(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef RT_F8

// (D, rows, heads) bf16 at `base`: rows D elements apart, heads
// head_stride elements apart; boxes of min(D, 64) columns x 64 rows x 1
// head, swizzled by their row of min(D, 64) * 2 bytes (128B, 64B or 32B);
// rows past `rows` and columns past D read as zeros. A (64 x D) tile lands
// as one box (D <= 64) or D / 64 boxes side by side, each row r's 16-byte
// chunk c at r * row + ((c ^ r % 8) % (row / 16)) * 16 -- the layout the
// wgmma descriptors name.
inline bool rt_encode_map_3d(CUtensorMap* map, const void* base, int D,
                             long long rows, long long heads,
                             long long head_stride) {
  const RtEncodeTiled encode = rt_encode_tiled();
  if (!encode) return false;
  const int box_cols = D < 64 ? D : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)head_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)kRtWgRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
