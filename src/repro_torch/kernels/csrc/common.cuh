// Shared helpers of the port's CUDA kernels: f32 <-> storage-type
// conversion, warp reductions, the PTX of the Hopper kernels, the
// tensor-map encoder, and the plain C error interface that the Python
// wrappers read through ctypes.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_NEG_INF (-1e30f)
#define RT_FULL_MASK 0xffffffffu

enum { RT_F32 = 0, RT_BF16 = 1 };

__device__ __forceinline__ float rt_to_f32(float x) { return x; }
__device__ __forceinline__ float rt_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T rt_from_f32(float x);
template <>
__device__ __forceinline__ float rt_from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 rt_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float rt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(RT_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float rt_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(RT_FULL_MASK, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Hopper/Ampere PTX used by the decode-path kernels (pim_matvec,
// decode_attention): L2 policies, 16-byte cp.async with zero fill,
// ldmatrix, the bf16 tensor-core product mma.sync.m16n8k16 with an f32
// accumulator, mbarriers and TMA loads.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t rt_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An L2 policy for data read once: its lines go first, so that streaming
// it does not evict (and write back) what L2 holds for others.
__device__ __forceinline__ uint64_t rt_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// Copy 16 bytes to shared memory under an L2 policy (rt_evict_first), or
// write 16 zero bytes when !valid (the source address is then not read).
__device__ __forceinline__ void rt_cp_async16(void* dst, const void* src,
                                              bool valid, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(
          rt_smem_addr(dst)),
      "l"(src), "r"(valid ? 16 : 0), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void rt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void rt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void rt_ldmatrix_x4(uint32_t (&r)[4],
                                               const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(rt_smem_addr(p)));
}

__device__ __forceinline__ void rt_ldmatrix_x4_trans(uint32_t (&r)[4],
                                                     const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(rt_smem_addr(p)));
}

__device__ __forceinline__ void rt_ldmatrix_x2(uint32_t (&r)[2],
                                               const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(rt_smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16,
// column-major). Fragments as the PTX ISA lays them out: with g = lane / 4
// and t = lane % 4, a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, b = {(2t.., g), (2t + 8.., g)}, c = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void rt_mma_bf16_16816(float (&c)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mbarriers (one phase a use of a ring stage) and the TMA loads that
// complete on them: a box of a 2-d tensor map, and a plain bulk copy
__device__ __forceinline__ void rt_mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void rt_mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void rt_mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void rt_tma_load_2d(uint32_t dst, const void* map,
                                               uint32_t bar, int col, int row,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "l"(policy)
      : "memory");
}
__device__ __forceinline__ void rt_bulk_load(uint32_t dst, const void* src,
                                             int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t rt_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no -lcuda), for the sources that load by TMA tensor maps
typedef CUresult (*RtEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline RtEncodeTiled rt_encode_tiled() {
  // looked up once, by a function-local static's thread-safe initializer
  static const RtEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<RtEncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The wrappers raise with this text when a launch returns an error code.
extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
