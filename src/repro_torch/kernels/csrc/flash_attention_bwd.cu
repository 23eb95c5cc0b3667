// flash_attention_bwd: the recomputing flash-attention backward, the
// gradient of flash_attention.cu's static mode (causal or not, q_offset 0)
// on the training path.
//
// Replaces no TPU kernel: the reference's backward,
// repro/models/attention.py::_flash_bwd (the custom VJP of
// flash_attention_fused), is XLA, not Pallas. On the card the forward it
// differentiates is a hand-written kernel, so its gradient is one too. It
// computes what _flash_bwd computes (ref.flash_attention_bwd_ref is the
// plain version): from q, k, v, the forward's output o and its per-row
// log-sum-exp lse (natural log of the scaled scores), and dO,
//   D = rowsum(dO o), P = exp(s - lse), dV = P^T dO, dP = dO V^T,
//   dS = P (dP - D), dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd),
// where a KV head's dK and dV sum over its G query heads (GQA).
//
// Bound on an H100 SXM: operations. llama3.2-1b's training shape (B 4,
// H 32 / KH 8, S 1024 causal, D 64) has 4 * 32 * 524,800 (query, key)
// pairs; the five products take 10 D FLOPs a pair, 4.3e10, 0.043 ms at
// 989 TFLOP/s, against 50 MB of q, k, v, o, dO, lse in and dq, dk, dv out
// (0.015 ms). Reaching it takes wgmma (the only way to the tensor cores'
// full rate), loads that run beside the products, and no pair computed
// that the mask drops.
//
// Design: deterministic, two passes and no atomics, every sum in a fixed
// order, so two calls give the same bits:
//  * D = rowsum(dO o) in f32, into a (B, H, S) f32 scratch buffer;
//  * the dK/dV pass: one CTA per (tile of keys, KV head, batch row) holds
//    its keys' K and V and their dK, dV accumulators (FlashAttention-2's
//    KV-parallel loop) and walks the query rows of all G heads of its
//    group that can see a key of the tile (from the tile's first key on
//    when causal), recomputing P and dS for each (key, query) pair. The
//    key tiles with the most query rows (the first, under the causal
//    mask) launch first.
//  * the dQ pass: one CTA per (tile of query rows, head, batch row) holds
//    its rows' Q, dO, lse and D and a dQ accumulator and walks the keys up
//    to its causal frontier, recomputing P and dS; the tiles with the most
//    keys first.
// Two routes, by dtype:
//  * bf16 at every head dim (16, 32, 64, 96, 112, 128, 160):
//    bwd_dq_tc_kernel, then bwd_dkdv_tc_kernel, the forward's parts
//    (wgmma.cuh). Up to D 64 the dQ pass takes D of its rows from its o
//    and dO tiles (o loaded by TMA beside Q and dO) and writes it out for
//    the dK/dV pass (a kernel of its own took 0.013 ms of 0.254 at
//    llama's training shape); above D 64 bwd_delta_kernel computes it
//    first (see the wide head dims below). A
//    CTA is consumer warpgroups of 64 keys (dK/dV: 2) or query rows (dQ:
//    kDqWgs, 3) each and a producer warp, which loads the CTA's own tiles
//    once and streams the others, 64 rows at a time, by TMA into a ring of
//    kTcStages stages with "full" and "empty" mbarriers, so loads run
//    ahead of the products and no CTA barrier stands between them (the
//    dK/dV pass gives its producer a whole warpgroup, whose registers
//    setmaxnreg hands to the consumers: kDkdvThreads' note). In the
//    dK/dV pass S^T = K Q^T and dP^T = V dO^T run as wgmma m64n64k16 with
//    both operands in shared memory (K-major), P^T and dS^T are formed in
//    registers (the accumulator layout of the first product is the A
//    layout of the second, as the forward's P V), and dV += P^T dO and
//    dK += dS^T Q run as register-A wgmma with dO and Q MN-major through
//    the transpose bit; the dQ pass alike (S = Q K^T, dP = dO V^T,
//    dQ += dS K). Up to D 64 a dK/dV warpgroup keeps a tile's dV, dK
//    products in flight while it issues the next tile's S^T, dP^T (5 % of
//    the pass at llama's training shape); the dQ pass, three warpgroups
//    at 128 registers a thread, has no room for that (ptxas serializes
//    the products), and two warpgroups that do it were slower there than
//    three that do not.
//    In the dK/dV pass every wgmma wait is unconditional: one in a branch
//    made ptxas serialize the products. The dQ pass waits inside its one
//    branch, `t < wg_end` (a KV tile that the warpgroup's rows see; wg is
//    read warp-uniform, so a warpgroup takes it as one): it keeps no
//    product in flight across tiles. Scores are taken in log2 units:
//    log2 e is folded into the scale and into lse as they are loaded, and
//    P = exp2f(...). Only a tile that crosses the diagonal, or Skv in the
//    dQ pass, is masked; a tile that no pair of it sees is skipped whole. A key past Skv reads
//    zeros (TMA's out-of-bounds fill) and its dK, dV rows are not written;
//    a query row past S reads zeros and gets a log2 lse of 1e30, so its P
//    is 0 and it adds nothing.
//    P and dS enter the second products as two bf16 halves each (hi and
//    the bf16 rounding of what hi leaves out), two register-A wgmmas a
//    k-step: rounding them to one bf16, FlashAttention-2's way, missed the
//    bf16 bound 1e-2 + 2e-2 |want| at B 4, S 1000 on the card (an error of
//    0.0625: dK and dV sum about 4,000 terms a key). A float32 emulation
//    of this route at that shape (tests/test_torch_flash_bwd_tiles.py)
//    puts one rounding of P alone at 0.99 of the bound, of dS alone at
//    0.90, and the split at 0.25, the outputs' own bf16 rounding: neither
//    half can go. So the passes issue ten products' worth of tensor work
//    a pair where the bound counts five.
//
//    The wide head dims (96: gpt2-2.5b, 112: kimi-k2, 128: jamba, the
//    gpt-6.7b/13b/30b, olmo, phi3-medium, granite; 160: pixtral-12b) run
//    at the forward's padded width DP (128, 128, 128, 192): a tile is DP /
//    64 boxes of 64 columns (128B swizzle), the TMA's out-of-bounds fill
//    zeroes the columns past D in Q, K, V and dO, S^T and dP^T (S and dP)
//    stop at D / 16 k-steps, and only D columns of dq, dk and dv are
//    stored. What decides the design is registers. A dK/dV consumer at DP
//    128 would hold 2 x 64 f32 accumulators (128 registers a thread)
//    beside S^T and dP^T (64) and the halves of P^T and dS^T (64), about
//    260 against the 232 that setmaxnreg gives it (without products in
//    flight it still spilled 48 bytes), and at DP 192 the accumulators
//    alone take 192. So a dK/dV CTA computes one 64-column part of dK and
//    dV (kParts: 2, 2, 2, 3 CTAs side by side in the grid), 32 f32 a
//    thread for each accumulator as at D 64, and recomputes S^T and dP^T
//    over all D for its part: at D 128 the pass issues 64 m64n64k16
//    products a (64-key, 64-query) tile pair where one part would issue
//    48 (at D 160, 108 where one would issue 68), and each part streams
//    its Q and dO tiles again, from L2. It also waits for its dV, dK
//    products before the next tile (kept in flight, ptxas spilled 8-16
//    bytes: the longer S^T and dP^T need the halves' registers) and
//    releases the stage at once, so the skip of an unseen tile stays safe
//    with the 2 stages that DP 192 has room for (227 KB a CTA: K and V of
//    two warpgroups take 96 KB there, a stage of Q and dO 48 KB). The dQ
//    pass holds the whole width instead: two consumer warpgroups whose
//    DP-wide accumulator (64 or 96 f32) sits beside S, dP and dS's halves
//    at 232 registers, and a producer warpgroup that hands over its
//    registers as the dK/dV pass's does (in 64-column parts, three
//    warpgroups at 128 registers a thread, the call was slower at
//    jamba's shape).
//    It does not load o (two resident tiles a warpgroup and the ring fit
//    227 KB, three do not), so bwd_delta_kernel computes D first. Giving
//    dV to one warpgroup and dK to the other on one key tile, P^T passed
//    through shared memory, removes the recomputation but was slower at
//    DP 128 (a warpgroup's dS waits for the other's P every tile), so it
//    was not kept.
//  * f32: bwd_delta_kernel (D, 16 bytes of o and dO a
//    thread), then bwd_dkdv_kernel and bwd_dq_kernel on the CUDA cores in
//    f32 (every product in f32, as the plain version and the
//    reference compute them: the float32 route is held to 1e-4). A row of
//    D elements belongs to kTpr threads, a power of two that divides its
//    D / 4 chunks (16 dims a thread at D 16-128 and 24, 28 and 20 at 96,
//    112 and 160, as four to seven 16-byte chunks interleaved so that the
//    threads of a row read neighbouring chunks), whose partial dot
//    products meet in an xor butterfly (every lane ends with the same
//    sum).
#include <climits>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;     // query rows (dk/dv) or keys (dq) a round

// the largest power of two that divides n and is at most cap
constexpr int pow2_div(int n, int cap) {
  return cap >= 2 && n % 2 == 0 ? 2 * pow2_div(n / 2, cap / 2) : 1;
}
// threads a row: a power of two (a butterfly's and a 128-thread CTA's
// divisor) that divides the row's D / 4 chunks of 4 elements, about 16
// dims a thread: 16 at D 16-128 (D / 16 threads), 24 at D 96, 28 at 112
// and 20 at 160 (4, 4 and 8 threads), so no chunk lies past D
template <int D> constexpr int kTpr = pow2_div(D / 4, D / 16);
template <int D> constexpr int kRows = kThreads / kTpr<D>;    // rows a CTA
template <int D> constexpr int kDims = D / kTpr<D>;   // head dims a thread
template <int D> constexpr int kChunks = kDims<D> / 4;

// the 4-element chunk i (0 .. kChunks - 1) of thread `part`'s dims
template <int D>
__device__ __forceinline__ int chunk_of(int part, int i) {
  return part + kTpr<D> * i;
}

template <int D>
__device__ __forceinline__ void load_row(const float* row, int part, bool ok,
                                         float (&r)[kDims<D>]) {
#pragma unroll
  for (int i = 0; i < kChunks<D>; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[4 * i + e] = ok ? row[4 * chunk_of<D>(part, i) + e] : 0.f;
}

// the full dot product of a row held in registers with a staged row,
// summed over the row's threads
template <int D>
__device__ __forceinline__ float dot_row(const float (&r)[kDims<D>],
                                         const float* srow, int part) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks<D>; ++i) {
    const float4 x = reinterpret_cast<const float4*>(srow)[chunk_of<D>(part, i)];
    d = fmaf(r[4 * i], x.x, d);
    d = fmaf(r[4 * i + 1], x.y, d);
    d = fmaf(r[4 * i + 2], x.z, d);
    d = fmaf(r[4 * i + 3], x.w, d);
  }
#pragma unroll
  for (int o = 1; o < kTpr<D>; o <<= 1)
    d += __shfl_xor_sync(RT_FULL_MASK, d, o);
  return d;
}

// acc += a * (a staged row's dims of this thread)
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[kDims<D>], float a,
                                         const float* srow, int part) {
#pragma unroll
  for (int i = 0; i < kChunks<D>; ++i) {
    const float4 x = reinterpret_cast<const float4*>(srow)[chunk_of<D>(part, i)];
    acc[4 * i] = fmaf(a, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(a, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a, x.w, acc[4 * i + 3]);
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* row, int part,
                                          const float (&r)[kDims<D>],
                                          float s) {
#pragma unroll
  for (int i = 0; i < kChunks<D>; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      row[4 * chunk_of<D>(part, i) + e] = r[4 * i + e] * s;
}

// `rows` rows of D elements from `src` (row 0 at `first`, rows past `n`
// zero) into shared memory
template <int D>
__device__ __forceinline__ void stage(float (*dst)[D], const float* src,
                                      int first, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r][c] = r < n ? src[(size_t)(first + r) * D + c] : 0.f;
  }
}

// D = rowsum(dO o) of the (B, H, S) rows: 16 bytes of o and of dO a
// chunk, a row's D / kDeltaVec<T> chunks over kDeltaTpr<T, D> threads (a
// power of two, at most a warp; at D 96, 112 and 160 some threads take a
// chunk fewer), which meet in an xor butterfly; kDeltaRows<T, D> rows a
// block of 256 threads
// the least power of two >= n
constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }
template <typename T> constexpr int kDeltaVec = 16 / sizeof(T);
template <typename T, int D> constexpr int kDeltaChunks = D / kDeltaVec<T>;
template <typename T, int D>
constexpr int kDeltaTpr =
    pow2_ceil(kDeltaChunks<T, D>) < 32 ? pow2_ceil(kDeltaChunks<T, D>) : 32;
template <typename T, int D>
constexpr int kDeltaRows = 256 / kDeltaTpr<T, D>;

template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows) {
  constexpr int V = kDeltaVec<T>, kTprow = kDeltaTpr<T, D>;
  const long long row =
      (long long)blockIdx.x * kDeltaRows<T, D> + threadIdx.x / kTprow;
  const int part = threadIdx.x % kTprow;
  float d = 0.f;
  if (row < rows) {
#pragma unroll
    for (int c = part; c < kDeltaChunks<T, D>; c += kTprow) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + c * V);
      const uint4 g =
          *reinterpret_cast<const uint4*>(dout + row * D + c * V);
      const T* x = reinterpret_cast<const T*>(&a);
      const T* y = reinterpret_cast<const T*>(&g);
#pragma unroll
      for (int e = 0; e < V; ++e)
        d = fmaf(rt_to_f32(x[e]), rt_to_f32(y[e]), d);
    }
  }
#pragma unroll
  for (int m = 1; m < kTprow; m <<= 1) d += __shfl_xor_sync(RT_FULL_MASK, d, m);
  if (row < rows && part == 0) delta[row] = d;
}

// D of every row of a call: one launch of bwd_delta_kernel
template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         long long rows, cudaStream_t s) {
  constexpr int R = kDeltaRows<T, D>;
  bwd_delta_kernel<T, D><<<static_cast<unsigned>((rows + R - 1) / R), 256, 0,
                           s>>>(static_cast<const T*>(o),
                                static_cast<const T*>(dout), delta, rows);
  return cudaGetLastError();
}

// dK, dV of a tile of kRows keys of one (batch row, KV head)
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int KH, int S, int Skv,
                int causal, float scale) {
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float del_s[kTile];

  const int kh = blockIdx.y, b = blockIdx.z, G = H / KH;
  const int row = threadIdx.x / kTpr<D>, part = threadIdx.x % kTpr<D>;
  const int k0 = blockIdx.x * kRows<D>;
  const int key = k0 + row;
  const bool key_ok = key < Skv;
  const size_t kv_row = ((size_t)b * KH + kh) * Skv + (key_ok ? key : 0);

  float kr[kDims<D>], vr[kDims<D>], dk_acc[kDims<D>], dv_acc[kDims<D>];
  load_row<D>(k + kv_row * D, part, key_ok, kr);
  load_row<D>(v + kv_row * D, part, key_ok, vr);
#pragma unroll
  for (int i = 0; i < kDims<D>; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // no query before the tile's first key sees it under the causal mask
  const int q_first = causal ? (min(k0, S) / kTile) * kTile : 0;
  for (int g = 0; g < G; ++g) {
    const size_t head = (size_t)b * H + (size_t)kh * G + g;   // q's head
    for (int q0 = q_first; q0 < S; q0 += kTile) {
      const int n = min(kTile, S - q0);
      __syncthreads();   // the previous round's reads are done
      stage<D>(qs, q + head * S * D, q0, n);
      stage<D>(dos, dout + head * S * D, q0, n);
      if (threadIdx.x < kTile) {
        const bool in = threadIdx.x < n;
        lse_s[threadIdx.x] = in ? lse[head * S + q0 + threadIdx.x] : 0.f;
        del_s[threadIdx.x] = in ? delta[head * S + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
#pragma unroll 2   // deeper, ptxas spills at D 96
      for (int i = 0; i < n; ++i) {
        const float s = dot_row<D>(kr, qs[i], part);
        const float dp = dot_row<D>(vr, dos[i], part);
        const bool keep = key_ok && (!causal || key <= q0 + i);
        const float p = keep ? expf(s * scale - lse_s[i]) : 0.f;
        const float ds = p * (dp - del_s[i]);
        axpy_row<D>(dv_acc, p, dos[i], part);
        axpy_row<D>(dk_acc, ds, qs[i], part);
      }
    }
  }
  if (key_ok) {
    store_row<D>(dk + kv_row * D, part, dk_acc, scale);
    store_row<D>(dv + kv_row * D, part, dv_acc, 1.f);
  }
}

// dQ of a tile of kRows query rows of one (batch row, head); the last
// tiles (most keys under the causal mask) first
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int KH, int S, int Skv,
              int causal, float scale) {
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);
  const int row = threadIdx.x / kTpr<D>, part = threadIdx.x % kTpr<D>;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows<D>;
  const int qi = q0 + row;
  const bool q_ok = qi < S;
  const size_t q_row = ((size_t)b * H + h) * S + (q_ok ? qi : 0);

  float qr[kDims<D>], dor[kDims<D>], dq_acc[kDims<D>];
  load_row<D>(q + q_row * D, part, q_ok, qr);
  load_row<D>(dout + q_row * D, part, q_ok, dor);
#pragma unroll
  for (int i = 0; i < kDims<D>; ++i) dq_acc[i] = 0.f;
  const float row_lse = q_ok ? lse[q_row] : 0.f;
  const float row_del = q_ok ? delta[q_row] : 0.f;

  const int kv_end = causal ? min(Skv, min(S, q0 + kRows<D>)) : Skv;
  const size_t kv_head = ((size_t)b * KH + kh) * Skv * D;
  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    const int n = min(kTile, kv_end - t0);
    __syncthreads();
    stage<D>(ks, k + kv_head, t0, n);
    stage<D>(vs, v + kv_head, t0, n);
    __syncthreads();
#pragma unroll 2   // deeper, ptxas spills at D 96
    for (int j = 0; j < n; ++j) {
      const float s = dot_row<D>(qr, ks[j], part);
      const float dp = dot_row<D>(dor, vs[j], part);
      const bool keep = q_ok && (!causal || t0 + j <= qi);
      const float p = keep ? expf(s * scale - row_lse) : 0.f;
      axpy_row<D>(dq_acc, p * (dp - row_del), ks[j], part);
    }
  }
  if (q_ok) store_row<D>(dq + q_row * D, part, dq_acc, scale);
}

// ---------------------------------------------------------------------------
// bf16 route on the tensor cores (wgmma, TMA, a producer warp), at every
// head dim. Every tile is 64 rows (wgmma's M) of DP = kPadD<D> bf16: one
// tensor-map box of D columns (D <= 64), swizzled by its row of 2 D bytes,
// or DP / 64 boxes of 64 columns (128B swizzle) side by side, the columns
// past D zero-filled by the TMA (wgmma.cuh's rt_encode_map_3d).
// ---------------------------------------------------------------------------
constexpr int kTc = kRtWgRows;          // rows of a tile: keys or queries
template <int D> constexpr int kPadD = D <= 64 ? D : (D + 63) / 64 * 64;
template <int D> constexpr int kBoxCols = D < 64 ? D : 64;
// above D 64 a dK/dV CTA computes one 64-column part of its outputs, in
// kParts CTAs side by side, and the dQ pass gives its producer a warpgroup
// whose registers setmaxnreg hands to the consumers
template <int D> constexpr bool kWide = D > 64;
template <int D> constexpr int kParts = kPadD<D> / kBoxCols<D>;
// whether a dK/dV warpgroup keeps a tile's dV, dK products in flight
// while it issues the next tile's S^T, dP^T: up to D 64; above, the
// longer S^T and dP^T (D / 16 k-steps) need the registers of P's and
// dS's halves and ptxas spills, so it waits for them and releases the
// stage at once
template <int D> constexpr bool kKeepInFlight = !kWide<D>;
// the ring of streamed tiles: 3 stages, 2 at DP 192 (227 KB a CTA)
template <int D> constexpr int kTcStages = kPadD<D> > 128 ? 2 : 3;
// the dQ pass computes D = rowsum(dO o) itself from an o tile beside its Q
// and dO up to D 64; above, bwd_delta_kernel runs first (three resident
// tiles a warpgroup and the ring would not fit 227 KB)
// The dQ pass: kDqWgs consumer warpgroups of 64 query rows and a producer:
// up to D 64 three and a warp (at most 128 registers a thread, which 13
// warps allow); above, two and a warpgroup, as the dK/dV pass has.
// The dK/dV pass: two consumer warpgroups and a producer warpgroup, whose
// warps 1-3 only hand their registers over. Its consumers up to D 64 hold
// four accumulators of 32 f32 beside their bf16 halves, which spill under
// the 168 registers a thread that 9 warps allow (3 of them on one of the
// SM's four register-file quarters); setmaxnreg moves registers within
// the CTA's launch allocation, 384 x 168, so the producer warpgroup gives
// up 128 x (168 - 40) for the consumers' 256 x (232 - 168). Above D 64 a
// dQ consumer holds a DP-wide accumulator (64 or 96 f32) beside its 64 f32
// scores and dS's halves.
template <int D> constexpr int kDqWgs = kWide<D> ? 2 : 3;
template <int D> constexpr int kDqRows = kDqWgs<D> * kTc;
template <int D> constexpr int kDqThreads = kWide<D> ? 3 * 128 : 3 * 128 + 32;
constexpr int kDkdvThreads = 3 * 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// the log2 log-sum-exp of a query row past S: its P is exp2(-1e30) = 0
constexpr float kNoRow = 1e30f;

// the tensor maps of q, o, dO (D, S, B * H) and k, v (D, Skv, B * KH)
struct BwdMaps {
  CUtensorMap q, o, k, v, dout;
};

template <int D>
struct TcShape {
  static constexpr int kRowBytes = 2 * kBoxCols<D>;   // a swizzled row
  static constexpr int kBoxBytes = kTc * kRowBytes;   // one box: 64 rows
  static constexpr int kTileBytes = kTc * kPadD<D> * 2;   // a 64-row tile
  static constexpr int kBoxes = kTileBytes / kBoxBytes;
};

// a 64-row tile (DP / 64 boxes, or one) into shared memory by TMA
template <int D>
__device__ __forceinline__ void tc_load(unsigned char* dst,
                                        const CUtensorMap* map, uint32_t bar,
                                        int row, int head) {
#pragma unroll
  for (int c = 0; c < TcShape<D>::kBoxes; ++c)
    rt_tma_load_3d(rt_smem_addr(dst + c * TcShape<D>::kBoxBytes), map, bar,
                   c * kBoxCols<D>, row, head);
}

// two f32 values as the bf16 pair hi and the bf16 pair of what hi leaves
// out: hi + lo holds about 16 of f32's 24 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = rt_pack_bf16(x0 - f.x, x1 - f.y);
}

// a 64 x 64 f32 fragment (rt_wgmma_ss_n64's layout) as the register A
// operands of its four k-steps, split in two bf16 halves
__device__ __forceinline__ void split_frag(const float (&x)[32],
                                          uint32_t (&hi)[16],
                                          uint32_t (&lo)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    split_bf16(x[2 * j], x[2 * j + 1], hi[j], lo[j]);
}

// c (64 x 64, f32) = A B^T: A a 64 x DP tile, B a 64 x DP tile, both
// K-major in shared memory; D / 16 k-steps (the zero columns past D add
// nothing and are skipped), a k-step 32 bytes along the swizzled row, the
// next box after 64 columns
template <int D>
__device__ __forceinline__ void tc_abt(float (&c)[32], uint32_t a,
                                       uint32_t b) {
  constexpr int R = TcShape<D>::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk * 16 / kBoxCols<D>) * TcShape<D>::kBoxBytes +
                         (kk * 16 % kBoxCols<D>) * 2;
    rt_wgmma_ss_n64(c, rt_smem_desc(a + off, 16, 8 * R, R),
                    rt_smem_desc(b + off, 16, 8 * R, R), kk > 0);
  }
}

// acc (64 x NB boxes of columns, f32) += X B with X (64 x 64) as the
// halves hi + lo of split_frag and B NB boxes of a 64-row tile in shared
// memory from b on, its 64 rows X's k index (MN-major: the columns
// contiguous, through wgmma's transpose bit); one product a box, box c
// into acc + 32 c
template <int D, int NB>
__device__ __forceinline__ void tc_xb(float* acc, const uint32_t (&hi)[16],
                                      const uint32_t (&lo)[16], uint32_t b) {
  constexpr int R = TcShape<D>::kRowBytes, N = kBoxCols<D>;
  constexpr int BB = TcShape<D>::kBoxBytes;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const uint64_t desc = rt_smem_desc(b + c * BB + kk * 16 * R, BB,
                                         8 * R, R);
      rt_wgmma_rs<N>(acc + c * (N / 2), hi + 4 * kk, desc);
      rt_wgmma_rs<N>(acc + c * (N / 2), lo + 4 * kk, desc);
    }
}

// a (64 x NO) f32 accumulator of a warpgroup times s, as bf16: row r of
// the tile at rows + r D, its first n_cols columns (the zero columns past
// D are not stored); rows from n_ok on are not written
template <int D, int NO>
__device__ __forceinline__ void tc_store(__nv_bfloat16* rows, int n_ok,
                                         int n_cols, const float* acc,
                                         float s) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h;
    if (r >= n_ok) continue;
#pragma unroll
    for (int jn = 0; jn < NO / 8; ++jn) {
      if (8 * jn >= n_cols) continue;     // a zero column past D
      const int i = 4 * jn + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(rows + (size_t)r * D + 8 * jn +
                                         2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[i] * s, acc[i + 1] * s);
    }
  }
}

template <int D>
size_t dkdv_smem_bytes() {
  constexpr int ST = kTcStages<D>;
  return 1024 + (size_t)(4 + 2 * ST) * TcShape<D>::kTileBytes +
         2 * ST * kTc * 4 + 8 * (2 * ST + 1);
}

template <int D>
size_t dq_smem_bytes() {
  constexpr int ST = kTcStages<D>, kOwn = kWide<D> ? 2 : 3;
  return 1024 +
         (size_t)(kOwn * kDqWgs<D> + 2 * ST) * TcShape<D>::kTileBytes +
         8 * (2 * ST + 1);
}

// dK, dV of 128 keys of one (batch row, KV head), columns part * 64 on
// above D 64: warpgroup w owns keys k0 + 64 w .. + 63, its K and V tiles
// loaded once; the producer warp streams 64-row tiles of Q and dO of the
// group's G heads, from the causal frontier on, with their rows' log2 lse
// and D, into a ring. Per tile: S^T = K Q^T and dP^T = V dO^T (both
// operands in shared memory, over all D), P^T = exp2(S^T scale log2 e -
// lse log2 e) and dS^T = P^T (dP^T - D) in registers, then dV += P^T dO
// and dK += dS^T Q over the part's columns, with P^T and dS^T as register
// A operands in two bf16 halves. The key tiles that see the most query
// rows (the first, under the causal mask) launch first.
//
// Shared memory, from a 1024-byte-aligned base: K (2 tiles), V (2), the
// ring's Q and dO tiles (kTcStages each), the ring's lse and D (kTcStages x
// 64 f32 each), then the mbarriers: full and empty a stage, and K/V's.
template <int D>
__global__ void __launch_bounds__(kDkdvThreads, 1)
bwd_dkdv_tc_kernel(const __grid_constant__ BwdMaps maps,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int B, int H, int KH,
                   int S, int Skv, int causal, float scale) {
  constexpr int T = TcShape<D>::kTileBytes, ST = kTcStages<D>;
  constexpr int NP = kParts<D>, NO = kBoxCols<D>;   // a part's columns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + 2 * T;
  unsigned char* q_s = v_s + 2 * T;
  unsigned char* do_s = q_s + ST * T;
  float* lse_s = reinterpret_cast<float*>(do_s + ST * T);
  float* del_s = lse_s + ST * kTc;
  const uint32_t full_bar = rt_smem_addr(del_s + ST * kTc);   // + 8 s
  const uint32_t empty_bar = full_bar + 8 * ST;                // + 8 s
  const uint32_t kv_bar = empty_bar + 8 * ST;

  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32;
  // the warpgroup, read from lane 0 so that ptxas knows it warp-uniform:
  // the branches on it (tiles seen or not) then hold no divergent path
  // that would make it serialize the wgmma products
  const int wg = __shfl_sync(RT_FULL_MASK, tid / 128, 0);
  const int G = H / KH, pairs = KH * B;
  // the first key tiles (most query rows under the causal mask) first;
  // the column parts of a key tile side by side
  const int kt = static_cast<int>(blockIdx.x) / (pairs * NP);
  const int part = static_cast<int>(blockIdx.x) / pairs % NP;
  const int pair = static_cast<int>(blockIdx.x) % pairs;
  const int kh = pair % KH, b = pair / KH;
  const int k0 = kt * 2 * kTc;
  const int n_qt = (S + kTc - 1) / kTc;
  // no query before the tile's first key sees it under the causal mask
  const int qt0 = causal ? min(k0 / kTc, n_qt) : 0;
  const int per_g = n_qt - qt0, n_it = G * per_g;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      rt_mbar_init(full_bar + 8 * s, 1);
      rt_mbar_init(empty_bar + 8 * s, 8);   // every consumer warp
    }
    rt_mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    rt_mbar_expect_tx(kv_bar, 4 * T);
    for (int w = 0; w < 2; ++w) {
      tc_load<D>(k_s + w * T, &maps.k, kv_bar, k0 + w * kTc, b * KH + kh);
      tc_load<D>(v_s + w * T, &maps.v, kv_bar, k0 + w * kTc, b * KH + kh);
    }
  }
  __syncthreads();   // the barriers are ready

  if (tid >= 256) {
    // the producer warpgroup: its first warp puts each (head, query tile)
    // into the ring, a stage refilled once every consumer warp has
    // released it; the rows' lse (in log2 units) and D first, then the
    // tiles by TMA
    rt_setmaxnreg_dec<kProducerRegs>();
    for (int it = 0; tid < 288 && it < n_it; ++it) {
      const int s = it % ST, use = it / ST;
      const int head = b * H + kh * G + it / per_g;
      const int q0 = (qt0 + it % per_g) * kTc;
      float l[2], d[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + 32 * h + lane;
        l[h] = r < S ? lse[(size_t)head * S + r] * kRtLog2e : kNoRow;
        d[h] = r < S ? delta[(size_t)head * S + r] : 0.f;
      }
      if (use > 0) rt_mbar_wait(empty_bar + 8 * s, (use - 1) & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse_s[s * kTc + 32 * h + lane] = l[h];
        del_s[s * kTc + 32 * h + lane] = d[h];
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t bar = full_bar + 8 * s;
        rt_mbar_expect_tx(bar, 2 * T);
        tc_load<D>(q_s + s * T, &maps.q, bar, q0, head);
        tc_load<D>(do_s + s * T, &maps.dout, bar, q0, head);
      }
    }
  } else {
    rt_setmaxnreg_inc<kConsumerRegs>();
    // warpgroup wg's keys kw .. kw + 63
    const int kw = k0 + wg * kTc;
    const int n_keys = max(0, min(kTc, Skv - kw));
    const int key[2] = {kw + warp * 16 + lane / 4,
                        kw + warp * 16 + lane / 4 + 8};
    const float sl2 = scale * kRtLog2e;
    const uint32_t k_addr = rt_smem_addr(k_s + wg * T);
    const uint32_t v_addr = rt_smem_addr(v_s + wg * T);
    // the part's box of a Q or dO tile
    const uint32_t col_off = part * TcShape<D>::kBoxBytes;
    float dk_acc[NO / 2], dv_acc[NO / 2];
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    rt_mbar_wait(kv_bar, 0);

    // A tile's products into dV and dK stay in flight while the next seen
    // tile's S^T and dP^T are issued behind them (their registers are
    // free by then); its stage is released once they are done. Every wait
    // is unconditional, so that ptxas keeps the products asynchronous. A
    // warpgroup holds one stage so; the tiles it skips between two it
    // sees are at most one (the first of a head's, under the causal
    // mask), so the ring's other stages always take the next tile it sees
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
    int pending = -1;   // the stage whose dV, dK products are in flight
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      const int q0 = (qt0 + it % per_g) * kTc;
      // every warp waits for each use of a stage before it releases it
      rt_mbar_wait(full_bar + 8 * s, (it / ST) & 1);
      // a tile that no (key, query) pair of it sees is released at once
      if (n_keys == 0 || (causal && min(q0 + kTc, S) - 1 < kw)) {
        __syncwarp();
        if (lane == 0) rt_mbar_arrive(empty_bar + 8 * s);
        continue;
      }
      const uint32_t q_addr = rt_smem_addr(q_s + s * T);
      const uint32_t do_addr = rt_smem_addr(do_s + s * T);
      float st[32], dpt[32];
      rt_wgmma_fence();
      tc_abt<D>(st, k_addr, q_addr);
      tc_abt<D>(dpt, v_addr, do_addr);
      rt_wgmma_commit();
      // this thread's 16 query columns: 8 jb + 2 (lane % 4) + {0, 1}
      float2 l2[8], dd[8];
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int c = 8 * jb + 2 * (lane % 4);
        l2[jb] = *reinterpret_cast<const float2*>(lse_s + s * kTc + c);
        dd[jb] = *reinterpret_cast<const float2*>(del_s + s * kTc + c);
      }
      rt_wgmma_wait<1>();   // the previous tile's dV, dK products
      rt_fence_regs<NO / 2>(dv_acc);
      rt_fence_regs<NO / 2>(dk_acc);
      rt_fence_regs<16>(p_hi);
      rt_fence_regs<16>(p_lo);
      rt_fence_regs<16>(ds_hi);
      rt_fence_regs<16>(ds_lo);
      if (pending >= 0) {
        __syncwarp();
        if (lane == 0) rt_mbar_arrive(empty_bar + 8 * pending);
      }
      rt_wgmma_wait<0>();
      rt_fence_regs<32>(st);
      rt_fence_regs<32>(dpt);
      // element i: key key[(i / 2) % 2], query q0 + 8 (i / 4) + 2 (lane %
      // 4) + i % 2; only a tile that crosses the diagonal is masked
      const bool masked = causal && q0 < kw + kTc - 1;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int jb = i / 4;
        const float l = i % 2 ? l2[jb].y : l2[jb].x;
        const float d = i % 2 ? dd[jb].y : dd[jb].x;
        float p = exp2f(fmaf(st[i], sl2, -l));
        if (masked && key[(i / 2) % 2] > q0 + 8 * jb + 2 * (lane % 4) + i % 2)
          p = 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - d);
      }
      split_frag(st, p_hi, p_lo);
      split_frag(dpt, ds_hi, ds_lo);
      rt_wgmma_fence();
      tc_xb<D, 1>(dv_acc, p_hi, p_lo, do_addr + col_off);
      tc_xb<D, 1>(dk_acc, ds_hi, ds_lo, q_addr + col_off);
      rt_wgmma_commit();
      if constexpr (kKeepInFlight<D>) {
        pending = s;
      } else {
        rt_wgmma_wait<0>();
        rt_fence_regs<NO / 2>(dv_acc);
        rt_fence_regs<NO / 2>(dk_acc);
        rt_fence_regs<16>(p_hi);
        rt_fence_regs<16>(p_lo);
        rt_fence_regs<16>(ds_hi);
        rt_fence_regs<16>(ds_lo);
        __syncwarp();
        if (lane == 0) rt_mbar_arrive(empty_bar + 8 * s);
      }
    }
    rt_wgmma_wait<0>();
    rt_fence_regs<NO / 2>(dv_acc);
    rt_fence_regs<NO / 2>(dk_acc);
    rt_fence_regs<16>(p_hi);
    rt_fence_regs<16>(p_lo);
    rt_fence_regs<16>(ds_hi);
    rt_fence_regs<16>(ds_lo);
    if (n_keys > 0) {
      const size_t at = (((size_t)b * KH + kh) * Skv + kw) * D + part * NO;
      const int n_cols = min(NO, D - part * NO);
      tc_store<D, NO>(dk + at, n_keys, n_cols, dk_acc, scale);
      tc_store<D, NO>(dv + at, n_keys, n_cols, dv_acc, 1.f);
    }
  }
}

// dQ of kDqRows query rows of one (batch row, head): warpgroup w owns
// rows r0 + 64 w .. + 63, its Q and dO tiles loaded once; the producer
// streams 64-key tiles of K and V up to the causal frontier into a ring.
// Per tile: S = Q K^T and dP = dO V^T, P and dS = P (dP - D) in
// registers, dQ += dS K with dS as register A operands in two bf16
// halves. The last row tiles (most keys) launch first.
//
// Shared memory, from a 1024-byte-aligned base: Q (kDqWgs tiles), dO
// (kDqWgs), o (kDqWgs, D <= 64), the ring's K and V tiles (kTcStages
// each), then the mbarriers: full and empty a stage, and Q/dO/o's.
template <int D>
__global__ void __launch_bounds__(kDqThreads<D>, 1)
bwd_dq_tc_kernel(const __grid_constant__ BwdMaps maps,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int B, int H, int KH,
                 int S, int Skv, int causal, float scale) {
  constexpr int T = TcShape<D>::kTileBytes, ST = kTcStages<D>;
  constexpr int NW = kDqWgs<D>, DP = kPadD<D>;
  constexpr int kOwn = kWide<D> ? 2 : 3;     // resident tiles a WG
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* do_s = q_s + NW * T;
  unsigned char* o_s = do_s + NW * T;
  unsigned char* k_s = q_s + kOwn * NW * T;
  unsigned char* v_s = k_s + ST * T;
  const uint32_t full_bar = rt_smem_addr(v_s + ST * T);   // + 8 s
  const uint32_t empty_bar = full_bar + 8 * ST;            // + 8 s
  const uint32_t q_bar = empty_bar + 8 * ST;

  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32;
  // the warpgroup, read from lane 0 so that ptxas knows it warp-uniform:
  // the branches on it (tiles seen or not) then hold no divergent path
  // that would make it serialize the wgmma products
  const int wg = __shfl_sync(RT_FULL_MASK, tid / 128, 0);
  const int pairs = H * B;
  const int n_rt = (S + kDqRows<D> - 1) / kDqRows<D>;
  const int pair = static_cast<int>(blockIdx.x) % pairs;
  const int h = pair % H, b = pair / H, kh = h / (H / KH);
  // the last row tiles (most keys under the causal mask) first
  const int r0 =
      (n_rt - 1 - static_cast<int>(blockIdx.x) / pairs) * kDqRows<D>;
  const int n_kv = (Skv + kTc - 1) / kTc;
  // the KV tiles: [0, tile_end) up to the CTA's causal frontier; a
  // warpgroup computes those below its own (wg_end) and masks those from
  // first_masked on (the diagonal's, and the one that crosses Skv)
  const int r0w = r0 + wg * kTc;
  int tile_end = n_kv, wg_end = r0w < S ? n_kv : 0;
  int first_masked = n_kv - (Skv % kTc != 0);
  if (causal) {
    tile_end = min(n_kv, (min(r0 + kDqRows<D>, S) - 1) / kTc + 1);
    if (r0w < S) wg_end = min(n_kv, (min(r0w + kTc, S) - 1) / kTc + 1);
    first_masked = min(first_masked, r0w / kTc);
  }

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      rt_mbar_init(full_bar + 8 * s, 1);
      rt_mbar_init(empty_bar + 8 * s, 4 * NW);   // every consumer warp
    }
    rt_mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    rt_mbar_expect_tx(q_bar, kOwn * NW * T);
    for (int w = 0; w < NW; ++w) {
      tc_load<D>(q_s + w * T, &maps.q, q_bar, r0 + w * kTc, b * H + h);
      tc_load<D>(do_s + w * T, &maps.dout, q_bar, r0 + w * kTc, b * H + h);
      if constexpr (!kWide<D>)
        tc_load<D>(o_s + w * T, &maps.o, q_bar, r0 + w * kTc, b * H + h);
    }
  }
  __syncthreads();   // the barriers are ready

  if (tid >= 128 * NW) {
    // the producer (its first warp; above D 64 the other three only hand
    // their registers over): each KV tile into the ring
    if constexpr (kWide<D>) rt_setmaxnreg_dec<kProducerRegs>();
    for (int t = 0; tid < 128 * NW + 32 && t < tile_end; ++t) {
      const int s = t % ST, use = t / ST;
      if (use > 0) rt_mbar_wait(empty_bar + 8 * s, (use - 1) & 1);
      if (lane == 0) {
        const uint32_t bar = full_bar + 8 * s;
        rt_mbar_expect_tx(bar, 2 * T);
        tc_load<D>(k_s + s * T, &maps.k, bar, t * kTc, b * KH + kh);
        tc_load<D>(v_s + s * T, &maps.v, bar, t * kTc, b * KH + kh);
      }
    }
    return;
  }

  if constexpr (kWide<D>) rt_setmaxnreg_inc<kConsumerRegs>();
  // consumers: this thread's rows r0w + rr[0] and r0w + rr[1], their lse
  // in log2 units and D
  const int rr[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  const size_t bh = (size_t)b * H + h;
  float row_l[2], row_d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0w + rr[i];
    row_l[i] = row < S ? lse[bh * S + row] * kRtLog2e : kNoRow;
    if constexpr (kWide<D>) row_d[i] = row < S ? delta[bh * S + row] : 0.f;
  }
  rt_mbar_wait(q_bar, 0);
  if constexpr (!kWide<D>) {
    // D = rowsum(dO o) of each row, from the warpgroup's o and dO tiles:
    // the 4 threads that share a row take every fourth 16-byte chunk of
    // it (chunk c of row r lies at chunk c ^ swz(r), the TMA's swizzle),
    // and each thread of a row ends with the sum; written out for the
    // dK/dV pass
    constexpr int R = TcShape<D>::kRowBytes;
    const unsigned char* o_t = o_s + wg * T;
    const unsigned char* do_t = do_s + wg * T;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rr[i], swz = ((r * R) >> 7) & (R / 16 - 1);
      float d = 0.f;
#pragma unroll
      for (int c = lane % 4; c < R / 16; c += 4) {
        const int off = r * R + 16 * (c ^ swz);
        const uint4 a = *reinterpret_cast<const uint4*>(o_t + off);
        const uint4 g = *reinterpret_cast<const uint4*>(do_t + off);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(x[e]);
          const float2 yf = __bfloat1622float2(y[e]);
          d = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, d));
        }
      }
      d += __shfl_xor_sync(RT_FULL_MASK, d, 1);
      d += __shfl_xor_sync(RT_FULL_MASK, d, 2);
      const int row = r0w + r;
      if (row < S && lane % 4 == 0) delta[bh * S + row] = d;
      row_d[i] = row < S ? d : 0.f;
    }
  }
  const float sl2 = scale * kRtLog2e;
  const uint32_t q_addr = rt_smem_addr(q_s + wg * T);
  const uint32_t do_addr = rt_smem_addr(do_s + wg * T);
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;

  for (int t = 0; t < tile_end; ++t) {
    const int s = t % ST;
    rt_mbar_wait(full_bar + 8 * s, (t / ST) & 1);
    if (t < wg_end) {
      const uint32_t k_addr = rt_smem_addr(k_s + s * T);
      const uint32_t v_addr = rt_smem_addr(v_s + s * T);
      float sc[32], dp[32];
      rt_wgmma_fence();
      tc_abt<D>(sc, q_addr, k_addr);
      tc_abt<D>(dp, do_addr, v_addr);
      rt_wgmma_commit();
      rt_wgmma_wait<0>();
      rt_fence_regs<32>(sc);
      rt_fence_regs<32>(dp);
      // element i: row r0w + rr[(i / 2) % 2], key t0 + 8 (i / 4) +
      // 2 (lane % 4) + i % 2
      const int t0 = t * kTc;
      const bool masked = t >= first_masked;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i / 2) % 2;
        const int key = t0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        float p = exp2f(fmaf(sc[i], sl2, -row_l[hh]));
        if (masked && (key >= Skv || (causal && key > r0w + rr[hh])))
          p = 0.f;
        sc[i] = p * (dp[i] - row_d[hh]);
      }
      uint32_t ds_hi[16], ds_lo[16];
      split_frag(sc, ds_hi, ds_lo);
      rt_wgmma_fence();
      tc_xb<D, TcShape<D>::kBoxes>(dq_acc, ds_hi, ds_lo, k_addr);
      rt_wgmma_commit();
      rt_wgmma_wait<0>();
      rt_fence_regs<DP / 2>(dq_acc);
      rt_fence_regs<16>(ds_hi);
      rt_fence_regs<16>(ds_lo);
    }
    __syncwarp();
    if (lane == 0) rt_mbar_arrive(empty_bar + 8 * s);   // this warp is done
  }
  if (r0w < S)
    tc_store<D, DP>(dq + (bh * S + r0w) * D, S - r0w, D, dq_acc, scale);
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* o, const float* lse, const void* dout,
                      void* dq, void* dk, void* dv, float* delta, int B,
                      int H, int KH, int S, int Skv, int causal, float scale,
                      cudaStream_t s) {
  using bf = __nv_bfloat16;
  // TMA reads from 16-byte-aligned addresses
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
      reinterpret_cast<uintptr_t>(dout);
  if (align % 16 != 0) return cudaErrorInvalidValue;
  BwdMaps maps;
  if (!rt_encode_map_3d(&maps.q, q, D, S, (long long)B * H, (long long)S * D) ||
      !rt_encode_map_3d(&maps.o, o, D, S, (long long)B * H, (long long)S * D) ||
      !rt_encode_map_3d(&maps.dout, dout, D, S, (long long)B * H,
                        (long long)S * D) ||
      !rt_encode_map_3d(&maps.k, k, D, Skv, (long long)B * KH,
                        (long long)Skv * D) ||
      !rt_encode_map_3d(&maps.v, v, D, Skv, (long long)B * KH,
                        (long long)Skv * D))
    return cudaErrorInvalidValue;
  // one-dimensional grids, the tile index slowest, so that the heaviest
  // tiles of every (batch row, head) launch first; D = rowsum(dO o) first
  // (its own kernel above D 64, else the dQ pass), which the dK/dV pass
  // reads
  const long long kv_ctas =
      (Skv + 2LL * kTc - 1) / (2 * kTc) * kParts<D> * KH * B;
  const long long q_ctas = (S + kDqRows<D> - 1LL) / kDqRows<D> * H * B;
  if (kv_ctas > INT_MAX || q_ctas > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if constexpr (kWide<D>) {
    err = launch_delta<bf, D>(o, dout, delta, (long long)B * H * S, s);
    if (err != cudaSuccess) return err;
  }
  // the attribute is set on every launch: it belongs to the current device
  auto dkdv = bwd_dkdv_tc_kernel<D>;
  auto dqk = bwd_dq_tc_kernel<D>;
  const size_t kv_smem = dkdv_smem_bytes<D>(), q_smem = dq_smem_bytes<D>();
  if (kv_smem > 227 * 1024 || q_smem > 227 * 1024)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return err;
  dqk<<<static_cast<unsigned>(q_ctas), kDqThreads<D>, q_smem, s>>>(
      maps, lse, delta, static_cast<bf*>(dq), B, H, KH, S, Skv, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return err;
  dkdv<<<static_cast<unsigned>(kv_ctas), kDkdvThreads, kv_smem, s>>>(
      maps, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), B, H, KH,
      S, Skv, causal, scale);
  return cudaGetLastError();
}

// the f32 route: D, then dK/dV, then dQ on the CUDA cores
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       int H, int KH, int S, int Skv, int causal, float scale,
                       cudaStream_t s) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  cudaError_t err =
      launch_delta<float, D>(o, dout, delta, (long long)B * H * S, s);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((Skv + kRows<D> - 1) / kRows<D>, KH, B);
  bwd_dkdv_kernel<D><<<kv_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, KH, S, Skv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((S + kRows<D> - 1) / kRows<D>, H, B);
  bwd_dq_kernel<D><<<q_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), H, KH, S, Skv,
      causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_dim(int dtype, int D, const void* q, const void* k,
                       const void* v, const void* o, const float* lse,
                       const void* dout, void* dq, void* dk, void* dv,
                       float* delta, int B, int H, int KH, int S, int Skv,
                       int causal, float scale, cudaStream_t s) {
#define RT_BWD_CASE(DIM)                                                    \
  case DIM:                                                                 \
    if (dtype == RT_BF16)                                                   \
      return launch_tc<DIM>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,    \
                            H, KH, S, Skv, causal, scale, s);               \
    if (dtype == RT_F32)                                                    \
      return launch_f32<DIM>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,   \
                             H, KH, S, Skv, causal, scale, s);              \
    return cudaErrorInvalidValue;
  switch (D) {
    RT_BWD_CASE(16)
    RT_BWD_CASE(32)
    RT_BWD_CASE(64)
    RT_BWD_CASE(96)
    RT_BWD_CASE(112)
    RT_BWD_CASE(128)
    RT_BWD_CASE(160)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_BWD_CASE
}

}  // namespace

// q, o, dout, dq: (B, H, S, D); k, v, dk, dv: (B, KH, Skv, D); all
// contiguous, of one dtype (RT_F32 or RT_BF16). lse: the forward's (B, H,
// S) f32 log-sum-exp; delta: (B, H, S) f32 scratch. Queries at positions
// [0, S), keys [0, Skv); causal masks key > query. D in {16, 32, 64, 96,
// 112, 128, 160}; o and dout start 16-byte aligned, and so do q, k and v
// for the bf16 route, which reads them by TMA. Two or three kernels on
// `stream`; returns the first launch error.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int B, int H, int KH, int S, int Skv, int D, int causal,
    float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || S < 1 || Skv < 1 ||
      B > 65535 || H > 65535 ||
      (reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout)) %
          16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dim(dtype, D, q, k, v, o, lse, dout, dq, dk,
                                     dv, delta, B, H, KH, S, Skv, causal,
                                     scale,
                                     static_cast<cudaStream_t>(stream)));
}
