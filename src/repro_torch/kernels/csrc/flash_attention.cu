// flash_attention: blocked GQA attention with an online softmax, in two
// masking modes, for the prefill stage. Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention: its static q_offset
// mode (_kernel) and its segment_info mode (_kernel_segmented).
//
// Static mode: causal, queries at global positions [q_offset, q_offset + S)
// against keys [0, Skv) (chunked serving prefill; the full-sequence
// forward with q_offset 0). Segmented mode (SEG): the packed-prefill mask,
// from four int32 arrays of shape (B, S) and (B, Skv): a query attends a
// key iff q_seg == kv_seg && q_pos >= kv_pos. Keys past Skv take no part
// (probability 0, a -inf score); masked scores are -1e30 and the row sum is
// clamped at 1e-30, as in the TPU kernel, so a padded query row (segment
// -2) stays finite.
//
// The static mode can also write each query row's log-sum-exp (B, H, S) f32
// in natural-log units of the scaled scores, m + log(max(l, 1e-30)), which
// the flash backward (flash_attention_bwd.cu) recomputes P from; a null
// pointer writes nothing, and the serving path passes null.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
//  * the llama3.2-1b prefill chunk (B 8, S 128, Skv 640 at offset 512,
//    H 32 / KH 8, D 64) and the packed one (R 8, C 128, Skv 640): 19 MB of
//    q/k/v/o, 0.0056 ms, against 5.4 GFLOP (0.0054 ms) if every pair
//    counted and less for the causal ones: bound by BYTES;
//  * jamba-v0.1-52b's prefill step (B 2, S 2048 causal, H 32 / KH 8,
//    D 128): 4 * 32 * 128 * 2 * (2048 * 2049 / 2) = 68.7 GFLOP, 0.070 ms,
//    against 84 MB of q/k/v/o (0.025 ms): bound by OPERATIONS.
// Reaching the first means reading each K/V byte once per KV head, not once
// per query head; reaching the second means the tensor cores.
//
// Two routes, chosen by the dtype code flash_attention_launch receives;
// both are kernels of this source, and an unsupported shape or dtype
// raises:
//
// bf16 -> wgmma_flash_kernel, on the tensor cores. A CTA owns a (batch
//   row, KV head, tile of 128 query rows): two consumer warpgroups of 64
//   rows each (one, and 64 rows, in the segmented mode at D 160) and one
//   producer warp. The rows are taken from the G * S rows of the KV
//   head's G query heads, which lie contiguous in
//   (B, H, S, D) q, so each K/V tile is read once for 128 rows of all G
//   heads (a tile may straddle two heads: its row r sits at position
//   q_offset + r % S). The producer warp moves Q once and then K/V tiles
//   of 64 keys into a ring of stages (3, or 2 above D 64) by TMA, each stage
//   with a "full" mbarrier (the TMA's bytes) and an "empty" one (every
//   consumer warp's release), so the warpgroups never wait for each other
//   at a CTA barrier and the loads run ahead of the products without
//   costing the consumers an instruction (PERF.md's findings on this
//   kernel have the measurements behind this shape). The TMA writes each 64-row box
//   swizzled by its row of min(D, 64) * 2 bytes (128B, 64B or 32B), and
//   the wgmma descriptors name the same swizzle. S = Q K^T runs as wgmma
//   m64n64k16 with Q and the K tile in shared memory (both K-major); P V
//   runs with P from registers (the f32 score fragment converted to bf16
//   in place: the accumulator layout of the first product is the
//   A-operand layout of the second) and the V tile in shared memory,
//   MN-major (D contiguous), through wgmma's transpose bit. The online
//   softmax (row max, rescale, row sum) stays in registers, reduced across
//   the four threads that hold a row. The static mode stops at the causal
//   frontier (the largest query position of the CTA's rows; a warpgroup
//   computes only up to its own) and masks only the tiles that cross the
//   diagonal or Skv. The segmented mode skips every KV tile that no valid
//   row can see: from its rows a warpgroup knows the range of their valid
//   segment ids (>= 0) and their largest position, from each KV tile's ids
//   the range of its valid ids and its smallest position; the tile is
//   seen iff the ranges meet and its smallest position does not exceed
//   the rows' largest (kernels/flash_attention.py::segment_tile_visible is
//   the same rule on tensors). The CTA loads the tiles some warpgroup
//   sees, and each warpgroup computes those it sees itself. A padded row
//   may thus average fewer keys than the plain version's; it stays finite
//   and nothing reads it.
//
//   Head dims: 16, 32 and 64 take one box of D columns a row tile; above
//   64 a tile is boxes of 64 columns (128B swizzle). A D that is not a
//   multiple of 64 (96: gpt2-2.5b, 112: kimi-k2, 160: pixtral-12b) runs as
//   the next multiple, DP (128, 128, 192), with the TMA's out-of-bounds
//   fill supplying zero columns: each box still moves its full 64 x 64 x 2
//   bytes into shared memory, and the "full" barrier expects exactly those
//   bytes (as it already did for the key rows past Skv). S = Q K^T stops at
//   D / 16 k-steps, so only P V computes the zero columns (96: 33 %, 112:
//   14 %, 160: 20 % more of its products), and only D columns are stored.
//   This was chosen over boxes of 32 or 16 columns (no wasted products, but
//   16-wide P V products at 112 and three swizzles to keep apart): D 96 and
//   112 run D 128's tested instance shape, D 160 a 192-wide one. Each
//   consumer thread holds DP / 2 f32 accumulators (96 at 160), so every D
//   above 64 takes 2 stages and 1 CTA an SM, as D 128 does.
//
// f32 -> flash_attention_kernel, on the CUDA cores in f32, kept as it was: TF32
//   products would miss the 1e-4 to which the float32 paths are held. One
//   block per (query tile of 32 rows, head, batch row); four threads share
//   a query row, each owning every fourth dimension of q and of the
//   accumulator (any D that is a multiple of 4); 32-key tiles of K and V
//   staged in shared memory as f32.
#include <cuda.h>

#include <climits>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 route: the CUDA-core template
// ---------------------------------------------------------------------------
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
                       float* __restrict__ lse,
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
    // the row's log-sum-exp of the scaled scores (every thread of the row
    // holds the same m and l)
    if (lse != nullptr && part == 0)
      lse[((size_t)b * H + h) * S + qi] = m + logf(denom);
    T* op = o + (((size_t)b * H + h) * S + qi) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      op[part + kThreadsPerRow * i] = rt_from_f32<T>(acc[i] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16 route: the tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int kWgRows = kRtWgRows;   // query rows a warpgroup: wgmma's M
constexpr int kKeys = 64;     // keys a KV tile: the N of S = Q K^T
constexpr float kLn2 = 0.6931471805599453f;

// The bf16 route's CTA shape: two consumer warpgroups (each owns 64 of
// the CTA's rows; both share each K/V tile, so a tile is read once for 128
// rows), a ring of 3 K/V stages and 2 CTAs an SM below D 128; at D 128 a
// third stage or a second CTA an SM makes ptxas spill, so 2 stages and 1
// CTA: the fastest shape without spills among those timed (PERF.md's
// findings on this kernel). Every D above 64 computes at its padded width
// kPadD (a multiple of 64) and takes D 128's shape, but for the segmented
// mode at DP 192 (D 160): 9 warps put 3 on one of the SM's four register-
// file quarters, which caps ptxas at 168 registers a thread, and the 96
// accumulators beside the key ids spill there; one consumer warpgroup (5
// warps) lifts the cap to 255. Its K/V tiles are then read once for 64
// rows, not 128.
template <int D> constexpr int kPadD = D <= 64 ? D : (D + 63) / 64 * 64;
template <int D, bool SEG> constexpr int kNWG = SEG && kPadD<D> > 128 ? 1 : 2;
template <int D> constexpr int kStages = kPadD<D> >= 128 ? 2 : 3;
template <int D> constexpr int kMinBlocks = kPadD<D> >= 128 ? 1 : 2;

// The tensor maps of q, k and v: 3-d (D columns, rows, heads), boxes of
// min(D, 64) columns x 64 rows, swizzled by their row of min(D, 64) * 2
// bytes. A (64 x D) tile lands as DP / 64 such boxes side by side (one for
// D <= 64; the columns past D zero-filled), each row r's 16-byte chunk c
// at r * row + ((c ^ r % 8) % (row / 16)) * 16 -- the layout the wgmma
// descriptors name.
struct FlashMaps {
  CUtensorMap q, k, v;
};

// Shared memory, from a 1024-byte-aligned base: NWG Q tiles, STAGES K
// tiles, STAGES V tiles (64 x DP bf16 each), then (SEG) STAGES x 64 key
// (position, segment id) pairs; then the mbarriers (full and empty a
// stage, and Q's) and (SEG) the ranges: of each consumer warp's 32 rows
// (rows 0-63 of a warpgroup lie in its warps 0 and 1) and of each KV tile.
template <int D, bool SEG>
__global__ void __launch_bounds__(128 * kNWG<D, SEG> + 32, kMinBlocks<D>)
wgmma_flash_kernel(const __grid_constant__ FlashMaps maps,
                   __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse,
                   const int* __restrict__ q_pos_ids,
                   const int* __restrict__ q_seg_ids,
                   const int* __restrict__ kv_pos_ids,
                   const int* __restrict__ kv_seg_ids, int H, int KH, int S,
                   int Skv, int q_offset, int causal, float scale) {
  constexpr int NWG = kNWG<D, SEG>, STAGES = kStages<D>, DP = kPadD<D>;
  constexpr int kConsumers = 128 * NWG, kCtaThreads = kConsumers + 32;
  constexpr int kRows = kWgRows * NWG;
  constexpr int kTileBytes = kWgRows * DP * 2;    // 64 rows of DP bf16
  constexpr int kBoxCols = D < 64 ? D : 64;
  constexpr int kRowBytes = kBoxCols * 2;         // a swizzled row
  constexpr int kBoxBytes = kWgRows * kRowBytes;  // one box: 64 rows
  constexpr int kOutN = kBoxCols;                 // N of one P V product
  constexpr int kOutParts = DP / kOutN;           // P V products a k-step
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + NWG * kTileBytes;
  unsigned char* v_s = k_s + STAGES * kTileBytes;
  int2* ids_s = reinterpret_cast<int2*>(v_s + STAGES * kTileBytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ids_s + (SEG ? STAGES * kKeys : 0));
  const uint32_t full_bar = rt_smem_addr(bars);          // + 8 s
  const uint32_t empty_bar = full_bar + 8 * STAGES;   // + 8 s
  const uint32_t q_bar = empty_bar + 8 * STAGES;
  int4* rows_s = reinterpret_cast<int4*>(bars + 2 * STAGES + 2);
  int4* tiles_s = rows_s + 2 * NWG;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid % 128) / 32;  // consumers' own
  const bool producer = tid >= kConsumers;
  const int G = H / KH, GS = G * S;
  const int n_row_tiles = (GS + kRows - 1) / kRows;
  // the last row tiles (latest positions, most keys) of every (batch row,
  // KV head) first
  const int pairs = gridDim.x / n_row_tiles;     // KH * B
  const int pair = blockIdx.x % pairs;
  const int r0 = (n_row_tiles - 1 - static_cast<int>(blockIdx.x) / pairs) *
                 kRows;
  const int kh = pair % KH, b = pair / KH;
  const int head = b * KH + kh;                  // of the tensor maps
  const size_t qrow0 = ((size_t)b * H + (size_t)kh * G) * S;  // row 0's
  const int n_rows = min(kRows, GS - r0);                 // the CTA's
  const int r0w = r0 + wg * kWgRows;                      // this WG's
  const int n_wrows = producer ? 0 : max(0, min(kWgRows, GS - r0w));
  const int n_kv_tiles = (Skv + kKeys - 1) / kKeys;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rt_mbar_init(full_bar + 8 * s, SEG ? 2 : 1);   // TMA (+ the ids)
      rt_mbar_init(empty_bar + 8 * s, kConsumers / 32);   // every consumer
    }
    rt_mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q once, while the rest is set up
    rt_mbar_expect_tx(q_bar, NWG * kTileBytes);
    for (int w = 0; w < NWG; ++w)
      for (int c = 0; c < kOutParts; ++c)
        rt_tma_load_3d(rt_smem_addr(q_s + w * kTileBytes + c * kBoxBytes),
                       &maps.q, q_bar, c * kBoxCols, r0 + w * kWgRows, head);
  }

  // The KV tiles: static mode loads [0, tile_end), up to the CTA's causal
  // frontier; a warpgroup computes those below its own (wg_end) and masks
  // those from first_masked on. Segmented mode loads each tile that some
  // warpgroup sees, and a warpgroup computes those it sees itself.
  auto pos_range = [&](int lo, int n, int* min_pos, int* max_pos) {
    const int last = lo + n - 1;
    const bool straddles = lo / S != last / S;
    *min_pos = q_offset + (straddles ? 0 : lo % S);
    *max_pos = q_offset + (straddles ? S - 1 : last % S);
  };
  int tile_end = n_kv_tiles, wg_end = n_wrows ? n_kv_tiles : 0;
  int first_masked = n_kv_tiles - (Skv % kKeys != 0);
  if (!SEG && causal) {
    int lo, hi;
    pos_range(r0, n_rows, &lo, &hi);
    tile_end = (min(Skv, hi + 1) + kKeys - 1) / kKeys;
    if (n_wrows) {
      pos_range(r0w, n_wrows, &lo, &hi);
      wg_end = (min(Skv, hi + 1) + kKeys - 1) / kKeys;
      // a tile whose last key lies past a row's position needs the mask
      first_masked = min(first_masked, (lo + 1) / kKeys);
    }
  }
  if (SEG) {
    // (smallest valid segment id, largest, and the largest position of a
    // valid row) of each warp's 32 rows; of each KV tile (smallest valid
    // id, largest, and the smallest valid position): one load round
    if (!producer && warp < 2) {
      const int r = r0w + warp * 32 + lane;
      int lo = INT_MAX, hi = INT_MIN, pos = INT_MIN;
      if (r < GS) {
        const size_t id = (size_t)b * S + r % S;
        const int seg = q_seg_ids[id];
        if (seg >= 0) lo = hi = seg, pos = q_pos_ids[id];
      }
      lo = __reduce_min_sync(RT_FULL_MASK, lo);
      hi = __reduce_max_sync(RT_FULL_MASK, hi);
      pos = __reduce_max_sync(RT_FULL_MASK, pos);
      if (lane == 0) rows_s[2 * wg + warp] = make_int4(lo, hi, pos, 0);
    }
    for (int t = tid / 32; t < n_kv_tiles; t += kCtaThreads / 32) {
      int lo = INT_MAX, hi = INT_MIN, pmin = INT_MAX;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = t * kKeys + h * 32 + lane;
        if (j < Skv) {
          const int seg = kv_seg_ids[(size_t)b * Skv + j];
          if (seg >= 0) {
            lo = min(lo, seg);
            hi = max(hi, seg);
            pmin = min(pmin, kv_pos_ids[(size_t)b * Skv + j]);
          }
        }
      }
      lo = __reduce_min_sync(RT_FULL_MASK, lo);
      hi = __reduce_max_sync(RT_FULL_MASK, hi);
      pmin = __reduce_min_sync(RT_FULL_MASK, pmin);
      if (lane == 0) tiles_s[t] = make_int4(lo, hi, pmin, 0);
    }
  }
  __syncthreads();   // the barriers (and the ranges) are ready
  // whether warpgroup w's rows see KV tile t: the segment ranges meet and
  // the tile's smallest position does not exceed the rows' largest
  auto sees = [&](int t, int w) -> bool {
    const int4 a = rows_s[2 * w], c = rows_s[2 * w + 1], k = tiles_s[t];
    return k.x <= max(a.y, c.y) && k.y >= min(a.x, c.x) &&
           k.z <= max(a.z, c.z);
  };
  // the first tile to load at or after t (tile_end when none is left)
  auto next_tile = [&](int t) -> int {
    if (!SEG) return t < tile_end ? t : tile_end;
    for (; t < tile_end; ++t) {
      bool any = false;
#pragma unroll
      for (int w = 0; w < NWG; ++w) any = any || sees(t, w);
      if (any) return t;
    }
    return tile_end;
  };

  if (producer) {
    // each tile into the ring, a stage refilled once every consumer warp
    // has released it; (SEG) the key ids of the next tile are fetched
    // while this one is handed over
    auto fetch_ids = [&](int t, int2* out) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = t * kKeys + h * 32 + lane;
        out[h] = j < Skv ? make_int2(kv_pos_ids[(size_t)b * Skv + j],
                                     kv_seg_ids[(size_t)b * Skv + j])
                         : make_int2(0, -1);
      }
    };
    int2 cur[2], nxt[2];
    int t = next_tile(0);
    if (SEG && t < tile_end) fetch_ids(t, nxt);
    for (int it = 0; t < tile_end; ++it) {
      const int s = it % STAGES, use = it / STAGES;
      const int tn = next_tile(t + 1);
      if (SEG) {
        cur[0] = nxt[0], cur[1] = nxt[1];
        if (tn < tile_end) fetch_ids(tn, nxt);
      }
      if (use > 0) rt_mbar_wait(empty_bar + 8 * s, (use - 1) & 1);
      if (lane == 0) {
        const uint32_t bar = full_bar + 8 * s;
        rt_mbar_expect_tx(bar, 2 * kTileBytes);
        for (int c = 0; c < kOutParts; ++c) {
          rt_tma_load_3d(rt_smem_addr(k_s + s * kTileBytes + c * kBoxBytes),
                         &maps.k, bar, c * kBoxCols, t * kKeys, head);
          rt_tma_load_3d(rt_smem_addr(v_s + s * kTileBytes + c * kBoxBytes),
                         &maps.v, bar, c * kBoxCols, t * kKeys, head);
        }
      }
      if (SEG) {
        ids_s[s * kKeys + lane] = cur[0];
        ids_s[s * kKeys + 32 + lane] = cur[1];
        __syncwarp();
        if (lane == 0) rt_mbar_arrive(full_bar + 8 * s);
      }
      t = tn;
    }
    return;
  }

  // consumers: this thread's two rows, r0w + rr[0] and r0w + rr[1]
  const int rr[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  int row_pos[2], row_seg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0w + rr[i];
    const int qi = (r < GS ? r : 0) % S;
    if (SEG) {
      row_pos[i] = q_pos_ids[(size_t)b * S + qi];
      row_seg[i] = r < GS ? q_seg_ids[(size_t)b * S + qi] : -2;
    } else {
      row_pos[i] = q_offset + qi;
      row_seg[i] = 0;
    }
  }

  float acc[DP / 2];   // O: kOutParts products of kOutN / 2 a thread
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {RT_NEG_INF, RT_NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kRtLog2e;
  const uint32_t q_addr = rt_smem_addr(q_s + wg * kTileBytes);
  rt_mbar_wait(q_bar, 0);

  int it = 0;
  for (int t = next_tile(0); t < tile_end; t = next_tile(t + 1), ++it) {
    const int s = it % STAGES;
    // every warp waits for each use of a stage before it releases it, so
    // that no release runs ahead into the stage's next use
    rt_mbar_wait(full_bar + 8 * s, (it / STAGES) & 1);
    // below this warpgroup's frontier, or seen by its rows
    if (t < wg_end && (!SEG || sees(t, wg))) {
      const uint32_t k_addr = rt_smem_addr(k_s + s * kTileBytes);
      const uint32_t v_addr = rt_smem_addr(v_s + s * kTileBytes);
      // S = Q K^T: K-major both; a k-step of 16 columns is 32 bytes along
      // the swizzled row, the next box after 64 columns; the zero columns
      // past D add nothing and are skipped
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      rt_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 16 / kBoxCols) * kBoxBytes +
                             (kk * 16 % kBoxCols) * 2;
        rt_wgmma_ss_n64(
            sc, rt_smem_desc(q_addr + off, 16, 8 * kRowBytes, kRowBytes),
            rt_smem_desc(k_addr + off, 16, 8 * kRowBytes, kRowBytes), kk > 0);
      }
      rt_wgmma_commit();
      rt_wgmma_wait<0>();
      rt_fence_regs<32>(sc);

      // scores in log2 units; element i sits at row rr[(i / 2) % 2], key
      // t0 + 8 (i / 4) + 2 (lane % 4) + i % 2
      // (SEG: the (position, id) pairs of keys j and j + 1 in one load)
      const int t0 = t * kKeys;
      const int4* kid = reinterpret_cast<const int4*>(ids_s + s * kKeys);
      const bool masked = SEG || t >= first_masked;
      float tmax[2] = {RT_NEG_INF, RT_NEG_INF};
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        int4 pair = make_int4(0, 0, 0, 0);
        if (SEG) pair = kid[4 * jb + lane % 4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jb + e, h = e / 2;
          const int j = 8 * jb + 2 * (lane % 4) + e % 2;
          const int kpos = e % 2 ? pair.z : pair.x;
          const int kseg = e % 2 ? pair.w : pair.y;
          float x = sc[i] * sl2;
          if (masked) {
            if (t0 + j >= Skv) {
              x = RT_EXCLUDED;
            } else if (SEG) {
              if (kseg != row_seg[h] || kpos > row_pos[h]) x = RT_NEG_INF;
            } else if (causal && t0 + j > row_pos[h]) {
              x = RT_NEG_INF;
            }
          }
          sc[i] = x;
          tmax[h] = fmaxf(tmax[h], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(RT_FULL_MASK, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(RT_FULL_MASK, tmax[h], 2));
        const float m_new = fmaxf(m[h], tmax[h]);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        sc[i] = exp2f(sc[i] - m[h]);
        l[h] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i / 2) % 2];

      // P (bf16, in place) V: V MN-major (D contiguous); a k-step of 16
      // keys is two 8-row groups, 16 swizzled rows; a part is one box
      uint32_t p[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] =
              rt_pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      rt_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int part = 0; part < kOutParts; ++part)
          rt_wgmma_rs<kOutN>(acc + part * (kOutN / 2), p[kk],
                             rt_smem_desc(v_addr + part * kBoxBytes +
                                              kk * 16 * kRowBytes,
                                          kBoxBytes, 8 * kRowBytes,
                                          kRowBytes));
      rt_wgmma_commit();
      rt_wgmma_wait<0>();
      rt_fence_regs<DP / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) rt_mbar_arrive(empty_bar + 8 * s);   // this warp is done
  }

  // the row sums of the four threads that share a row; then O / l. The
  // log-sum-exp goes out in natural-log units of the scaled scores: m and
  // log2(l) are in log2 units, so ln 2 (m + log2 l)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(RT_FULL_MASK, l[h], 1);
    l[h] += __shfl_xor_sync(RT_FULL_MASK, l[h], 2);
    if (lse != nullptr && lane % 4 == 0 && rr[h] < n_wrows)
      lse[qrow0 + r0w + rr[h]] =
          (m[h] + log2f(fmaxf(l[h], 1e-30f))) * kLn2;
    l[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rr[h] >= n_wrows) continue;
    __nv_bfloat16* op = o + (qrow0 + r0w + rr[h]) * D;
#pragma unroll
    for (int part = 0; part < kOutParts; ++part)
#pragma unroll
      for (int jn = 0; jn < kOutN / 8; ++jn) {
        if (part * kOutN + 8 * jn >= D) continue;     // a zero column
        const int i = part * (kOutN / 2) + 4 * jn + 2 * h;
        const int col = part * kOutN + 8 * jn + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(op + col) =
            __floats2bfloat162_rn(acc[i] * l[h], acc[i + 1] * l[h]);
      }
  }
}

// dynamic shared memory of the bf16 kernel (with the 1 KB of alignment), at
// the padded head dim DP
size_t wgmma_smem_bytes(int DP, int NWG, int STAGES, bool seg, int Skv) {
  const size_t tiles = (size_t)(NWG + 2 * STAGES) * kWgRows * DP * 2;
  const size_t n_kv_tiles = ((size_t)Skv + kKeys - 1) / kKeys;
  const size_t ids = seg ? STAGES * kKeys * 8 : 0;
  const size_t bars = 8 * (2 * STAGES + 2);
  const size_t ranges = seg ? 16 * (2 * NWG + n_kv_tiles) : 0;
  return 1024 + tiles + ids + bars + ranges;
}

template <int D, bool SEG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, const int* const* ids, int B,
                         int H, int KH,
                         int S, int Skv, long long kv_head_stride,
                         int q_offset, int causal, float scale,
                         cudaStream_t stream) {
  constexpr int NWG = kNWG<D, SEG>, STAGES = kStages<D>;
  // TMA reads from 16-byte-aligned addresses at 16-byte-multiple strides
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
  const long long G = H / KH, GS = G * S;
  const long long n_row_tiles = (GS + kWgRows * NWG - 1) / (kWgRows * NWG);
  if ((align % 16) != 0 || kv_head_stride % 8 != 0 ||
      kv_head_stride < (long long)Skv * D || GS > (1LL << 30) ||
      n_row_tiles * KH * B > INT_MAX)
    return cudaErrorInvalidValue;
  FlashMaps maps;
  const long long heads = (long long)B * KH;
  if (!rt_encode_map_3d(&maps.q, q, D, GS, heads, GS * D) ||
      !rt_encode_map_3d(&maps.k, k, D, Skv, heads, kv_head_stride) ||
      !rt_encode_map_3d(&maps.v, v, D, Skv, heads, kv_head_stride))
    return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes(kPadD<D>, NWG, STAGES, SEG, Skv);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = wgmma_flash_kernel<D, SEG>;
  // set on every launch above 48 KB: the attribute belongs to the current
  // device, and the call is cheap
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(n_row_tiles * KH * B), 128 * NWG + 32, smem,
           stream>>>(maps, static_cast<__nv_bfloat16*>(o), lse, ids[0],
                     ids[1], ids[2], ids[3], H, KH, S, Skv, q_offset, causal,
                     scale);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int* const* ids, int B, int H,
                        int KH, int S,
                        int Skv, long long kv_head_stride, int q_offset,
                        int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  flash_attention_kernel<float, D, SEG><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, ids[0],
      ids[1], ids[2], ids[3], H, KH, S, Skv, kv_head_stride, q_offset, causal,
      scale);
  return cudaGetLastError();
}

template <bool SEG>
cudaError_t launch_route(int dtype, const void* q, const void* k,
                         const void* v, void* o, float* lse,
                         const int* const* ids, int B,
                         int H, int KH, int S, int Skv, int D,
                         long long kv_head_stride, int q_offset, int causal,
                         float scale, cudaStream_t s) {
#define RT_FLASH_CASE(DIM)                                                   \
  case DIM:                                                                  \
    if (dtype == RT_BF16)                                                    \
      return launch_wgmma<DIM, SEG>(q, k, v, o, lse, ids, B, H, KH, S, Skv,  \
                                    kv_head_stride, q_offset, causal, scale, \
                                    s);                                      \
    if (dtype == RT_F32)                                                     \
      return launch_simt<DIM, SEG>(q, k, v, o, lse, ids, B, H, KH, S, Skv,   \
                                   kv_head_stride, q_offset, causal, scale,  \
                                   s);                                       \
    return cudaErrorInvalidValue;
  switch (D) {
    RT_FLASH_CASE(16)
    RT_FLASH_CASE(32)
    RT_FLASH_CASE(64)
    RT_FLASH_CASE(96)
    RT_FLASH_CASE(112)
    RT_FLASH_CASE(128)
    RT_FLASH_CASE(160)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_FLASH_CASE
}

}  // namespace

// q, o: (B, H, S, D) contiguous; k, v: (B, KH, Skv, D) with rows of D
// contiguous elements and kv_head_stride elements between heads (a prefix
// slice of a longer cache row is taken without a copy). D in {16, 32, 64,
// 96, 112, 128, 160}; H a multiple of KH; dtype RT_BF16 (tensor cores;
// pointers and kv_head_stride 16-byte aligned) or RT_F32 (CUDA cores).
// With q_pos null the static mode runs (q_offset, causal); otherwise the
// segmented mode, with q_pos/q_seg contiguous (B, S) and kv_pos/kv_seg
// contiguous (B, Skv) int32 arrays (q_offset and causal are then ignored).
// lse, when not null (static mode only), receives each query row's
// log-sum-exp (B, H, S) f32, in natural-log units of the scaled scores.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
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
  if (seg && (!q_seg || !kv_pos || !kv_seg || lse))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ids[4] = {q_pos, q_seg, kv_pos, kv_seg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      seg ? launch_route<true>(dtype, q, k, v, o, lse, ids, B, H, KH, S, Skv,
                               D, kv_head_stride, q_offset, causal, scale, s)
          : launch_route<false>(dtype, q, k, v, o, lse, ids, B, H, KH, S,
                                Skv, D, kv_head_stride, q_offset, causal,
                                scale, s);
  return static_cast<int>(err);
}
