// rwkv_chunk_bwd: the gradient of the RWKV6 wkv from a zero state.
//
// Replaces no TPU kernel: the reference differentiates its wkv
// (repro/models/ssm.py::_wkv_scan) with XLA. On the card the forward it
// differentiates is the hand-written csrc/rwkv_chunk.cu, so its gradient
// is this kernel. The forward, per row bh and step t (K x K state S,
// k-major, S_{-1} = 0):
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Its adjoint runs over G_t, the gradient of S_t (G_{T-1} = dS_T):
//
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T
//   dr_t[i] = sum_j (S_{t-1}[i,j] + u_i k_t[i] v_t[j]) dy_t[j]
//   dk_t[i] = sum_j G_t[i,j] v_t[j] + u_i r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i,j] k_t[i] + dy_t[j] sum_i r_t[i] u_i k_t[i]
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   = sum_t r_t[i] k_t[i] (v_t . dy_t)
//
// Every element (i, j) of S and of G is a scalar recurrence of its own
// (S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j]); the rows and columns
// meet only in the sums above. dw needs S_{t-1} and G_t at once, the one
// walking forward and the other back. The decays run from about 2e-24 to
// 1 - 4.5e-5 a step, so S_{t-1} is never recovered from S_t by dividing
// by w_t (nor by any product of decays, as chunked forms do): it is
// checkpointed and recomputed, element by element, in f32.
//
// Design: one block of 256 threads (8 warps) a row bh, one row to an SM;
// each thread owns 16 elements of S and of G in registers, rows i0 ..
// i0 + 3 by columns j0 .. j0 + 3, and a warp a 32 x 16 tile of the state.
// A thread of 4 x 4 loads 20 values a step for 16 elements and takes
// its sums over 4 columns or rows in registers, where one of 2 x 4 (16
// warps a row) loads 14 for 8 and sums over 4 columns or 2 rows. The
// inputs are staged in shared memory in f32:
//  * forward, a stretch of 32 steps a task: S advances, and before each
//    stretch it is written to a checkpoint in device memory (scratch ck);
//    the last stretch's start stays in shared memory;
//  * then the reverse, a sub-chunk of 8 steps a task, each stretch from
//    the last: the level-2 walk (L) runs S from the stretch's checkpoint
//    through its first 3 sub-chunks, keeping the state before each
//    sub-chunk in a shared-memory slot; then (R) each sub-chunk from the
//    last: S from its slot walks the 8 steps forward, holding each S_{t-1}
//    in registers (128 a thread), and G walks them back taking
//    S_{t-1} dy_t, G_t v_t, G_t^T k_t and G_t * S_{t-1}.
// No step waits on a sum: each step adds the products over the thread's
// 4 columns (or rows) in registers and over its tile's 16 columns (or 32
// rows) by shuffles that trade halves between lanes, and writes one
// partial a tile to shared memory; once a sub-chunk, after a barrier,
// thread (s, c) adds the tiles' partials of each sum at step s and
// channel c in a fixed order, adds the u terms and writes dr, dk, dv and
// dw. Partials and dot products alternate between two buffers, and the
// inputs rotate through three stages, so a sub-chunk takes one barrier.
// du is summed over a row's steps by those threads, over the 4 threads
// of a channel, then over the rows that share u[bh % U] in a second small
// kernel. No atomics: two calls give the same bits.
// Inputs stream: each thread loads its elements of every input for the
// task after next into registers (a sub-chunk is 8 x 64 elements, two a
// thread; a stretch eight), and stores them, converted to f32, into a free
// stage while the current task computes; the barrier that ends a task
// publishes it. Padded steps decay by 1 and add nothing, so S and G pass
// them unchanged; padded channels stay 0. A stretch's start state is
// fetched by cp.async into its slot a stretch ahead.
//
// Checkpoints: every 32 steps, BH x (ceil(T/32) - 1) x 16 KB written and
// read once: at rwkv6-7b's training shape 132,120,576 B each way, 0.08
// ms at 3.35 TB/s (every 8 steps would move 1.07 GB, more than the
// operations' bound). The work a step and element: S advanced three times
// (forward, level 2 for 3 of 4 sub-chunks, reverse) and G once, 2
// operations each, and the four products, one FMA each: 11.5 issued
// against the bound's 7 (14 flops).
//
// Bound on an H100: operations. At rwkv6-7b's full-sequence training
// shape (BH 128, T 2048, K 64; r, k, v bf16, w and dy f32) it reads 235 MB
// and writes 168 MB (dr, dk, dv bf16, dw f32): 0.12 ms at 3.35 TB/s; the
// recurrences take 14 flops an element of S a step (the state and G
// advanced, 3 each; S dy, G v, G^T k and G * S, 2 each), 15.0 GFLOP: 0.22
// ms at the f32 rate of 67 TFLOP/s.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK = 64;       // the state's width; K < 64 runs zero channels
constexpr int kSub = 8;      // steps a task stages; S_{t-1} held in registers
constexpr int kQ = 4;        // sub-chunks a stretch between checkpoints
constexpr int kCk = kSub * kQ;  // steps between checkpoints
constexpr int kE = 16;       // state elements a thread owns (4 rows x 4 cols)
constexpr int kCB = 4;       // tile columns: partials of a sum over j
constexpr int kRB = 2;       // tile rows: partials of a sum over i
constexpr int kRing = 3;     // stages of the reverse's inputs
constexpr int kPer = kSub * kK / kThreads;  // staged elements a thread
static_assert(kThreads == 32 * kCB * kRB, "a warp a 32 x 16 tile");
static_assert(kThreads / 32 == kSub, "warp s takes step s's dot products");
static_assert(kSub * kK % kThreads == 0 && kThreads % kK == 0,
              "a thread stages whole elements of one channel");

enum { kL = 1, kR = 2 };

// a reverse task's inputs, in f32
struct Stage {
  float r[kSub][kK], k[kSub][kK], v[kSub][kK], w[kSub][kK], dy[kSub][kK];
};

// a forward task's inputs: a whole stretch
struct FStage {
  float k[kCk][kK], v[kCk][kK], w[kCk][kK];
};

// per-sub-chunk partials, [step][tile column or row][channel]
struct Parts {
  float r[kSub][kCB][kK];        // dr: S_{t-1} dy over a tile's 16 columns
  float k[kSub][kCB][kK];        // dk: G v over 16 columns
  float w[kSub][kCB][kK];        // dw: G * S_{t-1} over 16 columns
  float v[kSub][kRB][kK];        // dv: G^T k over 32 rows
};

struct Smem {
  union {
    Parts part[2];               // the reverse: two sub-chunks in turn
    FStage fst[2];               // the forward: two stretches in turn
  };
  float4 slot[kQ][kE / 4][kThreads];  // S before each sub-chunk of a stretch
  Stage st[kRing];
  float u[kK];
  float vdy[2][kSub];            // v_t . dy_t
  float ruk[2][kSub];            // sum_i r_t[i] u_i k_t[i]
  float du[kThreads / kK][kK];
};

struct Task {
  int kind, g, Q;  // L or R; the sub-chunk; sub-chunks in its stretch
};

// Task n of the reverse: for each stretch c from the last, L over
// sub-chunks 0 .. Q-2 and R over Q-1 .. 0; 2 nsub - nck tasks in all.
__device__ __forceinline__ Task task_of(int n, int nsub, int nck) {
  int m = n, c = nck - 1, Q = nsub - kQ * (nck - 1);
  if (m >= 2 * Q - 1) {
    m -= 2 * Q - 1;
    c -= 1 + m / (2 * kQ - 1);
    m %= 2 * kQ - 1;
    Q = kQ;
  }
  if (m < Q - 1) return {kL, kQ * c + m, Q};
  return {kR, kQ * c + 2 * Q - 2 - m, Q};
}

__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

// The forward's inputs of stretch c, 8 elements a thread (steps tid / 64
// + 4 m, channel tid % 64), held in registers between their load and
// their store.
template <typename Tin>
struct FPrefetch {
  static constexpr int kN = kCk * kK / kThreads;
  Tin k[kN], v[kN];
  float w[kN];

  __device__ __forceinline__ void load(int c, const Tin* kp, const Tin* vp,
                                       const float* wp, size_t base, int T,
                                       int K, int tid) {
    const int ec = tid % kK;
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      const int t = c * kCk + (tid + m * kThreads) / kK;
      const size_t gi = base + static_cast<size_t>(t) * K + ec;
      k[m] = v[m] = rt_from_f32<Tin>(0.f);
      w[m] = t < T ? 0.f : 1.f;    // a padded step decays by 1
      if (t < T && ec < K) {
        k[m] = kp[gi];
        v[m] = vp[gi];
        w[m] = wp[gi];
      }
    }
  }

  __device__ __forceinline__ void store(FStage& x, int tid) const {
    const int ec = tid % kK;
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      const int s = (tid + m * kThreads) / kK;
      x.k[s][ec] = rt_to_f32(k[m]);
      x.v[s][ec] = rt_to_f32(v[m]);
      x.w[s][ec] = w[m];
    }
  }
};

// A reverse task's inputs, kPer elements a thread (steps tid / 64 + 4 m,
// channel tid % 64).
template <typename Tin, typename Tdy>
struct Prefetch {
  Tin r[kPer], k[kPer], v[kPer];
  Tdy dy[kPer];
  float w[kPer];
  int kind;

  __device__ __forceinline__ void load(const Task& t, const Tin* rp,
                                       const Tin* kp, const Tin* vp,
                                       const float* wp, const Tdy* dyp,
                                       size_t base, int T, int K, int tid) {
    const int ec = tid % kK;
    kind = t.kind;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int tt = t.g * kSub + (tid + m * kThreads) / kK;
      const bool step = tt < T, ok = step && ec < K;
      const size_t gi = base + static_cast<size_t>(tt) * K + ec;
      k[m] = v[m] = rt_from_f32<Tin>(0.f);
      w[m] = step ? 0.f : 1.f;     // a padded step decays by 1
      if (ok) {
        k[m] = kp[gi];
        v[m] = vp[gi];
        w[m] = wp[gi];
      }
      if (kind == kR) {
        r[m] = rt_from_f32<Tin>(0.f);
        dy[m] = rt_from_f32<Tdy>(0.f);
        if (ok) {
          r[m] = rp[gi];
          dy[m] = dyp[gi];
        }
      }
    }
  }

  __device__ __forceinline__ void store(Stage& x, int tid) const {
    const int ec = tid % kK;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int s = (tid + m * kThreads) / kK;
      x.k[s][ec] = rt_to_f32(k[m]);
      x.v[s][ec] = rt_to_f32(v[m]);
      x.w[s][ec] = w[m];
      if (kind == kR) {
        x.r[s][ec] = rt_to_f32(r[m]);
        x.dy[s][ec] = rt_to_f32(dy[m]);
      }
    }
  }
};

// S through 8 steps: S = diag(w) S + k v^T.
__device__ __forceinline__ void advance(float (&S)[kE],
                                        const float (*w)[kK],
                                        const float (*k)[kK],
                                        const float (*v)[kK], int i0,
                                        int j0) {
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    float wa[4], ka[4], vb[4];
    ld4(&w[s][i0], wa);
    ld4(&k[s][i0], ka);
    ld4(&v[s][j0], vb);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        S[a * 4 + b] = fmaf(wa[a], S[a * 4 + b], ka[a] * vb[b]);
  }
}

// A sum over j of rows i0 .. i0 + 3 (x, over the thread's 4 columns)
// summed over the tile's 16 columns: lanes ^1 trade 2 rows, ^2 one; each
// lane writes row i0 + 2 (cq & 1) + (cq >> 1).
__device__ __forceinline__ void sum_cols(const float (&x)[4], int cq,
                                         float* rows) {
  const int h1 = cq & 1, h2 = cq >> 1;
  const float k0 = h1 ? x[2] : x[0], k1 = h1 ? x[3] : x[1];
  const float g0 = h1 ? x[0] : x[2], g1 = h1 ? x[1] : x[3];
  const float y0 = k0 + __shfl_xor_sync(RT_FULL_MASK, g0, 1);
  const float y1 = k1 + __shfl_xor_sync(RT_FULL_MASK, g1, 1);
  const float z = (h2 ? y1 : y0)
                  + __shfl_xor_sync(RT_FULL_MASK, h2 ? y0 : y1, 2);
  rows[2 * h1 + h2] = z;
}

// A sum over i of columns j0 .. j0 + 3 (x, over the thread's 4 rows)
// summed over the tile's 32 rows: lanes ^4 trade 2 columns, ^8 one, ^16
// add; the lanes with rq < 4 write column j0 + 2 (rq & 1) + (rq >> 1 & 1).
__device__ __forceinline__ void sum_rows(const float (&x)[4], int rq,
                                         float* cols) {
  const int h1 = rq & 1, h2 = (rq >> 1) & 1;
  const float k0 = h1 ? x[2] : x[0], k1 = h1 ? x[3] : x[1];
  const float g0 = h1 ? x[0] : x[2], g1 = h1 ? x[1] : x[3];
  const float y0 = k0 + __shfl_xor_sync(RT_FULL_MASK, g0, 4);
  const float y1 = k1 + __shfl_xor_sync(RT_FULL_MASK, g1, 4);
  float z = (h2 ? y1 : y0) + __shfl_xor_sync(RT_FULL_MASK, h2 ? y0 : y1, 8);
  z += __shfl_xor_sync(RT_FULL_MASK, z, 16);
  if (rq < 4) cols[2 * h1 + h2] = z;
}

__device__ __forceinline__ void put(float4 (&slot)[kE / 4][kThreads],
                                    int tid, const float (&S)[kE]) {
#pragma unroll
  for (int q = 0; q < kE / 4; ++q)
    slot[q][tid] = make_float4(S[4 * q], S[4 * q + 1], S[4 * q + 2],
                               S[4 * q + 3]);
}

__device__ __forceinline__ void get(const float4 (&slot)[kE / 4][kThreads],
                                    int tid, float (&S)[kE]) {
#pragma unroll
  for (int q = 0; q < kE / 4; ++q) {
    const float4 f = slot[q][tid];
    S[4 * q] = f.x; S[4 * q + 1] = f.y; S[4 * q + 2] = f.z;
    S[4 * q + 3] = f.w;
  }
}

template <typename Tin, typename Tdy>
__global__ void __launch_bounds__(kThreads, 1)
rwkv_chunk_bwd_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                      const Tin* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const Tdy* __restrict__ dy,
                      const float* __restrict__ ds, Tin* __restrict__ dr,
                      Tin* __restrict__ dk, Tin* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_rows,
                      float4* __restrict__ ck, int T, int K, int u_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // the thread's state elements: rows i0 .. i0 + 3, columns j0 .. j0 + 3
  // of its warp's 32 x 16 tile (tile row rb, tile column cb)
  const int rb = warp / kCB, cb = warp % kCB, rq = lane >> 2, cq = lane & 3;
  const int i0 = rb * 32 + 4 * rq, j0 = cb * 16 + 4 * cq;
  const int ec = tid % kK;       // the channel it stages and sums
  const int nsub = (T + kSub - 1) / kSub, nck = (nsub + kQ - 1) / kQ;
  const size_t base = static_cast<size_t>(bh) * T * K;
  float4* ckb = ck + static_cast<size_t>(bh) * nck * (kE / 4) * kThreads;
  const uint64_t policy = rt_evict_first();

  if (tid < kK)
    sm.u[tid] = tid < K ? u[static_cast<size_t>(bh % u_rows) * K + tid] : 0.f;
  float S[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) S[e] = 0.f;

  // forward, a stretch a task: the state before each stretch to its
  // checkpoint (the last one's to the last slot)
  {
    FPrefetch<Tin> fp;
    fp.load(0, k, v, w, base, T, K, tid);
    fp.store(sm.fst[0], tid);
    if (nck > 1) fp.load(1, k, v, w, base, T, K, tid);
    __syncthreads();
    for (int c = 0; c < nck; ++c) {
      if (c + 1 < nck) fp.store(sm.fst[(c + 1) & 1], tid);
      if (c + 2 < nck) fp.load(c + 2, k, v, w, base, T, K, tid);
      if (c == nck - 1) {
        put(sm.slot[kQ - 1], tid, S);
      } else {
        float4* dst = ckb + static_cast<size_t>(c) * (kE / 4) * kThreads
                      + tid;
#pragma unroll
        for (int q = 0; q < kE / 4; ++q)
          dst[q * kThreads] = make_float4(S[4 * q], S[4 * q + 1],
                                          S[4 * q + 2], S[4 * q + 3]);
      }
      const FStage& x = sm.fst[c & 1];
      const int last = c == nck - 1 ? nsub - kQ * c : kQ;
      for (int m = 0; m < last; ++m)
        advance(S, x.w + m * kSub, x.k + m * kSub, x.v + m * kSub, i0, j0);
      __syncthreads();
    }
  }

  // reverse: from G_{T-1} = dS_T
  float G[kE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + a, j = j0 + b;
      G[a * 4 + b] = ds != nullptr && i < K && j < K
          ? ds[(static_cast<size_t>(bh) * K + i) * K + j] : 0.f;
    }
  float du_acc = 0.f;
  const int ntask = 2 * nsub - nck;
  Prefetch<Tin, Tdy> pf;
  pf.load(task_of(0, nsub, nck), r, k, v, w, dy, base, T, K, tid);
  pf.store(sm.st[0], tid);
  if (ntask > 1)
    pf.load(task_of(1, nsub, nck), r, k, v, w, dy, base, T, K, tid);
  __syncthreads();

  for (int n = 0; n < ntask; ++n) {
    const Task t = task_of(n, nsub, nck);
    // a ring of 3 stages: task n + 1's may overwrite task n - 2's, whose
    // last readers passed the barrier of task n - 1
    if (n + 1 < ntask) pf.store(sm.st[(n + 1) % kRing], tid);
    if (n + 2 < ntask)
      pf.load(task_of(n + 2, nsub, nck), r, k, v, w, dy, base, T, K, tid);
    const Stage& x = sm.st[n % kRing];
    const int c = t.g / kQ, q = t.g % kQ;

    if (t.kind == kL) {
      if (q == 0) {                  // the stretch's start, in the last slot
        rt_cp_async_wait<0>();
        get(sm.slot[kQ - 1], tid, S);
        put(sm.slot[0], tid, S);
      }
      advance(S, x.w, x.k, x.v, i0, j0);
      put(sm.slot[q + 1], tid, S);
      __syncthreads();
      continue;
    }

    // R: S before the sub-chunk
    if (t.Q == 1) {
      rt_cp_async_wait<0>();
      get(sm.slot[kQ - 1], tid, S);
    } else {
      get(sm.slot[q], tid, S);
    }
    // partials and dot products of tasks n and n - 1 in turn: task n + 1
    // writes these again only after the barrier that follows task n's
    // readers
    Parts& P = sm.part[n & 1];
    float* vdy = sm.vdy[n & 1];
    float* ruk = sm.ruk[n & 1];
    {                                // warp s: step s's two dot products
      const int s = warp;
      const int l2 = lane + 32;
      float vd = x.v[s][lane] * x.dy[s][lane] + x.v[s][l2] * x.dy[s][l2];
      float rk = x.r[s][lane] * sm.u[lane] * x.k[s][lane]
                 + x.r[s][l2] * sm.u[l2] * x.k[s][l2];
      vd = rt_warp_sum(vd);
      rk = rt_warp_sum(rk);
      if (lane == 0) {
        vdy[s] = vd;
        ruk[s] = rk;
      }
    }
    // forward over the sub-chunk: S_{t-1} into registers
    float hist[kSub][kE];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      float wa[4], ka[4], vb[4];
      ld4(&x.w[s][i0], wa);
      ld4(&x.k[s][i0], ka);
      ld4(&x.v[s][j0], vb);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          hist[s][a * 4 + b] = S[a * 4 + b];
          S[a * 4 + b] = fmaf(wa[a], S[a * 4 + b], ka[a] * vb[b]);
        }
    }
    // the previous stretch's start into the last slot, now that its last
    // reader (this task's S) has used it
    if (q == t.Q - 1 && c > 0) {
      const float4* src = ckb
          + static_cast<size_t>(c - 1) * (kE / 4) * kThreads + tid;
#pragma unroll
      for (int e = 0; e < kE / 4; ++e)
        rt_cp_async16(&sm.slot[kQ - 1][e][tid], src + e * kThreads, true,
                      policy);
      rt_cp_async_commit();
    }
    // back over it with G: S_{t-1} dy, G v, G * S_{t-1}, G^T k
#pragma unroll
    for (int s = kSub - 1; s >= 0; --s) {
      float wa[4], ka[4], ra[4], vb[4], yb[4];
      ld4(&x.w[s][i0], wa);
      ld4(&x.k[s][i0], ka);
      ld4(&x.r[s][i0], ra);
      ld4(&x.v[s][j0], vb);
      ld4(&x.dy[s][j0], yb);
      float pr[4], pk[4], pw[4], pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float* h = &hist[s][a * 4];
        const float* gg = &G[a * 4];
        pr[a] = h[0] * yb[0];
        pk[a] = gg[0] * vb[0];
        pw[a] = gg[0] * h[0];
#pragma unroll
        for (int b = 1; b < 4; ++b) {
          pr[a] = fmaf(h[b], yb[b], pr[a]);
          pk[a] = fmaf(gg[b], vb[b], pk[a]);
          pw[a] = fmaf(gg[b], h[b], pw[a]);
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        pv[b] = G[b] * ka[0];
#pragma unroll
        for (int a = 1; a < 4; ++a) pv[b] = fmaf(G[a * 4 + b], ka[a], pv[b]);
      }
      sum_cols(pr, cq, &P.r[s][cb][i0]);
      sum_cols(pk, cq, &P.k[s][cb][i0]);
      sum_cols(pw, cq, &P.w[s][cb][i0]);
      sum_rows(pv, rq, &P.v[s][rb][j0]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          G[a * 4 + b] = fmaf(wa[a], G[a * 4 + b], ra[a] * yb[b]);
    }
    __syncthreads();
    // the sums at (step, channel ec) for the thread's kPer steps, over the
    // tiles in order
    const int t0 = t.g * kSub;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int s = (tid + m * kThreads) / kK;
      if (t0 + s >= T || ec >= K) continue;
      float sr = 0.f, sk = 0.f, sw = 0.f, sv = 0.f;
#pragma unroll
      for (int p = 0; p < kCB; ++p) {
        sr += P.r[s][p][ec];
        sk += P.k[s][p][ec];
        sw += P.w[s][p][ec];
      }
#pragma unroll
      for (int p = 0; p < kRB; ++p) sv += P.v[s][p][ec];
      const float rr = x.r[s][ec];
      const float kv = x.k[s][ec] * vdy[s];
      const size_t g = base + static_cast<size_t>(t0 + s) * K + ec;
      dr[g] = rt_from_f32<Tin>(sr + sm.u[ec] * kv);
      dk[g] = rt_from_f32<Tin>(sk + sm.u[ec] * rr * vdy[s]);
      dv[g] = rt_from_f32<Tin>(sv + x.dy[s][ec] * ruk[s]);
      dw[g] = sw;
      du_acc += rr * kv;
    }
  }
  // du of this row: each thread's steps, then the 4 threads of a channel
  sm.du[tid / kK][ec] = du_acc;
  __syncthreads();
  if (tid < K) {
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < kThreads / kK; ++q) acc += sm.du[q][tid];
    du_rows[static_cast<size_t>(bh) * K + tid] = acc;
  }
}

// du[q][i] = sum over m of du_rows[m * U + q][i], m in order: the rows
// bh that take u[bh % U]
__global__ void rwkv_du_kernel(const float* __restrict__ du_rows,
                               float* __restrict__ du, int BH, int K, int U) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= U * K) return;
  float acc = 0.f;
  for (int m = 0; m < BH / U; ++m)
    acc += du_rows[static_cast<size_t>(m) * U * K + idx];
  du[idx] = acc;
}

template <typename Tin, typename Tdy>
cudaError_t launch_typed(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const void* dy,
                         const float* ds, void* dr, void* dk, void* dv,
                         float* dw, float* du, float* du_rows, float* ck,
                         int BH, int T, int K, int U, cudaStream_t stream) {
  auto kernel = rwkv_chunk_bwd_kernel<Tin, Tdy>;
  static cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (configured != cudaSuccess) return configured;
  kernel<<<BH, kThreads, sizeof(Smem), stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), w, u, static_cast<const Tdy*>(dy), ds,
      static_cast<Tin*>(dr), static_cast<Tin*>(dk), static_cast<Tin*>(dv),
      dw, du_rows, reinterpret_cast<float4*>(ck), T, K, U);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rwkv_du_kernel<<<(U * K + 255) / 256, 256, 0, stream>>>(du_rows, du, BH,
                                                          K, U);
  return cudaGetLastError();
}

}  // namespace

// r, k, v: (BH, T, K) of in_dtype; w: (BH, T, K) f32; u: (U, K) f32 with
// BH % U == 0; dy: (BH, T, K) of dy_dtype; ds: (BH, K, K) f32 or null.
// Out: dr, dk, dv (BH, T, K) of in_dtype; dw (BH, T, K) f32; du (U, K)
// f32. Scratch: du_rows (BH, K) f32 and ck (BH, ceil(T/32), 4096) f32,
// 16-byte aligned. All contiguous; 1 <= K <= 64, T >= 1.
extern "C" int rwkv_chunk_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* dy, const void* ds, void* dr, void* dk,
    void* dv, void* dw, void* du, void* du_rows, void* ck, int BH, int T,
    int K, int U, int in_dtype, int dy_dtype, void* stream) {
  if (BH < 1 || T < 1 || K < 1 || K > kK || U < 1 || BH % U
      || reinterpret_cast<uintptr_t>(ck) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *wf = static_cast<const float*>(w),
              *uf = static_cast<const float*>(u),
              *dsf = static_cast<const float*>(ds);
  float *dwf = static_cast<float*>(dw), *duf = static_cast<float*>(du),
        *rows = static_cast<float*>(du_rows), *ckf = static_cast<float*>(ck);
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == RT_F32 && dy_dtype == RT_F32)
    err = launch_typed<float, float>(r, k, v, wf, uf, dy, dsf, dr, dk, dv,
                                     dwf, duf, rows, ckf, BH, T, K, U, s);
  else if (in_dtype == RT_BF16 && dy_dtype == RT_F32)
    err = launch_typed<__nv_bfloat16, float>(r, k, v, wf, uf, dy, dsf, dr,
                                             dk, dv, dwf, duf, rows, ckf, BH,
                                             T, K, U, s);
  else if (in_dtype == RT_BF16 && dy_dtype == RT_BF16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        r, k, v, wf, uf, dy, dsf, dr, dk, dv, dwf, duf, rows, ckf, BH, T, K,
        U, s);
  else if (in_dtype == RT_F32 && dy_dtype == RT_BF16)
    err = launch_typed<float, __nv_bfloat16>(r, k, v, wf, uf, dy, dsf, dr, dk,
                                             dv, dwf, duf, rows, ckf, BH, T,
                                             K, U, s);
  return static_cast<int>(err);
}
