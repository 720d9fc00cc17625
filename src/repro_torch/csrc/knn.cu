// knn.cu — fused brute-force k-NN of Q[q,d] against a shared DB[n,d].
//
// Replaces: src/repro/kernels/topk.py::knn_pallas (pallas_call at :132,
// _knn_kernel at :67-84), the exact ground truth behind every recall figure
// (repro/baselines/exact.py:21).
//
// Function: dists[q, k] ascending and ids[q, k] (global DB rows), ties
// broken lower id first (lax.top_k's order); the [q, n] matrix never
// reaches device memory.
//
// What bounds it on the H100: operations. On the main path (q = 1000
// queries, n = 1,000,000, d = 100) it does 2*q*n*d = 2e11 FLOPs against
// ~0.4 GB of input, ~500 FLOP per byte. In fp32 on the CUDA cores that is
// 2.99 ms; the Gram forms take the tensor cores at a precision the ranking
// can trust (3xTF32, three TF32 products per fp32 product): 1.21 ms.
//
// Design. The TPU kernel carries each query tile's top-k state from one
// sequential grid step to the next (topk.py:70-84); CUDA blocks cannot, so
// the grid is query tiles x DB splits (one wave of one block per SM), and
// a second small kernel merges the per-split lists of each query.
// - A block holds BQ queries (128 for small k; the wrapper picks 64, 32 or
//   16 where k's states or d's rows would not fit in shared memory), so the
//   DB is read from L2 once per 128 queries, not once per 16.
// - The split's DB rows stream in 128-row tiles, KB columns of d at a
//   time, double-buffered through shared memory by cp.async (zero-filled
//   past d and past the split), so loads overlap the products; d is padded
//   to the MMA depth with zeros.
// - Two routes share one body (knn_tile), chosen by topk.knn_geometry:
//   * wgmma (knn_kernel): the block's queries sit whole in shared memory,
//     KB = 64. Taken where they and the states fit (d + k up to ~1,230
//     for the Gram forms, k <= 1024).
//   * stream (knn_stream_kernel): Q streams through the same ring as the
//     DB, KB = 32 columns of both a stage, three stages deep, so no row is
//     held whole and any d works. Gram forms: a small kernel first splits
//     Q into TF32 hi and lo in core-matrix order (knn_split_kernel), and
//     each stage arrives by two TMA copies on an mbarrier, the DB tile
//     128-byte swizzled (so the ldmatrix reads stay conflict-free) and the
//     block's split queries as wgmma's B, with no split a stage; d a
//     multiple of 4 (the wrapper pads others with zero columns). l1 and
//     chebyshev: cp.async (full stages by shifts, load_full). Where the BQ
//     states do not fit in shared memory (k past ~1,400) they live in the
//     split's output lists in device memory, so k is bounded only by the
//     merge kernel (6k floats: k <= 9,685).
// - Gram forms: wgmma on two warpgroups, each multiplying 64 DB rows of the
//   tile (A, from registers) by all BQ queries (B, from shared memory).
//   Q is split as x = hi + lo, hi = tf32(x), lo = tf32(x - hi), into
//   core-matrix order: once per block (wgmma) or once per call (stream);
//   each warp reads its DB fragment by ldmatrix and splits it in registers
//   (the stream route rounding by integer arithmetic, tf32_int). Each product is lo*Qhi + hi*Qlo + hi*Qhi,
//   accumulated in fp32 (~22 mantissa bits: the ranking of fp32, which
//   plain TF32's 11 bits are not); the next fragment is split while the
//   tensor cores run. The tensor cores add into their accumulator without
//   full fp32 rounding, a drift that grows with d: past d = 128
//   (PROMOTE_D) each stage's products go to a fresh accumulator that is
//   then added to the running one in fp32, as in pairwise.cu. Norms stay
//   exact fp32 (launch_sqnorm), read once per block (queries) and ahead of
//   each tile's last products (DB rows).
// - l1 and chebyshev have no product: the same tiles and ring, with fp32
//   register micro-tiles of 8 queries x 8 DB rows a thread at BQ = 128
//   (16-byte shared loads), laid out as an MMA accumulator.
// - Top-k without a block barrier per candidate: a thread marks, branch
//   free, its queries whose least value is at or below the query's bound
//   (its k-th entry, kept in registers and read again after merges); only
//   those are visited, their values picked by selects, and only values that
//   beat the k-th go, by a shared atomicAdd, to a 32-slot per-query buffer
//   in shared memory. One barrier a tile asks whether a buffer reached 2k
//   entries (k of them bound the k-th) or overflowed; only then (those
//   queries, listed as they fill and dealt to the warps in turn), and once
//   at the end of the split, a warp per query merges buffer and state by
//   rank under key_less's strict (distance, id) order, so the result does
//   not depend on append order. A value that found its buffer full is
//   retried after the merge against the new k-th; a value that did not
//   beat the k-th never will. l2 ranks by d^2 there and takes the square
//   root only of values that may enter.
// - What holds it back (PERF.md; tools/kernel_phases.py): on the wgmma
//   route the products alone take ~60% of the kernel's time at ~45% of the
//   3xTF32 bound; waits on the ring, merges and the tile's barrier take
//   most of the rest. On the streaming route (d = 1536) the products take
//   ~70% of the warps' cycles and reach ~60% of the bound alone; the
//   stage barrier ~15%, the epilogue ~13%; the promotion costs ~6%. A
//   cp.async ring with a split a stage spent as much on issuing copies and
//   splitting as on the products (tools/knn_stream_stage.cu), hence TMA.
#include <cudaTypedefs.h>  // CUtensorMap and the driver's encoder type
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

using namespace pdasc;

namespace {

constexpr int TN = 128;          // DB rows per tile
constexpr int BK = 64;           // columns of d per ring stage (wgmma route)
constexpr int STREAM_BK = 32;    // columns of d per ring stage, Q's too (stream)
constexpr int STAGES = 2;        // double buffer (wgmma route)
constexpr int STREAM_STAGES = 3; // triple buffer (stream: a load has two stages to land)
constexpr int CAP = 32;          // candidate slots per query: one per lane in a merge
constexpr int THREADS = 256, NWARPS = THREADS / 32;  // two warpgroups
constexpr int MERGE_THREADS = 128;
constexpr int PROMOTE_D = 128;   // longer d: promote each stage's products

__host__ __device__ constexpr bool is_gram(int form) { return form <= DOT; }

// Floats of one stage of the streaming route's ring. Gram forms: TN DB rows
// of STREAM_BK columns as the tensor-memory accelerator (TMA) lays them
// out (dense, 128-byte swizzled), then the stage's queries, pre-split,
// [2][bq][STREAM_BK] TF32 hi and lo in core-matrix order. The others: TN
// DB rows and bq query rows, padded to STREAM_BK + 4.
__host__ __device__ constexpr size_t stream_stage_floats(int bq, bool gram) {
  return gram ? (size_t)(TN + 2 * bq) * STREAM_BK : (size_t)(TN + bq) * (STREAM_BK + 4);
}

// Shared bytes of one block; mirrored by topk.knn_smem_bytes (wgmma) and
// topk.knn_stream_smem_bytes (stream). wgmma: Q takes [bq][dpad] twice (TF32
// hi and lo, core-matrix order) for the Gram forms, [bq][dpad + 4] once
// (padded rows) for the others, and the ring TN rows a stage. stream: 32
// bytes of stage barriers and 1 KB to align the ring to the swizzle's
// 1024 bytes, then the ring. Then the states (unless they live in device
// memory), the buffers, the per-query k-th entries and the list of queries
// to merge.
size_t smem_bytes(int bq, int d, int k, bool gram, bool stream, bool shared_states) {
  const size_t dpad = (size_t)(d + 7) / 8 * 8;
  const size_t q = stream ? (32 + 1024) / 4 : (gram ? 2 * dpad : dpad + 4) * bq;
  const size_t ring = stream ? STREAM_STAGES * stream_stage_floats(bq, gram)
                             : (size_t)STAGES * TN * (BK + 4);
  return 4 * (q + ring + (shared_states ? 2 * (size_t)bq * k : 0) +
              2 * (size_t)bq * CAP + 5 * (size_t)bq + 2);
}

// l2 ranks by d^2 until a value may enter: sqrt is monotone and correctly
// rounded, so d^2 > kd^2 (1 + 2^-18) (a margin above fp32 rounding) puts
// sqrt(d^2) above kd. Capped at the largest float, so that a row still at
// its initial BIG (a query past nq) lets no +inf value through.
__device__ __forceinline__ float sqrt_limit(float kd) {
  return fminf(kd * kd * 1.0000039f, 3.4028235e38f);
}

// Merge the candidate buffers of the queries listed in todo[0, todo[rows])
// (or, with todo null, of every query with an entry) into their ascending
// top-k states, one warp per query, and note each new k-th entry (kdv,
// kiv; klim the bound values are tested against). A buffer
// entry's new rank is its rank in the buffer plus the state entries below
// it; a state entry moves right by the buffer entries below it. State
// entries are read and moved 32 at a time from the right, so no entry is
// overwritten before it is read; buffer entries land last, on the ranks
// left free. The states may lie in shared or device memory. Ends with a
// block barrier.
template <bool SQRT_LIMIT>
__device__ void merge_rows(float* sd, int* si, const float* bd, const int* bi,
                           int* cnt, float* kdv, int* kiv, float* klim, int* todo,
                           int rows, int k) {
  const int lane = threadIdx.x & 31;
  const int m = todo ? todo[rows] : rows;
  if (todo) {  // every warp has read the count: it may be cleared
    __syncthreads();
    if (threadIdx.x == 0) todo[rows] = 0;
  }
  for (int w = threadIdx.x >> 5; w < m; w += NWARPS) {
    const int r = todo ? todo[w] : w;
    const int c = min(cnt[r], CAP);
    if (c == 0) continue;  // warp-uniform
    float* s_d = sd + (size_t)r * k;
    int* s_i = si + (size_t)r * k;
    const float* b_d = bd + r * CAP;
    const int* b_i = bi + r * CAP;
    float ed = 0.0f;
    int ei = 0, pe = k;
    if (lane < c) {
      ed = b_d[lane];
      ei = b_i[lane];
      int rank = 0;
      for (int j = 0; j < c; ++j) rank += key_less(b_d[j], b_i[j], ed, ei);
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_less(s_d[mid], s_i[mid], ed, ei)) lo = mid + 1; else hi = mid;
      }
      pe = rank + lo;
    }
    for (int base = (k - 1) & ~31; base >= 0; base -= 32) {
      const int i = base + lane;
      float v = 0.0f;
      int id = 0, p = i;
      if (i < k) {
        v = s_d[i];
        id = s_i[i];
        for (int j = 0; j < c; ++j) p += key_less(b_d[j], b_i[j], v, id);
      }
      // a chunk where nothing moves: nothing to its left moves either
      if (__all_sync(0xffffffffu, p == i)) break;
      __syncwarp();
      if (i < k && p != i && p < k) { s_d[p] = v; s_i[p] = id; }
      __syncwarp();
    }
    if (pe < k) { s_d[pe] = ed; s_i[pe] = ei; }
    __syncwarp();
    if (lane == 0) {
      cnt[r] = 0;
      kdv[r] = s_d[k - 1];
      kiv[r] = s_i[k - 1];
      klim[r] = SQRT_LIMIT ? sqrt_limit(s_d[k - 1]) : s_d[k - 1];
    }
  }
  __syncthreads();
}

// load_rows for a stage whose W columns all lie within d, rows 16-byte
// aligned: each thread's copies found by shifts, one row guard a copy.
template <int ROWS, int STRIDE, int NTHREADS, int W>
__device__ __forceinline__ void load_full(float* st, const float* A, int r0, int rows,
                                          int d, int c0) {
  constexpr int PER = W / 4, RSTEP = NTHREADS / PER;  // 16-byte copies a row
  const int c = 4 * (threadIdx.x % PER);
#pragma unroll
  for (int r = threadIdx.x / PER; r < ROWS; r += RSTEP) {
    const bool ok = r0 + r < rows;
    cp_async16(st + r * STRIDE + c, ok ? A + (size_t)(r0 + r) * d + c0 + c : A, ok);
  }
}

// The streaming route's Gram forms load a stage by two TMA copies that
// complete on the stage's mbarrier: the DB tile (a 2-D tensor map) and the
// block's pre-split queries (a 4-D one). 2 copies a stage where cp.async
// took 2,048, and no split a stage (tools/knn_stream_stage.cu measured the
// issue of those copies and the split at as much as the products).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// One arrival, and `bytes` more to come from TMA copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int x, int y,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, int x, int y, int z,
                                       int w, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(z), "r"(w), "r"(smem_addr(bar))
      : "memory");
}

// The streaming route's queries, split once for every DB tile and stage:
// qs[half][group of 8 rows][dpad / 4][8][4] (half 0 TF32 hi, 1 lo), rows
// past nq and columns past d zero: a stage's slice is a box of the 4-D
// tensor map over it, in core-matrix order.
__global__ void knn_split_kernel(const float* __restrict__ Q, float* __restrict__ qs, int nq,
                                 int nq_pad, int d, int dpad) {
  const size_t half = (size_t)nq_pad * dpad;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= half) return;
  const int r = (int)(e / dpad), c = (int)(e % dpad);
  const float x = r < nq && c < d ? Q[(size_t)r * d + c] : 0.0f;
  const uint32_t h = tf32_int(x);
  const size_t o = ((size_t)(r >> 3) * (dpad >> 2) + (c >> 2)) * 32 + (r & 7) * 4 + (c & 3);
  qs[o] = __uint_as_float(h);
  qs[half + o] = __uint_as_float(tf32_int(x - __uint_as_float(h)));
}

// One block: BQ queries against one DB split. STREAM: Q streams through the
// ring with the DB (any d; Gram forms: by TMA, dbmap and qmap, the queries
// split beforehand); else it is staged whole. PROMOTE (Gram forms): each
// stage's products are added to the running sums in fp32. gstates: the
// states live in the split's output lists (part_d, part_i) in device memory.
template <int FORM, int BQ, bool STREAM, bool PROMOTE>
__device__ __forceinline__ void knn_tile(const float* __restrict__ Q,
                                         const float* __restrict__ DB,
                                         const float* __restrict__ qq,
                                         const float* __restrict__ dd,
                                         float* __restrict__ part_d,
                                         int* __restrict__ part_i, int nq, int n,
                                         int d, int k, int chunk, int gstates,
                                         const CUtensorMap* dbmap, const CUtensorMap* qmap) {
  constexpr bool GRAM = is_gram(FORM);
  constexpr bool NORMS = FORM == SQEUCLIDEAN || FORM == L2 || FORM == COSINE;
  constexpr bool LATE_SQRT = FORM == L2;  // see sqrt_limit
  constexpr int KB = STREAM ? STREAM_BK : BK;      // columns a stage
  constexpr int NST = STREAM ? STREAM_STAGES : STAGES;  // ring stages
  constexpr int RS = KB + 4;                       // stage row stride: conflict-free reads
  constexpr bool TMA = STREAM && GRAM;             // stages loaded by TMA
  constexpr int STAGE = STREAM ? (int)stream_stage_floats(BQ, GRAM) : TN * RS;
  // The accumulator of a warp is WM x WN tiles of 16 x 8. Gram: a warp's
  // 16 DB rows (wgmma's A) times all BQ queries, so rows are DB rows and
  // columns queries. VPU: rows are queries and columns DB rows.
  constexpr int WARPS_M = GRAM ? NWARPS : BQ >= 32 ? 2 : 1, WARPS_N = NWARPS / WARPS_M;
  constexpr int WM = GRAM ? 1 : BQ / WARPS_M / 16;
  constexpr int WN = GRAM ? BQ / 8 : TN / WARPS_N / 8;
  constexpr int NV = WM * WN * 4;
  constexpr int QA = GRAM ? WN : WM, VA = GRAM ? WM : WN;  // query groups, values a group
  static_assert(NV <= 64 && 2 * QA <= 32, "a 64-bit value mask, a 32-bit query mask");
  static_assert(!PROMOTE || GRAM, "only products are promoted");

  extern __shared__ __align__(16) float smem[];
  const int dpad = (d + 7) & ~7;
  // wgmma: Q (or its TF32 hi and lo), then the ring. stream: the stage
  // barriers, then the ring, 1024-byte aligned.
  const int qs = GRAM ? dpad : dpad + 4;           // wgmma: a staged Q row
  const int qcols = STREAM ? KB : dpad;            // columns of the split Q
  uint64_t* bar = (uint64_t*)smem;                 // stream: [NST] full stages
  float* ring = STREAM ? (float*)(((uintptr_t)(smem + 8) + 1023) & ~(uintptr_t)1023)
                       : smem + (GRAM ? 2 : 1) * BQ * qs;  // [NST][STAGE]
  float* Qh = smem;                                // wgmma: the staged Q
  float* Ql = Qh + BQ * qcols;
  float* tail = STREAM ? (float*)smem + (32 + 1024) / 4 + NST * STAGE : ring + NST * STAGE;
  float* sd;                                       // [BQ][k] states
  int* si;
  if (gstates) {
    const size_t o = ((size_t)blockIdx.y * nq + blockIdx.x * BQ) * k;
    sd = part_d + o;
    si = part_i + o;
  } else {
    sd = tail;
    si = (int*)(sd + (size_t)BQ * k);
    tail = (float*)(si + (size_t)BQ * k);
  }
  float* bd = tail;                                   // [BQ][CAP] buffers
  int* bi = (int*)(bd + BQ * CAP);
  float* kdv = (float*)(bi + BQ * CAP);               // [BQ] k-th entry
  int* kiv = (int*)(kdv + BQ);
  float* klim = (float*)(kiv + BQ);                   // [BQ] bound a value must meet
  int* cnt = (int*)(klim + BQ);  // [BQ] buffer fill; [BQ]: the last pass that overflowed
  int* todo = cnt + BQ + 1;      // [BQ] queries to merge; [BQ]: their count

  const int q0 = blockIdx.x * BQ;
  const int n0 = blockIdx.y * chunk;
  const int n1 = min(n, n0 + chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / WARPS_N) * (GRAM ? 16 : BQ / WARPS_M);
  const int col0 = (warp % WARPS_N) * (TN / WARPS_N);
  // ldmatrix row addresses of the A fragment (DB rows of the stage): rows
  // of matrix l / 8 are +8 for odd matrices, columns +4 for the upper two
  const int lm = lane >> 3, lr = lane & 7;
  const int a_row = row0 + lr + 8 * (lm & 1);
  const int a_off = a_row * RS + 4 * (lm >> 1);
  const uint32_t q_sbo = (uint32_t)qcols * 32;  // bytes between 8-query groups

  // A buffer is merged once it holds 2k entries (k of them alone bound the
  // k-th), or when it overflows; the others wait, as merges cost a barrier.
  // Only an overflow makes the tile's values go round again; `pass` numbers
  // the rounds, so the overflow mark needs no reset.
  const int fill = min(2 * k, CAP);
  int pass = 0;
  const int nch = (dpad + KB - 1) / KB;
  const int steps = (n1 - n0 + TN - 1) / TN * nch;
  const bool rows16 = (d & 3) == 0 && ((size_t)DB & 15) == 0 && ((size_t)Q & 15) == 0;
  auto issue = [&](int s) {
    if (s < steps) {
      float* st = ring + (s % NST) * STAGE;
      const int c0 = (s % nch) * KB, w = min(KB, dpad - c0), t0 = n0 + (s / nch) * TN;
      if (TMA) {  // rows past n and columns past d arrive as zeros
        if (threadIdx.x == 0) {
          uint64_t* b = bar + s % NST;
          mbar_expect(b, STAGE * 4);
          tma_2d(st, dbmap, c0, t0, b);
          tma_4d(st + TN * KB, qmap, 0, c0 / 4, q0 / 8, 0, b);
        }
      } else if (STREAM && rows16 && c0 + KB <= d) {  // a full stage
        load_full<TN, RS, THREADS, KB>(st, DB, t0, n1, d, c0);
        load_full<BQ, RS, THREADS, KB>(st + TN * RS, Q, q0, nq, d, c0);
      } else {
        load_rows<TN, RS, THREADS>(st, DB, t0, n1, d, c0, w);
        if (STREAM) load_rows<BQ, RS, THREADS>(st + TN * RS, Q, q0, nq, d, c0, w);
      }
    }
    cp_commit();  // empty groups keep the wait count uniform
  };
  if (TMA) {
    if (threadIdx.x < NST) mbar_init(bar + threadIdx.x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) issue(s);

  if (!STREAM) {
    for (int e = threadIdx.x; e < BQ * dpad; e += THREADS) {
      const int r = e / dpad, c = e % dpad, gq = q0 + r;
      const float x = (gq < nq && c < d) ? Q[(size_t)gq * d + c] : 0.0f;
      if constexpr (GRAM) {  // core-matrix order: 8 queries x 4 columns in 128 bytes
        const int o = ((r >> 3) * (dpad >> 2) + (c >> 2)) * 32 + (r & 7) * 4 + (c & 3);
        const uint32_t h = tf32(x);
        Qh[o] = __uint_as_float(h);
        Ql[o] = __uint_as_float(tf32(x - __uint_as_float(h)));
      } else {
        Qh[r * qs + c] = x;
      }
    }
  }
  for (int e = threadIdx.x; e < BQ * k; e += THREADS) {
    if (gstates && q0 + e / k >= nq) break;  // no list past the queries
    sd[e] = BIG;
    si[e] = e % k - k;  // distinct negative ids: below any real id at BIG
  }
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    kdv[r] = BIG;  // the initial state's k-th entry
    kiv[r] = -1;
    klim[r] = LATE_SQRT ? sqrt_limit(BIG) : BIG;
    cnt[r] = 0;
  }
  if (threadIdx.x == 0) cnt[BQ] = todo[BQ] = 0;

  // acc[(mt * WN + nt) * 4 + e]: row row0 + 16 mt + g + 8 (e >> 1), column
  // col0 + 8 nt + 2 t + (e & 1). A query group is one query of the thread
  // (qa, qb); its values are (va, vb).
  auto idx = [](int qa, int qb, int va, int vb) {
    return GRAM ? (va * WN + qa) * 4 + 2 * vb + qb : (qa * WN + va) * 4 + 2 * qb + vb;
  };
  auto query_of = [&](int qa, int qb) {  // within the block
    return GRAM ? col0 + 8 * qa + 2 * t + qb : row0 + 16 * qa + g + 8 * qb;
  };
  auto row_of = [&](int va, int vb) {  // DB row within the tile
    return GRAM ? row0 + 16 * va + g + 8 * vb : col0 + 8 * va + 2 * t + vb;
  };
  // ||q||^2 of the thread's queries and their bounds (klim, read again
  // after merges) stay in registers across the tile; the promoting
  // variants, which hold a second accumulator, read them at each tile's
  // epilogue instead, so as not to spill.
  float qn[QA][2], dn[VA][2] = {};  // ... and ||y||^2 of the thread's rows
  float lim[QA][2];
  auto load_qn = [&]() {
#pragma unroll
    for (int qa = 0; qa < QA; ++qa)
#pragma unroll
      for (int qb = 0; qb < 2; ++qb) {
        const int gq = q0 + query_of(qa, qb);
        qn[qa][qb] = (NORMS && gq < nq) ? qq[gq] : 0.0f;
      }
  };
  auto load_lim = [&]() {
#pragma unroll
    for (int qa = 0; qa < QA; ++qa)
#pragma unroll
      for (int qb = 0; qb < 2; ++qb) lim[qa][qb] = klim[query_of(qa, qb)];
  };
  if (!PROMOTE) {
    load_qn();
#pragma unroll
    for (int qa = 0; qa < QA; ++qa)
#pragma unroll
      for (int qb = 0; qb < 2; ++qb) lim[qa][qb] = LATE_SQRT ? sqrt_limit(BIG) : BIG;
  }
  float acc[NV], part[PROMOTE ? NV : 1];  // part: the stage's products (PROMOTE)
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
  uint32_t ah[2][4] = {}, al[2][4] = {};  // A fragments (hi, lo), double-buffered

  for (int s = 0; s < steps; ++s) {
    cp_wait<NST - 2>();
    if (TMA) mbar_wait(bar + s % NST, (s / NST) & 1);
    __syncthreads();
    issue(s + NST - 1);
    const float* st = ring + (s % NST) * STAGE;
    const int c0 = (s % nch) * KB, ks = min(KB, dpad - c0) / 8;
    const bool last = s % nch == nch - 1;
    const int tb = n0 + (s / nch) * TN;
    if (NORMS && last) {  // issued ahead of the products they wait behind
#pragma unroll
      for (int va = 0; va < VA; ++va)
#pragma unroll
        for (int vb = 0; vb < 2; ++vb) {
          const int gn = tb + row_of(va, vb);
          dn[va][vb] = gn < n1 ? dd[gn] : 0.0f;
        }
    }
    if constexpr (GRAM) {
      // Each k-step: split this warp's A fragment (16 DB rows x 8) into hi
      // and lo, then lo*Qhi + hi*Qlo + hi*Qhi on the warpgroup's tensor
      // cores. The next fragment is split while those run. With PROMOTE the
      // stage's products go to `part`, added to acc in fp32 after. (TMA: the
      // DB tile's 16-byte chunk c of row r lies at chunk c ^ (r % 8).)
      const float* qh_s = TMA ? st + TN * KB : Qh;  // the split queries
      const float* ql_s = TMA ? qh_s + BQ * KB : Ql;
      auto split = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
        uint32_t raw[4];
        ldsm_x4(raw, TMA ? st + a_row * KB + (((2 * kk + (lm >> 1)) ^ (a_row & 7)) << 2)
                         : st + a_off + kk * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // (the stream route rounds at the integer rate)
          const float x = __uint_as_float(raw[i]);
          h[i] = STREAM ? tf32_int(x) : tf32(x);
          l[i] = STREAM ? tf32_int(x - __uint_as_float(h[i])) : tf32(x - __uint_as_float(h[i]));
        }
      };
      split(0, ah[0], al[0]);
#pragma unroll
      for (int kk = 0; kk < KB / 8; ++kk) {
        if (kk >= ks) break;
        const int b = kk & 1;
        const int kc = (STREAM ? 0 : c0) + kk * 8;  // column of the split Q
        const uint64_t dh = kmajor_desc(qh_s + kc * 8, q_sbo);
        const uint64_t dl = kmajor_desc(ql_s + kc * 8, q_sbo);
        wg_fence();
        if constexpr (PROMOTE) {
          Wgmma<BQ>::run(part, al[b], dh, kk > 0);
          Wgmma<BQ>::run(part, ah[b], dl);
          Wgmma<BQ>::run(part, ah[b], dh);
        } else {
          Wgmma<BQ>::run(acc, al[b], dh);
          Wgmma<BQ>::run(acc, ah[b], dl);
          Wgmma<BQ>::run(acc, ah[b], dh);
        }
        wg_commit();
        if (kk + 1 < ks) {
          wg_wait<1>();  // the products of step kk - 1 are done: its buffer is free
          keep(ah[b ^ 1]);
          keep(al[b ^ 1]);
          split(kk + 1, ah[b ^ 1], al[b ^ 1]);
        }
      }
      wg_wait<0>();
      if constexpr (PROMOTE) {
        keep(part);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] += part[i];
      }
      keep(acc);
      keep(ah[0]);
      keep(al[0]);
      keep(ah[1]);
      keep(al[1]);
    } else {
      // Q rows: the stage's slice (stream) or the staged rows from column c0
      const float* qrow = STREAM ? st + TN * RS : Qh + c0;
      const int qstride = STREAM ? RS : qs;
      for (int kc = 0; kc < ks * 8; kc += 4) {
        float4 a[WM][2], b[WN][2];
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[mt][h] = *(const float4*)(qrow + (row0 + mt * 16 + g + 8 * h) * qstride + kc);
#pragma unroll
        for (int nt = 0; nt < WN; ++nt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1)
            b[nt][e1] = *(const float4*)(st + (col0 + nt * 8 + 2 * t + e1) * RS + kc);
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int nt = 0; nt < WN; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 x = a[mt][e >> 1], y = b[nt][e & 1];
              float& c = acc[(mt * WN + nt) * 4 + e];
              c = accumulate<FORM>(c, x.x, y.x);
              c = accumulate<FORM>(c, x.y, y.y);
              c = accumulate<FORM>(c, x.z, y.z);
              c = accumulate<FORM>(c, x.w, y.w);
            }
      }
    }
    if (!last) continue;

    // ---- epilogue of the tile: distances, then candidates -----------------
    // Values outside the queries or the split become +inf: never below a
    // k-th entry, which is at most BIG.
    if (PROMOTE) {  // klim is visible: the stage began with a block barrier
      load_qn();
      load_lim();
    }
#pragma unroll
    for (int qa = 0; qa < QA; ++qa)
#pragma unroll
      for (int qb = 0; qb < 2; ++qb) {
        const bool qin = q0 + query_of(qa, qb) < nq;
#pragma unroll
        for (int va = 0; va < VA; ++va)
#pragma unroll
          for (int vb = 0; vb < 2; ++vb) {
            float& v = acc[idx(qa, qb, va, vb)];
            v = qin && tb + row_of(va, vb) < n1
                    ? finish<LATE_SQRT ? SQEUCLIDEAN : FORM>(v, qn[qa][qb], dn[va][vb])
                    : INFINITY;
          }
      }
    // Bit i of done: value i appended or ruled out (the k-th only falls).
    // Each round first marks, branch-free, the thread's queries that have a
    // value at or below their bound; only those are visited, their values
    // picked out of the accumulator by selects.
    uint64_t done = 0;
    while (true) {
      ++pass;
      uint32_t may = 0;  // bit 2 qa + qb: query (qa, qb) may take a value
#pragma unroll
      for (int qa = 0; qa < QA; ++qa)
#pragma unroll
        for (int qb = 0; qb < 2; ++qb) {
          float least = INFINITY;
#pragma unroll
          for (int va = 0; va < VA; ++va)
#pragma unroll
            for (int vb = 0; vb < 2; ++vb) least = fminf(least, acc[idx(qa, qb, va, vb)]);
          may |= (uint32_t)(least <= lim[qa][qb]) << (2 * qa + qb);
        }
      int ready = 0;  // a buffer reached `fill`, or overflowed
      while (may) {
        const int gi = __ffs(may) - 1, ga = gi >> 1, gb = gi & 1;
        may &= may - 1;
        float glim = 0.0f, gv[VA][2] = {};
#pragma unroll
        for (int qa = 0; qa < QA; ++qa)
#pragma unroll
          for (int qb = 0; qb < 2; ++qb) {
            const bool hit = 2 * qa + qb == gi;
            glim = hit ? lim[qa][qb] : glim;
#pragma unroll
            for (int va = 0; va < VA; ++va)
#pragma unroll
              for (int vb = 0; vb < 2; ++vb)
                gv[va][vb] = hit ? acc[idx(qa, qb, va, vb)] : gv[va][vb];
          }
        const int qi = query_of(ga, gb);
#pragma unroll
        for (int va = 0; va < VA; ++va)
#pragma unroll
          for (int vb = 0; vb < 2; ++vb) {
            const int i = idx(ga, gb, va, vb);
            if ((done >> i & 1) || !(gv[va][vb] <= glim)) continue;
            const float v = LATE_SQRT ? sqrtf(gv[va][vb]) : gv[va][vb];
            const int id = tb + row_of(va, vb);
            if (key_less(v, id, kdv[qi], kiv[qi])) {
              const int slot = atomicAdd(&cnt[qi], 1);
              if (slot + 1 == fill) {  // enough fresh candidates: merge the query
                ready = 1;
                todo[atomicAdd(&todo[BQ], 1)] = qi;
              }
              if (slot >= CAP) {  // full: retry after the merge
                ready = 1;
                cnt[BQ] = pass;
                continue;
              }
              bd[qi * CAP + slot] = v;
              bi[qi * CAP + slot] = id;
            }
            done |= 1ull << i;
          }
      }
      if (!__syncthreads_or(ready)) break;
      const bool retry = cnt[BQ] == pass;
      merge_rows<LATE_SQRT>(sd, si, bd, bi, cnt, kdv, kiv, klim, todo, BQ, k);
      load_lim();
      if (!retry) break;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
  }
  cp_wait<0>();
  merge_rows<LATE_SQRT>(sd, si, bd, bi, cnt, kdv, kiv, klim, nullptr, BQ, k);

  // The split's list of each query (in place where the states live there)
  for (int e = threadIdx.x; e < BQ * k; e += THREADS) {
    const int gq = q0 + e / k;
    if (gq >= nq) break;
    const size_t o = ((size_t)blockIdx.y * nq + gq) * k + e % k;
    const bool real = si[e] >= 0;  // an init entry holds no DB row
    const float v = sd[e];
    const int id = si[e];
    part_d[o] = real ? v : INFINITY;
    part_i[o] = real ? id : INT_MAX;
  }
}

template <int FORM, int BQ, bool PROMOTE>
__global__ void __launch_bounds__(THREADS, 1)
knn_kernel(const float* __restrict__ Q, const float* __restrict__ DB,
           const float* __restrict__ qq, const float* __restrict__ dd,
           float* __restrict__ part_d, int* __restrict__ part_i, int nq, int n,
           int d, int k, int chunk) {
  knn_tile<FORM, BQ, false, PROMOTE>(Q, DB, qq, dd, part_d, part_i, nq, n, d, k, chunk, 0,
                                     nullptr, nullptr);
}

// The streaming route: every Gram variant promotes (it serves d past ~1,200).
template <int FORM, int BQ>
__global__ void __launch_bounds__(THREADS, 1)
knn_stream_kernel(const float* __restrict__ Q, const float* __restrict__ DB,
                  const float* __restrict__ qq, const float* __restrict__ dd,
                  float* __restrict__ part_d, int* __restrict__ part_i, int nq, int n,
                  int d, int k, int chunk, int gstates,
                  const __grid_constant__ CUtensorMap dbmap,
                  const __grid_constant__ CUtensorMap qmap) {
  knn_tile<FORM, BQ, true, is_gram(FORM)>(Q, DB, qq, dd, part_d, part_i, nq, n, d, k,
                                          chunk, gstates, &dbmap, &qmap);
}

__global__ void __launch_bounds__(MERGE_THREADS)
knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                 float* __restrict__ out_d, int* __restrict__ out_i, int nq, int k,
                 int splits) {
  extern __shared__ __align__(16) float smem[];
  float* sd = smem;
  int* si = (int*)(sd + k);
  float* nd = (float*)(si + k);
  int* ni = (int*)(nd + k);
  float* td = (float*)(ni + k);
  int* ti = (int*)(td + k);
  const size_t q = blockIdx.x;
  init_state(sd, si, k);
  for (int s = 0; s < splits; ++s) {
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += MERGE_THREADS) {
      const size_t o = ((size_t)s * nq + q) * k + i;
      td[i] = part_d[o];
      ti[i] = part_i[o];
    }
    __syncthreads();
    merge_tile(sd, si, nd, ni, td, ti, k, k);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += MERGE_THREADS) {
    out_d[q * k + i] = sd[i];
    out_i[q * k + i] = si[i] < 0 ? -1 : si[i];
  }
}

struct Args {
  const float *Q, *DB, *qq, *dd;
  float* pd;
  int* pi;
  float* qsplit;  // stream, Gram forms: [2][nq rounded up to bq][dpad]
  int nq, n, d, k, chunk, splits;
};

// The streaming route's tensor maps: the DB as [n][d] (boxes of TN rows x
// STREAM_BK columns, 128-byte swizzled; rows past n and columns past d
// read as zeros), and the split queries as [2][nq_pad / 8][dpad / 4][32]
// (boxes of both halves x bq / 8 groups x STREAM_BK / 4 core matrices).
// The encoder comes from the driver through the runtime, so the library
// links no more than before. Returns false where the driver refuses.
bool tensor_maps(const Args& a, int bq, int nq_pad, int dpad, CUtensorMap* dbmap,
                 CUtensorMap* qmap) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = (PFN_cuTensorMapEncodeTiled_v12000)fn;
  }
  const cuuint64_t ddim[2] = {(cuuint64_t)a.d, (cuuint64_t)a.n};
  const cuuint64_t dstride[1] = {(cuuint64_t)a.d * 4};
  const cuuint32_t dbox[2] = {STREAM_BK, TN}, ones[4] = {1, 1, 1, 1};
  if (encode(dbmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)a.DB, ddim, dstride, dbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const cuuint64_t qdim[4] = {32, (cuuint64_t)dpad / 4, (cuuint64_t)nq_pad / 8, 2};
  const cuuint64_t qstride[3] = {128, (cuuint64_t)dpad / 4 * 128,
                                 (cuuint64_t)nq_pad / 8 * (dpad / 4) * 128};
  const cuuint32_t qbox[4] = {32, STREAM_BK / 4, (cuuint32_t)bq / 8, 2};
  return encode(qmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, (void*)a.qsplit, qdim, qstride, qbox,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Kernel, class... Extra>
int launch_kernel(Kernel kernel, size_t smem, int bq, const Args& a, cudaStream_t s,
                  Extra... extra) {
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + bq - 1) / bq, a.splits);
  kernel<<<grid, THREADS, smem, s>>>(a.Q, a.DB, a.qq, a.dd, a.pd, a.pi, a.nq, a.n, a.d,
                                     a.k, a.chunk, extra...);
  return 0;
}

// route 0: wgmma (promoting past PROMOTE_D for the Gram forms); 1: stream.
template <int FORM, int BQ>
int launch_tile(int route, int gstates, const Args& a, cudaStream_t s) {
  constexpr bool GRAM = is_gram(FORM);
  if (route == 1) {
    CUtensorMap dbmap = {}, qmap = {};
    if (GRAM) {  // split the queries, then map them and the DB
      const int nq_pad = (a.nq + BQ - 1) / BQ * BQ, dpad = (a.d + 7) & ~7;
      const long long total = (long long)nq_pad * dpad;
      knn_split_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(a.Q, a.qsplit, a.nq,
                                                                      nq_pad, a.d, dpad);
      if (!tensor_maps(a, BQ, nq_pad, dpad, &dbmap, &qmap))
        return (int)cudaErrorInvalidValue;
    }
    return launch_kernel(knn_stream_kernel<FORM, BQ>,
                         smem_bytes(BQ, a.d, a.k, GRAM, true, !gstates), BQ, a, s,
                         gstates, dbmap, qmap);
  }
  const size_t smem = smem_bytes(BQ, a.d, a.k, GRAM, false, true);
  if constexpr (GRAM && BQ < 128)  // (a 128-query tile holds no row past d = 112)
    if (a.d > PROMOTE_D) return launch_kernel(knn_kernel<FORM, BQ, true>, smem, BQ, a, s);
  return launch_kernel(knn_kernel<FORM, BQ, false>, smem, BQ, a, s);
}

template <int FORM>
int launch(int bq, int route, int gstates, const Args& a, cudaStream_t s) {
  switch (bq) {
    case 128: return launch_tile<FORM, 128>(route, gstates, a, s);
    case 64: return launch_tile<FORM, 64>(route, gstates, a, s);
    case 32: return launch_tile<FORM, 32>(route, gstates, a, s);
    case 16: return launch_tile<FORM, 16>(route, gstates, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Q[nq,d], DB[n,d] fp32; qq[nq], dd[n] fp32 norm scratch (Gram forms other
// than dot); part_d/part_i[splits,nq,k] scratch; out dists[nq,k] fp32,
// ids[nq,k] int32. Split s covers DB rows [s*chunk, min(n,(s+1)*chunk)).
// bq (128, 64, 32 or 16) queries per block; route 0: the wgmma route,
// route 1: the streaming route, its states in part_d/part_i when gstates;
// its Gram forms take d a multiple of 4 and DB 16-byte aligned (the TMA's
// row stride) and split the queries into qsplit[2][ceil(nq / bq) * bq][dpad]
// fp32.
extern "C" int knn_launch(const void* Q, const void* DB, void* qq, void* dd,
                          void* part_d, void* part_i, void* out_d, void* out_i,
                          void* qsplit, int nq, int n, int d, int k, int chunk, int splits,
                          int bq, int route, int gstates, int form, void* stream) {
  cudaGetLastError();
  if (nq <= 0) return 0;
  if (k < 1 || k > n || d < 1 || chunk < 1 || splits < 1 ||
      (long long)chunk * splits < n || (long long)chunk * (splits - 1) >= n ||
      splits > 65535 || (route != 0 && route != 1) || (gstates && route != 1) ||
      (route == 1 && is_gram(form) && ((d & 3) || ((size_t)DB & 15))))
    return (int)cudaErrorInvalidValue;
  const size_t msmem = sizeof(float) * 6 * (size_t)k;
  if (msmem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Args a{(const float*)Q, (const float*)DB, (const float*)qq, (const float*)dd,
               (float*)part_d, (int*)part_i, (float*)qsplit, nq, n, d, k, chunk, splits};
  if (form == SQEUCLIDEAN || form == L2 || form == COSINE) {
    launch_sqnorm(a.Q, (float*)qq, nq, d, s);
    launch_sqnorm(a.DB, (float*)dd, n, d, s);
  }
  int err = 0;
  switch (form) {
    case SQEUCLIDEAN: err = launch<SQEUCLIDEAN>(bq, route, gstates, a, s); break;
    case L2: err = launch<L2>(bq, route, gstates, a, s); break;
    case COSINE: err = launch<COSINE>(bq, route, gstates, a, s); break;
    case DOT: err = launch<DOT>(bq, route, gstates, a, s); break;
    case L1: err = launch<L1>(bq, route, gstates, a, s); break;
    case CHEBYSHEV: err = launch<CHEBYSHEV>(bq, route, gstates, a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  cudaError_t e = set_smem((const void*)knn_merge_kernel, msmem);
  if (e != cudaSuccess) return (int)e;
  knn_merge_kernel<<<nq, MERGE_THREADS, msmem, s>>>(a.pd, a.pi, (float*)out_d, (int*)out_i,
                                                    nq, k, splits);
  return (int)cudaGetLastError();
}
