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
// - The split's DB rows stream in 128-row tiles, 64 columns of d at a
//   time, double-buffered through shared memory by cp.async (zero-filled
//   past d and past the split), so loads overlap the products; d is padded
//   to the MMA depth with zeros.
// - Gram forms: wgmma on two warpgroups, each multiplying 64 DB rows of the
//   tile (A, from registers) by all BQ queries (B, from shared memory).
//   Q is staged once per block, split there as x = hi + lo, hi = tf32(x),
//   lo = tf32(x - hi), in core-matrix order; each warp reads its DB
//   fragment by ldmatrix and splits it in registers. Each product is
//   lo*Qhi + hi*Qlo + hi*Qhi, accumulated in fp32 (~22 mantissa bits: the
//   ranking of fp32, which plain TF32's 11 bits are not); the next
//   fragment is split while the tensor cores run. Norms stay exact fp32
//   (launch_sqnorm), read once per block (queries) and ahead of each
//   tile's last products (DB rows).
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
// - Shapes no query tile of this route holds (d + k past ~1,230 for the
//   Gram forms, k past 1024) take the streaming route at the end of this
//   file: Q and DB both stream in d-slices, so any d; its query tile
//   shrinks with k (16 down to 1), and k is bounded only by one query's
//   state and the merge kernel's (6k floats of shared memory: k <= 9,685).
// - What holds it back (PERF.md; tools/knn_phases.py): the products alone
//   take ~60% of the kernel's time at ~45% of the 3xTF32 bound; waits on
//   the ring, merges and the tile's barrier take most of the rest.
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

using namespace pdasc;

namespace {

constexpr int TN = 128;          // DB rows per tile
constexpr int BK = 64;           // columns of d per ring stage
constexpr int BS = BK + 4;       // stage row stride: conflict-free fragment reads
constexpr int STAGES = 2;        // double buffer
constexpr int CAP = 32;          // candidate slots per query: one per lane in a merge
constexpr int THREADS = 256, NWARPS = THREADS / 32;  // two warpgroups
constexpr int MERGE_THREADS = 128;

__host__ __device__ constexpr bool is_gram(int form) { return form <= DOT; }

// Shared bytes of one block; mirrored by topk.knn_smem_bytes. Q takes
// [bq][dpad] twice (TF32 hi and lo, core-matrix order) for the Gram forms,
// [bq][dpad + 4] once (padded rows) for the others.
size_t smem_bytes(int bq, int d, int k, bool gram) {
  const size_t dpad = (size_t)(d + 7) / 8 * 8;
  return 4 * ((gram ? 2 * dpad : dpad + 4) * bq + (size_t)STAGES * TN * BS +
              2 * (size_t)bq * k + 2 * (size_t)bq * CAP + 5 * (size_t)bq + 2);
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
// left free. Ends with a block barrier.
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

template <int FORM, int BQ>
__global__ void __launch_bounds__(THREADS, 1)
knn_kernel(const float* __restrict__ Q, const float* __restrict__ DB,
           const float* __restrict__ qq, const float* __restrict__ dd,
           float* __restrict__ part_d, int* __restrict__ part_i, int nq, int n,
           int d, int k, int chunk) {
  constexpr bool GRAM = is_gram(FORM);
  constexpr bool NORMS = FORM == SQEUCLIDEAN || FORM == L2 || FORM == COSINE;
  constexpr bool LATE_SQRT = FORM == L2;  // see sqrt_limit
  // The accumulator of a warp is WM x WN tiles of 16 x 8. Gram: a warp's
  // 16 DB rows (wgmma's A) times all BQ queries, so rows are DB rows and
  // columns queries. VPU: rows are queries and columns DB rows.
  constexpr int WARPS_M = GRAM ? NWARPS : BQ >= 32 ? 2 : 1, WARPS_N = NWARPS / WARPS_M;
  constexpr int WM = GRAM ? 1 : BQ / WARPS_M / 16;
  constexpr int WN = GRAM ? BQ / 8 : TN / WARPS_N / 8;
  constexpr int NV = WM * WN * 4;
  constexpr int QA = GRAM ? WN : WM, VA = GRAM ? WM : WN;  // query groups, values a group
  static_assert(NV <= 64 && 2 * QA <= 32, "a 64-bit value mask, a 32-bit query mask");

  extern __shared__ __align__(16) float smem[];
  const int dpad = (d + 7) & ~7, qs = GRAM ? dpad : dpad + 4;
  float* Qh = smem;                                   // Q, or its TF32 hi part
  float* Ql = Qh + BQ * qs;                           // its TF32 lo part (Gram)
  float* ring = Ql + (GRAM ? BQ * qs : 0);            // [STAGES][TN][BS]
  float* sd = ring + STAGES * TN * BS;                // [BQ][k] states
  int* si = (int*)(sd + (size_t)BQ * k);
  float* bd = (float*)(si + (size_t)BQ * k);          // [BQ][CAP] buffers
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
  const int a_off = (row0 + lr + 8 * (lm & 1)) * BS + 4 * (lm >> 1);
  const uint32_t q_sbo = (uint32_t)dpad * 32;  // bytes between 8-query groups

  // A buffer is merged once it holds 2k entries (k of them alone bound the
  // k-th), or when it overflows; the others wait, as merges cost a barrier.
  // Only an overflow makes the tile's values go round again; `pass` numbers
  // the rounds, so the overflow mark needs no reset.
  const int fill = min(2 * k, CAP);
  int pass = 0;
  const int nch = (dpad + BK - 1) / BK;
  const int steps = (n1 - n0 + TN - 1) / TN * nch;
  auto issue = [&](int s) {
    if (s < steps) {
      const int c0 = (s % nch) * BK;
      load_rows<TN, BS, THREADS>(ring + (s % STAGES) * TN * BS, DB, n0 + (s / nch) * TN,
                                 n1, d, c0, min(BK, dpad - c0));
    }
    cp_commit();  // empty groups keep the wait count uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

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
  for (int e = threadIdx.x; e < BQ * k; e += THREADS) {
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
  float qn[QA][2], dn[VA][2] = {};  // ||q||^2 of the thread's queries, ||y||^2 of its rows
#pragma unroll
  for (int qa = 0; qa < QA; ++qa)
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      const int gq = q0 + query_of(qa, qb);
      qn[qa][qb] = (NORMS && gq < nq) ? qq[gq] : 0.0f;
    }
  float lim[QA][2];  // klim of the thread's queries, read again after merges
  auto load_lim = [&]() {
#pragma unroll
    for (int qa = 0; qa < QA; ++qa)
#pragma unroll
      for (int qb = 0; qb < 2; ++qb) lim[qa][qb] = klim[query_of(qa, qb)];
  };
#pragma unroll
  for (int qa = 0; qa < QA; ++qa)
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) lim[qa][qb] = LATE_SQRT ? sqrt_limit(BIG) : BIG;
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
  uint32_t ah[2][4] = {}, al[2][4] = {};  // A fragments (hi, lo), double-buffered

  for (int s = 0; s < steps; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    issue(s + STAGES - 1);
    const float* st = ring + (s % STAGES) * TN * BS;
    const int c0 = (s % nch) * BK, ks = min(BK, dpad - c0) / 8;
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
      // cores. The next fragment is split while those run.
      auto split = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
        uint32_t raw[4];
        ldsm_x4(raw, st + a_off + kk * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = __uint_as_float(raw[i]);
          h[i] = tf32(x);
          l[i] = tf32(x - __uint_as_float(h[i]));
        }
      };
      split(0, ah[0], al[0]);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        if (kk >= ks) break;
        const int b = kk & 1;
        const int kc = c0 + kk * 8;
        const uint64_t dh = kmajor_desc(Qh + kc * 8, q_sbo);
        const uint64_t dl = kmajor_desc(Ql + kc * 8, q_sbo);
        wg_fence();
        Wgmma<BQ>::run(acc, al[b], dh);
        Wgmma<BQ>::run(acc, ah[b], dl);
        Wgmma<BQ>::run(acc, ah[b], dh);
        wg_commit();
        if (kk + 1 < ks) {
          wg_wait<1>();  // the products of step kk - 1 are done: its buffer is free
          keep(ah[b ^ 1]);
          keep(al[b ^ 1]);
          split(kk + 1, ah[b ^ 1], al[b ^ 1]);
        }
      }
      wg_wait<0>();
      keep(acc);
      keep(ah[0]);
      keep(al[0]);
      keep(ah[1]);
      keep(al[1]);
    } else {
      for (int kc = c0; kc < c0 + ks * 8; kc += 4) {
        float4 a[WM][2], b[WN][2];
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[mt][h] = *(const float4*)(Qh + (row0 + mt * 16 + g + 8 * h) * qs + kc);
#pragma unroll
        for (int nt = 0; nt < WN; ++nt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1)
            b[nt][e1] = *(const float4*)(st + (col0 + nt * 8 + 2 * t + e1) * BS + kc - c0);
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

  for (int e = threadIdx.x; e < BQ * k; e += THREADS) {
    const int gq = q0 + e / k;
    if (gq >= nq) break;
    const size_t o = ((size_t)blockIdx.y * nq + gq) * k + e % k;
    const bool real = si[e] >= 0;  // an init entry holds no DB row
    part_d[o] = real ? sd[e] : INFINITY;
    part_i[o] = real ? si[e] : INT_MAX;
  }
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

// ---- the streaming route: any d, k up to what one query's state holds ------
// This file's first design, in fp32, with the query tile a template
// parameter: a block owns BQ queries and one split of the DB, stages Q and
// the split's rows through shared memory STREAM_BK columns of d at a time
// (so no row of either is held whole), computes the BQ x STREAM_TN
// distance tile in fp32 register micro-tiles, and merges each query's row
// into its top-k state in shared memory by rank (merge_tile). Taken where
// the wgmma route's whole-row query tile or its states do not fit
// (knn_geometry).
constexpr int STREAM_TN = 128;  // DB rows per tile
constexpr int STREAM_BK = 32;   // columns of d per stage

template <int FORM, int BQ>
__global__ void __launch_bounds__(THREADS)
knn_stream_kernel(const float* __restrict__ Q, const float* __restrict__ DB,
                  const float* __restrict__ qq, const float* __restrict__ dd,
                  float* __restrict__ part_d, int* __restrict__ part_i, int nq, int n,
                  int d, int k, int chunk) {
  constexpr int RQ = (BQ + 7) / 8;  // queries a thread: rows ty + 8 i
  extern __shared__ __align__(16) float smem[];
  float* sd = smem;                      // [BQ * k] per-query states
  int* si = (int*)(sd + BQ * k);         // [BQ * k]
  float* nd = (float*)(si + BQ * k);     // [k] merge scratch
  int* ni = (int*)(nd + k);              // [k]
  __shared__ float Qs[STREAM_BK][BQ];
  __shared__ float Ds[STREAM_BK][STREAM_TN + 1];
  __shared__ float Dt[BQ][STREAM_TN];
  __shared__ int tile_id[STREAM_TN];

  constexpr bool NORMS = FORM == SQEUCLIDEAN || FORM == L2 || FORM == COSINE;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n0 = split * chunk;
  const int n1 = min(n, n0 + chunk);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const bool active = BQ >= 8 || ty < BQ;  // warp-uniform
  for (int r = 0; r < BQ; ++r) init_state(sd + r * k, si + r * k, k);

  for (int c0 = n0; c0 < n1; c0 += STREAM_TN) {
    float acc[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += STREAM_BK) {
      for (int e = threadIdx.x; e < BQ * STREAM_BK; e += THREADS) {
        const int r = e / STREAM_BK, c = e % STREAM_BK, gq = q0 + r, gc = k0 + c;
        Qs[c][r] = (gq < nq && gc < d) ? Q[(size_t)gq * d + gc] : 0.0f;
      }
      for (int e = threadIdx.x; e < STREAM_TN * STREAM_BK; e += THREADS) {
        const int r = e / STREAM_BK, c = e % STREAM_BK, gn = c0 + r, gc = k0 + c;
        Ds[c][r] = (gn < n1 && gc < d) ? DB[(size_t)gn * d + gc] : 0.0f;
      }
      __syncthreads();
      if (active) {
#pragma unroll 8
        for (int kk = 0; kk < STREAM_BK; ++kk) {
          float a[RQ], b[4];
#pragma unroll
          for (int i = 0; i < RQ; ++i) a[i] = Qs[kk][ty + 8 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Ds[kk][tx + 32 * j];
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = accumulate<FORM>(acc[i][j], a[i], b[j]);
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty + 8 * i, gq = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 32 * j, gn = c0 + c;
          float v = INFINITY;
          if (gq < nq && gn < n1)
            v = finish<FORM>(acc[i][j], NORMS ? qq[gq] : 0.0f, NORMS ? dd[gn] : 0.0f);
          Dt[r][c] = v;
        }
      }
    }
    if (threadIdx.x < STREAM_TN) {
      const int gn = c0 + (int)threadIdx.x;
      tile_id[threadIdx.x] = gn < n1 ? gn : INT_MAX;
    }
    __syncthreads();
    for (int r = 0; r < BQ && q0 + r < nq; ++r)
      merge_tile(sd + r * k, si + r * k, nd, ni, Dt[r], tile_id, STREAM_TN, k);
    __syncthreads();
  }
  for (int r = 0; r < BQ && q0 + r < nq; ++r) {
    for (int i = threadIdx.x; i < k; i += THREADS) {
      const size_t o = ((size_t)split * nq + q0 + r) * k + i;
      const bool real = si[r * k + i] >= 0;  // an init entry holds no DB row
      part_d[o] = real ? sd[r * k + i] : INFINITY;
      part_i[o] = real ? si[r * k + i] : INT_MAX;
    }
  }
}

template <int FORM, int BQ>
int launch_stream_tile(const float* Q, const float* DB, const float* qq, const float* dd,
                       float* pd, int* pi, int nq, int n, int d, int k, int chunk,
                       int splits, cudaStream_t s) {
  const size_t smem = sizeof(float) * (2 * (size_t)BQ * k + 2 * (size_t)k);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)knn_stream_kernel<FORM, BQ>);
  if (err != cudaSuccess) return (int)err;
  if (smem + attr.sharedSizeBytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute((const void*)knn_stream_kernel<FORM, BQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BQ - 1) / BQ, splits);
  knn_stream_kernel<FORM, BQ><<<grid, THREADS, smem, s>>>(Q, DB, qq, dd, pd, pi, nq, n,
                                                          d, k, chunk);
  return 0;
}

template <int FORM>
int launch_stream(int bq, const float* Q, const float* DB, const float* qq,
                  const float* dd, float* pd, int* pi, int nq, int n, int d, int k,
                  int chunk, int splits, cudaStream_t s) {
  switch (bq) {
    case 16: return launch_stream_tile<FORM, 16>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk, splits, s);
    case 8: return launch_stream_tile<FORM, 8>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk, splits, s);
    case 4: return launch_stream_tile<FORM, 4>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk, splits, s);
    case 2: return launch_stream_tile<FORM, 2>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk, splits, s);
    case 1: return launch_stream_tile<FORM, 1>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int FORM, int BQ>
int launch_tile(const float* Q, const float* DB, const float* qq, const float* dd,
                float* pd, int* pi, int nq, int n, int d, int k, int chunk, int splits,
                cudaStream_t s) {
  const size_t smem = smem_bytes(BQ, d, k, is_gram(FORM));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)knn_kernel<FORM, BQ>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BQ - 1) / BQ, splits);
  knn_kernel<FORM, BQ><<<grid, THREADS, smem, s>>>(Q, DB, qq, dd, pd, pi, nq, n, d, k,
                                                   chunk);
  return 0;
}

template <int FORM>
int launch(int bq, const float* Q, const float* DB, const float* qq, const float* dd,
           float* pd, int* pi, int nq, int n, int d, int k, int chunk, int splits,
           cudaStream_t s) {
  switch (bq) {
    case 128: return launch_tile<FORM, 128>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk, splits, s);
    case 64: return launch_tile<FORM, 64>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk, splits, s);
    case 32: return launch_tile<FORM, 32>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk, splits, s);
    case 16: return launch_tile<FORM, 16>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Q[nq,d], DB[n,d] fp32; qq[nq], dd[n] fp32 norm scratch (Gram forms other
// than dot); part_d/part_i[splits,nq,k] scratch; out dists[nq,k] fp32,
// ids[nq,k] int32. Split s covers DB rows [s*chunk, min(n,(s+1)*chunk)).
// route 0: the wgmma route, bq (128, 64, 32 or 16) queries per block;
// route 1: the streaming route, bq (16, 8, 4, 2 or 1).
extern "C" int knn_launch(const void* Q, const void* DB, void* qq, void* dd,
                          void* part_d, void* part_i, void* out_d, void* out_i,
                          int nq, int n, int d, int k, int chunk, int splits, int bq,
                          int route, int form, void* stream) {
  cudaGetLastError();
  if (nq <= 0) return 0;
  if (k < 1 || k > n || d < 1 || chunk < 1 || splits < 1 ||
      (long long)chunk * splits < n || (long long)chunk * (splits - 1) >= n ||
      splits > 65535 || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  const size_t msmem = sizeof(float) * 6 * (size_t)k;
  if (msmem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* q = (const float*)Q;
  const float* db = (const float*)DB;
  float* a = (float*)qq;
  float* b = (float*)dd;
  if (form == SQEUCLIDEAN || form == L2 || form == COSINE) {
    launch_sqnorm(q, a, nq, d, s);
    launch_sqnorm(db, b, n, d, s);
  }
  float* pd = (float*)part_d;
  int* pi = (int*)part_i;
  int err = 0;
#define PDASC_KNN(F)                                                             \
  err = route == 0 ? launch<F>(bq, q, db, a, b, pd, pi, nq, n, d, k, chunk, splits, s) \
                   : launch_stream<F>(bq, q, db, a, b, pd, pi, nq, n, d, k, chunk, splits, s)
  switch (form) {
    case SQEUCLIDEAN: PDASC_KNN(SQEUCLIDEAN); break;
    case L2: PDASC_KNN(L2); break;
    case COSINE: PDASC_KNN(COSINE); break;
    case DOT: PDASC_KNN(DOT); break;
    case L1: PDASC_KNN(L1); break;
    case CHEBYSHEV: PDASC_KNN(CHEBYSHEV); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PDASC_KNN
  if (err) return err;
  cudaError_t e = set_smem((const void*)knn_merge_kernel, msmem);
  if (e != cudaSuccess) return (int)e;
  knn_merge_kernel<<<nq, MERGE_THREADS, msmem, s>>>(pd, pi, (float*)out_d, (int*)out_i,
                                                    nq, k, splits);
  return (int)cudaGetLastError();
}
