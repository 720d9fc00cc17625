// rank.cu — fused gather -> distance -> masked top-k of per-query candidates.
//
// Replaces: src/repro/kernels/topk.py::rank_pallas (pallas_call at :283,
// _rank_kernel at :188-213), reached through ops.rank_gathered.
//
// Function: for query b, candidates are rows cand_idx[b, 0..w) of a shared
// points[n, d] table; masked slots (ok == 0) rank as BIG. Output: the k
// smallest as dists[b, k] ascending and slots[b, k] into [0, w), ties broken
// lower slot first (lax.top_k's order); missing entries are BIG with the
// -1 init clipped to slot 0, as rank_pallas does at topk.py:297-300.
//
// What bounds it on the H100: bytes. Each unmasked candidate costs d*4
// bytes of gathered row plus its norm for 2*d FLOPs (0.5 FLOP per byte);
// at the leaf (b = 1000 queries, w = 384 slots of which ~30% unmasked,
// d = 100) that is ~46 MB against ~23 MFLOP: 0.0147 ms at 3.35 TB/s.
//
// Design. This kernel's first design (a block a query, a warp a
// candidate, a block-wide merge per 128-slot tile) spent 59% of its warps'
// cycles in the serial gather chain and 41% in the merges on the main
// path's leaf table (tools/kernel_phases.py --kernel rank). Here:
// - A query is WPQ warps (4 for w >= 128) and a block holds QPB queries
//   (WPQ * QPB = 8 warps where shared memory allows; topk.rank_geometry),
//   so 1,000 queries give ~30 warps an SM to keep row loads in flight.
//   Warp i of a query takes the 32-slot tiles i, i + WPQ, ...
// - A tile's ok and cand_idx are read coalesced, a slot a lane, one tile
//   ahead of their use; __ballot_sync/__popc compact the unmasked slots into
//   a per-warp ring of 64, so masked slots cost nothing (a masked slot never
//   beats the BIG init entries, which carry lower ids), and steps take 8
//   candidates across tiles.
// - Eight lanes share a candidate, 16 bytes a lane a load, and each group
//   takes two candidates a step: eight candidate rows in flight a warp,
//   the query row read from shared memory as float4. A three-step shuffle
//   sums the eight partials; the row norms come from the index's cache.
// - Each warp keeps its own ascending top-k state in shared memory and
//   its k-th entry in registers. Only values that beat it are appended to a
//   64-entry buffer; the buffer merges into the state (a warp merge by rank,
//   as knn.cu's) only when it may overflow and once at the end, never per
//   tile, with no block barrier. A query's warps then merge their states
//   into the first one's.
// The ring, the per-warp top-k and the merges are topk.cuh's, shared with
// scan.cu. Every merge ranks by (distance, slot) strictly, so the result
// does not depend on which warp or step found an entry: a repeat call is
// bit-identical. What holds it back now: the gather, 86% of the warps'
// cycles (merges 13%).
#include "topk.cuh"

using namespace pdasc;

namespace {

constexpr int THREADS = 256;                     // at most: QPB queries x WPQ warps
constexpr int GROUP = 8;                         // lanes a candidate
constexpr int PER_GROUP = 2;                     // candidates a group a step
constexpr int STEP = 32 / GROUP * PER_GROUP;     // candidates a warp a step

template <int FORM>
__global__ void __launch_bounds__(THREADS, 4)
rank_kernel(const float* __restrict__ Q, const float* __restrict__ P,
            const float* __restrict__ sqn, const int* __restrict__ cidx,
            const unsigned char* __restrict__ ok, float* __restrict__ out_d,
            int* __restrict__ out_s, int b, int n, int d, int w, int k, int wpq,
            int qpb) {
  constexpr bool NORMS = FORM == SQEUCLIDEAN || FORM == L2 || FORM == COSINE;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ql = warp / wpq, wi = warp % wpq;  // query in the block, warp in the query
  const int dq = (d + 3) & ~3;
  float* q = smem + ql * query_floats(d, k, wpq);

  const long long qi = (long long)blockIdx.x * qpb + ql;
  const bool live = qi < b;  // warp-uniform; dead warps still meet the barriers
  if (live)
    for (int e = wi * 32 + lane; e < dq; e += wpq * 32)
      q[e] = e < d ? Q[qi * d + e] : 0.0f;
  WarpTopk top(q + dq + wi * warp_floats(k), k);
  const int* lrow = top.ring_rows();
  const int* lslot = top.ring_slots();
  __syncthreads();

  float qq = 0.0f;
  if (NORMS) {
    for (int e = lane; e < d; e += 32) qq = fmaf(q[e], q[e], qq);
    qq = warp_reduce<SQEUCLIDEAN>(qq);
  }
  const int grp = lane / GROUP, gl = lane % GROUP;
  const bool vec = (d & 3) == 0 && ((size_t)P & 15) == 0;  // 16-byte rows
  const float4* q4 = (const float4*)q;

  // Distances of the ring's `take` candidates from `head` (STEP at most),
  // and the appends of those that beat the k-th entry.
  auto step = [&](int head, int take) {
    int rows[PER_GROUP];
    float acc[PER_GROUP];
#pragma unroll
    for (int h = 0; h < PER_GROUP; ++h) {
      const int j = h * (32 / GROUP) + grp;
      rows[h] = lrow[(head + (j < take ? j : 0)) % RING];
      acc[h] = 0.0f;
    }
    if (vec) {
#pragma unroll 2
      for (int c = 4 * gl; c < d; c += 4 * GROUP) {
        const float4 x = q4[c >> 2];
#pragma unroll
        for (int h = 0; h < PER_GROUP; ++h) {
          const float4 y = __ldg((const float4*)(P + (size_t)rows[h] * d + c));
          acc[h] = accumulate<FORM>(acc[h], x.x, y.x);
          acc[h] = accumulate<FORM>(acc[h], x.y, y.y);
          acc[h] = accumulate<FORM>(acc[h], x.z, y.z);
          acc[h] = accumulate<FORM>(acc[h], x.w, y.w);
        }
      }
    } else {
#pragma unroll 2
      for (int c = gl; c < d; c += GROUP) {
        const float x = q[c];
#pragma unroll
        for (int h = 0; h < PER_GROUP; ++h)
          acc[h] = accumulate<FORM>(acc[h], x, __ldg(P + (size_t)rows[h] * d + c));
      }
    }
#pragma unroll
    for (int h = 0; h < PER_GROUP; ++h) {
#pragma unroll
      for (int off = GROUP / 2; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, acc[h], off);
        acc[h] = FORM == CHEBYSHEV ? fmaxf(acc[h], o) : acc[h] + o;
      }
      const int j = h * (32 / GROUP) + grp;
      const float dist = finish<FORM>(acc[h], qq, NORMS ? sqn[rows[h]] : 0.0f);
      const int s = lslot[(head + (j < take ? j : 0)) % RING];
      top.offer(gl == 0 && j < take, dist, s);
    }
    top.make_room(STEP);  // the next step could overflow: merge now
  };
  const int* crow = cidx + qi * w;
  const unsigned char* okrow = ok + qi * w;
  for_each_candidate<STEP>(crow, okrow, w, n, wi, wpq, live ? (w + 31) / 32 : 0,
                           top.ring_rows(), top.ring_slots(), step);
  top.flush();

  __syncthreads();
  if (live) top.write_query(wi, wpq, w, out_d + qi * k, out_s + qi * k);
}

template <int FORM>
int launch(const float* Q, const float* P, const float* sqn, const int* cidx,
           const unsigned char* ok, float* od, int* os, int b, int n, int d, int w, int k,
           int wpq, int qpb, cudaStream_t s) {
  const size_t smem = sizeof(float) * qpb * query_floats(d, k, wpq);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)rank_kernel<FORM>, smem);
  if (err != cudaSuccess) return (int)err;
  rank_kernel<FORM><<<(b + qpb - 1) / qpb, 32 * wpq * qpb, smem, s>>>(
      Q, P, sqn, cidx, ok, od, os, b, n, d, w, k, wpq, qpb);
  return 0;
}

}  // namespace

// Q[b,d], points[n,d] fp32; sq_norm[n] fp32 (norm forms; may be null
// otherwise); cand_idx[b,w] int32; ok[b,w] bool; out dists[b,k] fp32,
// slots[b,k] int32. Requires 1 <= k <= w; a block of qpb queries of wpq
// warps each (at most 8 warps).
extern "C" int rank_launch(const void* Q, const void* points, const void* sq_norm,
                           const void* cand_idx, const void* ok, void* out_d,
                           void* out_s, int b, int n, int d, int w, int k, int form,
                           int wpq, int qpb, void* stream) {
  cudaGetLastError();
  if (b <= 0) return 0;
  if (k < 1 || k > w || n < 1 || d < 1 || wpq < 1 || qpb < 1 || wpq * qpb > THREADS / 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* q = (const float*)Q;
  const float* p = (const float*)points;
  const float* c = (const float*)sq_norm;
  const int* ci = (const int*)cand_idx;
  const unsigned char* m = (const unsigned char*)ok;
  float* od = (float*)out_d;
  int* os = (int*)out_s;
  int err = 0;
  switch (form) {
    case SQEUCLIDEAN: err = launch<SQEUCLIDEAN>(q, p, c, ci, m, od, os, b, n, d, w, k, wpq, qpb, s); break;
    case L2: err = launch<L2>(q, p, c, ci, m, od, os, b, n, d, w, k, wpq, qpb, s); break;
    case COSINE: err = launch<COSINE>(q, p, c, ci, m, od, os, b, n, d, w, k, wpq, qpb, s); break;
    case DOT: err = launch<DOT>(q, p, c, ci, m, od, os, b, n, d, w, k, wpq, qpb, s); break;
    case L1: err = launch<L1>(q, p, c, ci, m, od, os, b, n, d, w, k, wpq, qpb, s); break;
    case CHEBYSHEV: err = launch<CHEBYSHEV>(q, p, c, ci, m, od, os, b, n, d, w, k, wpq, qpb, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
