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
//   beats the BIG init entries, which carry lower ids), and steps take 16
//   candidates across tiles.
// - Eight lanes share a candidate, 16 bytes a lane a load, and each group
//   takes four candidates a step: sixteen candidate rows in flight a warp,
//   the query row read from shared memory as float4. A three-step shuffle
//   sums the eight partials; the row norms come from the index's cache.
// - Each warp keeps its own ascending top-k state in shared memory and
//   its k-th entry in registers. Only values that beat it are appended to a
//   64-entry buffer; the buffer merges into the state (a warp merge by rank,
//   as knn.cu's) only when it may overflow and once at the end, never per
//   tile, with no block barrier. A query's warps then merge their states
//   into the first one's.
// Every merge ranks by (distance, slot) strictly, so the result does not
// depend on which warp or step found an entry: a repeat call is
// bit-identical. What holds it back now: the gather, 86% of the warps'
// cycles (merges 13%).
#include "common.cuh"

using namespace pdasc;

namespace {

constexpr int THREADS = 256;                     // at most: QPB queries x WPQ warps
constexpr int CAP = 64;                          // buffer entries a warp
constexpr int GROUP = 8;                         // lanes a candidate
constexpr int PER_GROUP = 2;                     // candidates a group a step
constexpr int STEP = 32 / GROUP * PER_GROUP;     // candidates a warp a step
constexpr int RING = 64;                         // compacted candidates a warp
static_assert(STEP - 1 + 32 <= RING, "a tile always fits the ring");

// Shared floats of one query; mirrored by topk.rank_smem_bytes. The query
// row (padded to 4), then per warp: the state (k, padded to 2), the buffer
// (CAP) and the ring of compacted candidates (RING), each as a distance or
// row and an id or slot; every query's row starts 16-byte aligned.
__host__ __device__ constexpr size_t warp_floats(int k) {
  return 2 * (size_t)(((k + 1) & ~1) + CAP + RING);
}
__host__ __device__ constexpr size_t query_floats(int d, int k, int wpq) {
  return (size_t)((d + 3) & ~3) + (size_t)wpq * warp_floats(k);
}

// Merge buffer (bd, bi)[0, c), c <= CAP, into the ascending state
// (sd, si)[0, k) of one warp. A buffer entry's new rank is its rank in the
// buffer plus the state entries below it; a state entry moves right by the
// buffer entries below it. State entries are read and moved 32 at a time
// from the right, so none is overwritten before it is read; buffer entries
// land last, on the ranks left free. Ids are unique within the merge.
__device__ void warp_merge(float* sd, int* si, const float* bd, const int* bi, int c,
                           int k) {
  const int lane = threadIdx.x & 31;
  float ed[CAP / 32];
  int ei[CAP / 32], pe[CAP / 32];
#pragma unroll
  for (int h = 0; h < CAP / 32; ++h) {
    const int e = lane + 32 * h;
    pe[h] = k;
    if (e < c) {
      ed[h] = bd[e];
      ei[h] = bi[e];
      int rank = 0;
      for (int j = 0; j < c; ++j) rank += key_less(bd[j], bi[j], ed[h], ei[h]);
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_less(sd[mid], si[mid], ed[h], ei[h])) lo = mid + 1; else hi = mid;
      }
      pe[h] = rank + lo;
    }
  }
  for (int base = (k - 1) & ~31; base >= 0; base -= 32) {
    const int i = base + lane;
    float v = 0.0f;
    int id = 0, p = i;
    if (i < k) {
      v = sd[i];
      id = si[i];
      for (int j = 0; j < c; ++j) p += key_less(bd[j], bi[j], v, id);
    }
    // a chunk where nothing moves: nothing to its left moves either
    if (__all_sync(0xffffffffu, p == i)) break;
    __syncwarp();
    if (i < k && p != i && p < k) { sd[p] = v; si[p] = id; }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < CAP / 32; ++h)
    if (pe[h] < k) { sd[pe[h]] = ed[h]; si[pe[h]] = ei[h]; }
  __syncwarp();
}

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
  float* sd = q + dq + wi * warp_floats(k);  // [k] state
  int* si = (int*)(sd + k);
  float* bd = (float*)(si + k);  // [CAP] buffer
  int* bi = (int*)(bd + CAP);
  int* lrow = bi + CAP;          // [RING] compacted candidates: rows, slots
  int* lslot = lrow + RING;

  const long long qi = (long long)blockIdx.x * qpb + ql;
  const bool live = qi < b;  // warp-uniform; dead warps still meet the barriers
  if (live)
    for (int e = wi * 32 + lane; e < dq; e += wpq * 32)
      q[e] = e < d ? Q[qi * d + e] : 0.0f;
  for (int i = lane; i < k; i += 32) { sd[i] = BIG; si[i] = i - k; }
  __syncthreads();

  float qq = 0.0f;
  if (NORMS) {
    for (int e = lane; e < d; e += 32) qq = fmaf(q[e], q[e], qq);
    qq = warp_reduce<SQEUCLIDEAN>(qq);
  }
  float kd = BIG;  // the state's k-th entry
  int ks = -1, bc = 0;
  const int* crow = cidx + qi * w;
  const unsigned char* okrow = ok + qi * w;
  const int grp = lane / GROUP, gl = lane % GROUP;
  const bool vec = (d & 3) == 0 && ((size_t)P & 15) == 0;  // 16-byte rows
  const float4* q4 = (const float4*)q;

  const int tiles = live ? (w + 31) / 32 : 0;
  int t = wi;
  bool nv = false;
  int nr = 0;
  if (t < tiles) {  // the first tile's mask and rows
    const int slot = t * 32 + lane;
    nv = slot < w && okrow[slot];
    nr = slot < w ? crow[slot] : 0;
  }
  int head = 0, cnt = 0;  // the ring of compacted candidates
  // Distances of the ring's first `take` candidates (STEP at most), and
  // the appends of those that beat the k-th entry.
  auto step = [&](int take) {
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
      const bool pass = gl == 0 && j < take && key_less(dist, s, kd, ks);
      const unsigned pm = __ballot_sync(0xffffffffu, pass);
      if (pass) {
        const int at = bc + __popc(pm & ((1u << lane) - 1));
        bd[at] = dist;
        bi[at] = s;
      }
      bc += __popc(pm);
    }
    head = (head + take) % RING;
    cnt -= take;
    if (bc > CAP - STEP) {  // the next step could overflow: merge now
      __syncwarp();
      warp_merge(sd, si, bd, bi, bc, k);
      bc = 0;
      kd = sd[k - 1];
      ks = si[k - 1];
    }
    __syncwarp();  // the ring's entries are read before they are reused
  };
  for (; t < tiles; t += wpq) {
    const bool v = nv;
    const int r = min(max(nr, 0), n - 1), slot = t * 32 + lane;
    const int tn = t + wpq;  // the next tile's, read ahead
    if (tn < tiles) {
      const int s2 = tn * 32 + lane;
      nv = s2 < w && okrow[s2];
      nr = s2 < w ? crow[s2] : 0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, v);
    if (v) {
      const int at = (head + cnt + __popc(mask & ((1u << lane) - 1))) % RING;
      lrow[at] = r;
      lslot[at] = slot;
    }
    cnt += __popc(mask);  // < STEP + 32 <= RING
    __syncwarp();
    while (cnt >= STEP) step(STEP);
  }
  if (cnt > 0) step(cnt);
  if (bc > 0) {
    __syncwarp();
    warp_merge(sd, si, bd, bi, bc, k);
  }

  // The query's other warps' real entries (a prefix of each state, ids >= 0)
  // merge into the first warp's state, CAP at a time.
  __syncthreads();
  if (live && wi == 0) {
    for (int o = 1; o < wpq; ++o) {
      const float* od = sd + o * warp_floats(k);
      const int* oi = (const int*)(od + k);
      for (int c0 = 0; c0 < k; c0 += CAP) {
        const int c = min(CAP, k - c0);
        const int e = c0 + lane, e2 = e + 32;
        const int real = __popc(__ballot_sync(0xffffffffu, e < c0 + c && oi[min(e, k - 1)] >= 0)) +
                         __popc(__ballot_sync(0xffffffffu, e2 < c0 + c && oi[min(e2, k - 1)] >= 0));
        if (real == 0 || !key_less(od[c0], oi[c0], sd[k - 1], si[k - 1])) break;
        warp_merge(sd, si, od + c0, oi + c0, real, k);
        if (real < c) break;
      }
    }
    for (int i = lane; i < k; i += 32) {
      out_d[qi * k + i] = sd[i];
      out_s[qi * k + i] = min(max(si[i], 0), w - 1);
    }
  }
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
