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
// What bounds it on the H100: bytes. Each candidate costs d*4 bytes of
// gathered row plus its norm and mask for 2*d FLOPs (0.5 FLOP per byte);
// at the main path's beam levels (b = 1000 queries, w = beam * max
// children, d = 100) that is hundreds of MB per call against a few
// hundred MFLOP.
//
// Design: one block of 256 threads per query. The query row sits in shared
// memory; ||q||^2 is reduced once per block; the candidates' ||c||^2 come
// from the index's norm cache (sq_norm[n]). The kernel gathers the rows
// itself, so the [b, w, d] cube of repro's ops.rank_gathered never exists
// in device memory. Candidates stream in tiles of 128: each warp computes
// one candidate at a time, lanes striding over d (coalesced 128-byte
// reads) and a shuffle reduction. Masked slots skip the row read. Each tile
// merges into the block's top-k state in shared memory (merge_tile in
// common.cuh), keyed on (distance, slot).
#include "common.cuh"

using namespace pdasc;

namespace {

constexpr int THREADS = 256, TILE = 128;

template <int FORM>
__global__ void __launch_bounds__(THREADS)
rank_kernel(const float* __restrict__ Q, const float* __restrict__ P,
            const float* __restrict__ sqn, const int* __restrict__ cidx,
            const unsigned char* __restrict__ ok, float* __restrict__ out_d,
            int* __restrict__ out_s, int n, int d, int w, int k) {
  extern __shared__ float smem[];
  float* q = smem;                 // [d]
  float* sd = q + d;               // [k] state
  int* si = (int*)(sd + k);        // [k]
  float* nd = (float*)(si + k);    // [k] merge scratch
  int* ni = (int*)(nd + k);        // [k]
  float* td = (float*)(ni + k);    // [TILE] tile
  int* ti = (int*)(td + TILE);     // [TILE]
  __shared__ float red[THREADS / 32];

  const size_t b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int NWARPS = THREADS / 32;
  for (int e = threadIdx.x; e < d; e += THREADS) q[e] = Q[b * d + e];
  init_state(sd, si, k);
  __syncthreads();

  constexpr bool NORMS = FORM == SQEUCLIDEAN || FORM == L2 || FORM == COSINE;
  float qq = 0.0f;
  if (NORMS) {
    float part = 0.0f;
    for (int e = threadIdx.x; e < d; e += THREADS) part = fmaf(q[e], q[e], part);
    part = warp_reduce<SQEUCLIDEAN>(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    for (int i = 0; i < NWARPS; ++i) qq += red[i];
  }

  const int* crow = cidx + b * w;
  const unsigned char* okrow = ok + b * w;
  for (int t0 = 0; t0 < w; t0 += TILE) {
    for (int c = warp; c < TILE; c += NWARPS) {
      const int slot = t0 + c;
      float dist = INFINITY;
      int id = INT_MAX;
      if (slot < w) {
        id = slot;
        dist = BIG;
        if (okrow[slot]) {  // warp-uniform branch
          const int row = min(max(crow[slot], 0), n - 1);
          const float* p = P + (size_t)row * d;
          float acc = 0.0f;
          for (int e = lane; e < d; e += 32) acc = accumulate<FORM>(acc, q[e], p[e]);
          acc = warp_reduce<FORM>(acc);
          dist = finish<FORM>(acc, qq, NORMS ? sqn[row] : 0.0f);
        }
      }
      if (lane == 0) { td[c] = dist; ti[c] = id; }
    }
    __syncthreads();
    merge_tile(sd, si, nd, ni, td, ti, TILE, k);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < k; i += THREADS) {
    out_d[b * k + i] = sd[i];
    out_s[b * k + i] = min(max(si[i], 0), w - 1);
  }
}

template <int FORM>
int launch(const float* Q, const float* P, const float* sqn, const int* cidx,
           const unsigned char* ok, float* od, int* os, int b, int n, int d,
           int w, int k, cudaStream_t s) {
  const size_t smem = sizeof(float) * (d + 4 * (size_t)k + 2 * TILE);
  cudaError_t err = set_smem((const void*)rank_kernel<FORM>, smem);
  if (err != cudaSuccess) return (int)err;
  rank_kernel<FORM><<<b, THREADS, smem, s>>>(Q, P, sqn, cidx, ok, od, os, n, d, w, k);
  return 0;
}

}  // namespace

// Q[b,d], points[n,d] fp32; sq_norm[n] fp32 (norm forms; may be null
// otherwise); cand_idx[b,w] int32; ok[b,w] bool; out dists[b,k] fp32,
// slots[b,k] int32. Requires 1 <= k <= w.
extern "C" int rank_launch(const void* Q, const void* points, const void* sq_norm,
                           const void* cand_idx, const void* ok, void* out_d,
                           void* out_s, int b, int n, int d, int w, int k, int form,
                           void* stream) {
  cudaGetLastError();
  if (b <= 0) return 0;
  if (k < 1 || k > w || n < 1) return (int)cudaErrorInvalidValue;
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
    case SQEUCLIDEAN: err = launch<SQEUCLIDEAN>(q, p, c, ci, m, od, os, b, n, d, w, k, s); break;
    case L2: err = launch<L2>(q, p, c, ci, m, od, os, b, n, d, w, k, s); break;
    case COSINE: err = launch<COSINE>(q, p, c, ci, m, od, os, b, n, d, w, k, s); break;
    case DOT: err = launch<DOT>(q, p, c, ci, m, od, os, b, n, d, w, k, s); break;
    case L1: err = launch<L1>(q, p, c, ci, m, od, os, b, n, d, w, k, s); break;
    case CHEBYSHEV: err = launch<CHEBYSHEV>(q, p, c, ci, m, od, os, b, n, d, w, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
