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
// queries, n = 1,000,000, d = 100) it does 2*q*n*d = 2e11 fp32 FLOPs
// against ~0.4 GB of input, ~500 FLOP per byte: far above the card's fp32
// ratio (67 TFLOP/s over 3.35 TB/s = 20 FLOP per byte).
//
// Design: the TPU kernel carries each query tile's top-k state from one
// sequential grid step to the next (topk.py:70-84); CUDA blocks cannot, so
// the grid is query tiles x DB splits. A block owns 16 queries and one
// contiguous split of the DB, streams that split in 128-row tiles through
// shared memory (d in 32-wide slices), computes the 16 x 128 distance tile
// with 2 x 4 register micro-tiles in fp32, and merges each query's row into
// its own top-k state in shared memory (merge_tile in common.cuh; a tile
// with nothing below the k-th distance costs one barrier). A second small
// kernel merges the per-split lists of each query. Norms for the Gram forms
// come from the warp-per-row norm kernel, launched first.
#include "common.cuh"

using namespace pdasc;

namespace {

constexpr int BQ = 16, TN = 128, BK = 32, THREADS = 256;
constexpr int MERGE_THREADS = 128;

template <int FORM>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ Q, const float* __restrict__ DB,
           const float* __restrict__ qq, const float* __restrict__ dd,
           float* __restrict__ part_d, int* __restrict__ part_i, int nq, int n,
           int d, int k, int chunk) {
  extern __shared__ float smem[];
  float* sd = smem;                      // [BQ * k] per-query states
  int* si = (int*)(sd + BQ * k);         // [BQ * k]
  float* nd = (float*)(si + BQ * k);     // [k] merge scratch
  int* ni = (int*)(nd + k);              // [k]
  __shared__ float Qs[BK][BQ];
  __shared__ float Ds[BK][TN + 1];
  __shared__ float Dt[BQ][TN];
  __shared__ int tile_id[TN];

  constexpr bool NORMS = FORM == SQEUCLIDEAN || FORM == L2 || FORM == COSINE;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n0 = split * chunk;
  const int n1 = min(n, n0 + chunk);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = 0; r < BQ; ++r) init_state(sd + r * k, si + r * k, k);

  for (int c0 = n0; c0 < n1; c0 += TN) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = threadIdx.x; e < BQ * BK; e += THREADS) {
        const int r = e / BK, c = e % BK, gq = q0 + r, gc = k0 + c;
        Qs[c][r] = (gq < nq && gc < d) ? Q[(size_t)gq * d + gc] : 0.0f;
      }
      for (int e = threadIdx.x; e < TN * BK; e += THREADS) {
        const int r = e / BK, c = e % BK, gn = c0 + r, gc = k0 + c;
        Ds[c][r] = (gn < n1 && gc < d) ? DB[(size_t)gn * d + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = Qs[kk][ty + 8 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ds[kk][tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = accumulate<FORM>(acc[i][j], a[i], b[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
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
    if (threadIdx.x < TN) {
      const int gn = c0 + (int)threadIdx.x;
      tile_id[threadIdx.x] = gn < n1 ? gn : INT_MAX;
    }
    __syncthreads();
    for (int r = 0; r < BQ && q0 + r < nq; ++r)
      merge_tile(sd + r * k, si + r * k, nd, ni, Dt[r], tile_id, TN, k);
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

__global__ void __launch_bounds__(MERGE_THREADS)
knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                 float* __restrict__ out_d, int* __restrict__ out_i, int nq, int k,
                 int splits) {
  extern __shared__ float smem[];
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

template <int FORM>
int launch(const float* Q, const float* DB, const float* qq, const float* dd,
           float* pd, int* pi, int nq, int n, int d, int k, int chunk, int splits,
           cudaStream_t s) {
  const size_t smem = sizeof(float) * (2 * (size_t)BQ * k + 2 * (size_t)k);
  cudaError_t err = cudaFuncSetAttribute((const void*)knn_kernel<FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BQ - 1) / BQ, splits);
  knn_kernel<FORM><<<grid, THREADS, smem, s>>>(Q, DB, qq, dd, pd, pi, nq, n, d, k, chunk);
  return 0;
}

}  // namespace

// Q[nq,d], DB[n,d] fp32; qq[nq], dd[n] fp32 norm scratch (Gram forms other
// than dot); part_d/part_i[splits,nq,k] scratch; out dists[nq,k] fp32,
// ids[nq,k] int32. Split s covers DB rows [s*chunk, min(n,(s+1)*chunk)).
extern "C" int knn_launch(const void* Q, const void* DB, void* qq, void* dd,
                          void* part_d, void* part_i, void* out_d, void* out_i,
                          int nq, int n, int d, int k, int chunk, int splits,
                          int form, void* stream) {
  cudaGetLastError();
  if (nq <= 0) return 0;
  if (k < 1 || k > n || chunk < 1 || splits < 1 || (long long)chunk * splits < n ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
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
  switch (form) {
    case SQEUCLIDEAN: err = launch<SQEUCLIDEAN>(q, db, a, b, pd, pi, nq, n, d, k, chunk, splits, s); break;
    case L2: err = launch<L2>(q, db, a, b, pd, pi, nq, n, d, k, chunk, splits, s); break;
    case COSINE: err = launch<COSINE>(q, db, a, b, pd, pi, nq, n, d, k, chunk, splits, s); break;
    case DOT: err = launch<DOT>(q, db, a, b, pd, pi, nq, n, d, k, chunk, splits, s); break;
    case L1: err = launch<L1>(q, db, a, b, pd, pi, nq, n, d, k, chunk, splits, s); break;
    case CHEBYSHEV: err = launch<CHEBYSHEV>(q, db, a, b, pd, pi, nq, n, d, k, chunk, splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const size_t msmem = sizeof(float) * 6 * (size_t)k;
  cudaError_t e = set_smem((const void*)knn_merge_kernel, msmem);
  if (e != cudaSuccess) return (int)e;
  knn_merge_kernel<<<nq, MERGE_THREADS, msmem, s>>>(pd, pi, (float*)out_d, (int*)out_i,
                                                    nq, k, splits);
  return (int)cudaGetLastError();
}
