// Shared device code of the PDASC CUDA kernels: distance forms, warp
// reductions, the row-norm kernel and the block-wide top-k merge.
//
// Form codes follow repro_torch.kernels.ref.FORMS:
//   0 sqeuclidean, 1 l2, 2 cosine, 3 dot, 4 l1, 5 chebyshev.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace pdasc {

constexpr int SQEUCLIDEAN = 0, L2 = 1, COSINE = 2, DOT = 3, L1 = 4, CHEBYSHEV = 5;
constexpr float BIG = 1e30f;  // masked / missing slots
constexpr float EPS = 1e-12f;

// One step of the per-element reduction over d for a form.
template <int FORM>
__device__ __forceinline__ float accumulate(float acc, float x, float y) {
  if (FORM == L1) return acc + fabsf(x - y);
  if (FORM == CHEBYSHEV) return fmaxf(acc, fabsf(x - y));
  return fmaf(x, y, acc);  // Gram forms accumulate x.y
}

// The Gram epilogue of repro's kernels: norm combination, clamp, sqrt.
template <int FORM>
__device__ __forceinline__ float finish(float g, float xx, float yy) {
  if (FORM == SQEUCLIDEAN || FORM == L2) {
    float d2 = fmaxf(xx + yy - 2.0f * g, 0.0f);
    return FORM == L2 ? sqrtf(d2) : d2;
  }
  if (FORM == COSINE) {
    float norm = sqrtf(fmaxf(xx, EPS)) * sqrtf(fmaxf(yy, EPS));
    return 1.0f - fminf(fmaxf(g / norm, -1.0f), 1.0f);
  }
  if (FORM == DOT) return -g;
  return g;  // l1 / chebyshev: the accumulator is the distance
}

template <int FORM>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = (FORM == CHEBYSHEV) ? fmaxf(v, o) : v + o;
  }
  return v;
}

// ||x||^2 of each row of X[rows, d]: one warp per row.
__global__ void sqnorm_kernel(const float* __restrict__ X, float* __restrict__ out,
                              long long rows, int d) {
  long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* x = X + row * d;
  float acc = 0.0f;
  for (int e = lane; e < d; e += 32) acc = fmaf(x[e], x[e], acc);
  acc = warp_reduce<SQEUCLIDEAN>(acc);
  if (lane == 0) out[row] = acc;
}

inline void launch_sqnorm(const float* X, float* out, long long rows, int d,
                          cudaStream_t stream) {
  if (rows <= 0) return;
  const int warps = 8;
  long long blocks = (rows + warps - 1) / warps;
  sqnorm_kernel<<<(unsigned)blocks, warps * 32, 0, stream>>>(X, out, rows, d);
}

// Total order of top-k entries: by distance, then by id. Ids are unique
// within one merge, so the order is strict and every entry has one rank.
// Lower id first among equal distances is lax.top_k's order.
__device__ __forceinline__ bool key_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Merge an unsorted tile of T entries (td, ti) into the ascending top-k
// state (sd, si) of length k. (nd, ni) is k-entry scratch. Every thread of
// the block calls it. An entry's rank in the union is the count of union
// entries below it; entries of rank < k form the new state. Tile entries
// that do not beat the current k-th are skipped, and a tile with none
// returns after one barrier. Unused tile entries hold (INF, INT_MAX).
__device__ void merge_tile(float* sd, int* si, float* nd, int* ni,
                           const float* td, const int* ti, int T, int k) {
  const float kd = sd[k - 1];
  const int ki = si[k - 1];
  int hit = 0;
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    hit |= key_less(td[t], ti[t], kd, ki);
  if (!__syncthreads_or(hit)) return;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float d = sd[i];
    const int id = si[i];
    int r = i;
    for (int t = 0; t < T; ++t) r += key_less(td[t], ti[t], d, id);
    if (r < k) { nd[r] = d; ni[r] = id; }
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float d = td[t];
    const int id = ti[t];
    if (!key_less(d, id, kd, ki)) continue;
    int r = 0;
    for (int u = 0; u < T; ++u) r += key_less(td[u], ti[u], d, id);
    if (r >= k) continue;
    int lo = 0, hi = k;  // state entries below (d, id)
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (key_less(sd[mid], si[mid], d, id)) lo = mid + 1; else hi = mid;
    }
    r += lo;
    if (r < k) { nd[r] = d; ni[r] = id; }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) { sd[i] = nd[i]; si[i] = ni[i]; }
  __syncthreads();
}

// Initial top-k state: BIG distances with distinct negative ids, which
// rank below every real candidate of equal distance (repro's -1 init).
__device__ __forceinline__ void init_state(float* sd, int* si, int k) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) { sd[i] = BIG; si[i] = i - k; }
}

inline cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace pdasc
