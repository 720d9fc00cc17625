// swap.cu — FasterPAM swap-sweep deltas for a batch of groups.
//
// Replaces: src/repro/kernels/kmedoids.py::swap_deltas_pallas (pallas_call
// at :113, _sweep_kernel at :49-72), run by every swap sweep of the build
// (repro/core/kmedoids.py:287).
//
// Function: for each group, D[g,g] and the FasterPAM caches d1, d2 (nearest
// and second-nearest medoid distance), n1 (nearest medoid slot) and valid
// give out[i, j] = S[j] + T[i, j] over k slots and g candidates:
//   S[j]    = sum_o valid_o * min(D[o,j] - d1_o, 0)
//   T[i, j] = sum_{o: n1_o = i} valid_o * (D[o,j] >= d1_o ? min(d2_o, D[o,j]) - d1_o : 0)
//
// What bounds it on the H100: bytes. Each D element is read once for a
// handful of FLOPs; on the main path a sweep over a slab of G groups of
// g = 256 with k = 128 reads 4*G*g*g bytes and writes 4*G*k*g.
//
// Design: the TPU kernel walks row tiles in sequence and adds into one
// revisited [k, g] output block (kmedoids.py:49-72); CUDA blocks cannot
// carry that, so each block owns a 32-column tile of one group (group in
// blockIdx.y) and loops over all g rows itself. The column tile of D and
// the caches are staged in shared memory. Warp w adds T's contribution of
// row o into slot n1_o of a [k, 32] shared accumulator only when
// n1_o % 8 == w, so each slot has one writer and rows are added in
// ascending order: no atomics, and the same result on every run (the build
// takes argmins over it). S is summed per warp over a fixed row stride,
// then combined in warp order and broadcast onto every slot at the end.
#include "common.cuh"

using namespace pdasc;

namespace {

constexpr int BN = 32, THREADS = 256, NWARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
swap_kernel(const float* __restrict__ D, const float* __restrict__ d1,
            const float* __restrict__ d2, const int* __restrict__ n1,
            const unsigned char* __restrict__ valid, float* __restrict__ out, int g,
            int k) {
  extern __shared__ float smem[];
  float* Ds = smem;                   // [g][BN]
  float* d1s = Ds + (size_t)g * BN;   // [g]
  float* d2s = d1s + g;               // [g]
  int* n1s = (int*)(d2s + g);         // [g], -1 for invalid rows
  float* acc = (float*)(n1s + g);     // [k][BN]
  float* sS = acc + (size_t)k * BN;   // [NWARPS][BN]

  const size_t grp = blockIdx.y;
  const int j0 = blockIdx.x * BN;
  D += grp * g * g;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int o = threadIdx.x; o < g; o += THREADS) {
    d1s[o] = d1[grp * g + o];
    d2s[o] = d2[grp * g + o];
    const int s = n1[grp * g + o];
    n1s[o] = (valid[grp * g + o] && s >= 0 && s < k) ? s : -1;
  }
  for (int e = threadIdx.x; e < g * BN; e += THREADS) {
    const int o = e / BN, c = e % BN, j = j0 + c;
    Ds[e] = j < g ? D[(size_t)o * g + j] : 0.0f;
  }
  for (int e = threadIdx.x; e < k * BN; e += THREADS) acc[e] = 0.0f;
  __syncthreads();

  float s_part = 0.0f;
  for (int o = warp; o < g; o += NWARPS)
    if (valid[grp * g + o]) s_part += fminf(Ds[o * BN + lane] - d1s[o], 0.0f);
  sS[warp * BN + lane] = s_part;

  for (int o = 0; o < g; ++o) {
    const int i = n1s[o];
    if (i < 0 || i % NWARPS != warp) continue;  // warp-uniform
    const float dj = Ds[o * BN + lane];
    const float c1 = d1s[o];
    acc[i * BN + lane] += dj >= c1 ? fminf(d2s[o], dj) - c1 : 0.0f;
  }
  __syncthreads();

  float* og = out + grp * k * g;
  for (int e = threadIdx.x; e < k * BN; e += THREADS) {
    const int i = e / BN, c = e % BN, j = j0 + c;
    if (j >= g) continue;
    float S = 0.0f;
    for (int w = 0; w < NWARPS; ++w) S += sS[w * BN + c];
    og[(size_t)i * g + j] = S + acc[e];
  }
}

}  // namespace

// D[G,g,g], d1/d2[G,g] fp32; n1[G,g] int32; valid[G,g] bool; out[G,k,g].
extern "C" int swap_launch(const void* D, const void* d1, const void* d2,
                           const void* n1, const void* valid, void* out, int G,
                           int g, int k, void* stream) {
  cudaGetLastError();
  if (G <= 0 || g <= 0) return 0;
  if (k < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)g * BN + 3 * (size_t)g +
                                       (size_t)k * BN + NWARPS * BN);
  cudaError_t err = set_smem((const void*)swap_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g + BN - 1) / BN, G);
  swap_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)D, (const float*)d1, (const float*)d2, (const int*)n1,
      (const unsigned char*)valid, (float*)out, g, k);
  return (int)cudaGetLastError();
}
