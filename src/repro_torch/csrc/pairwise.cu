// pairwise.cu — batched distance matrices X[G,m,d] x Y[G,n,d] -> out[G,m,n].
//
// Replaces: src/repro/kernels/pairwise.py::pairwise_pallas (_gram_kernel +
// _gram_epilogue at :168, _vpu_kernel at :184).
//
// What bounds it on the H100: on the main path the build calls it once per
// group_chunk slab with G groups of 256 points at d=100 (2*G*256*256*100
// FLOPs against 4*(2*G*256*100 + G*256*256) bytes: ~54 FLOP per byte), so in
// full fp32 on the CUDA cores (67 TFLOP/s) it is bound by operations, just
// above the byte bound at 3.35 TB/s. The search calls it with G=1 for the top
// level ([1000, 128]), where launch overhead dominates.
//
// Design: one block per 64x64 output tile of one group (group in
// blockIdx.z, so a whole slab is one launch); 256 threads each own a 4x4
// micro-tile held in registers. The d axis streams through shared memory in
// 16-wide slices of X and Y, stored transposed so that the inner loop reads
// broadcast rows. Gram forms (sqeuclidean, l2, cosine, dot) accumulate x.y
// in fp32 FMAs (not TF32: the build takes argmins over these values) and
// apply repro's epilogue max(xx+yy-2g, 0), sqrt, or the clipped cosine; the
// row norms come from a small warp-per-row kernel launched first. l1 and
// chebyshev accumulate |x-y| as a sum or a max in the same tiles and never
// build the [m, n, d] cube. Zero padding of the ragged d slice adds 0 to
// every form; rows and columns past m and n are never written.
#include "common.cuh"

using namespace pdasc;

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

template <int FORM>
__global__ void __launch_bounds__(THREADS)
pairwise_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const float* __restrict__ xx, const float* __restrict__ yy,
                float* __restrict__ out, int m, int n, int d) {
  __shared__ float Xs[BK][BM + 1];
  __shared__ float Ys[BK][BN + 1];
  const size_t grp = blockIdx.z;
  X += grp * m * d;
  Y += grp * n * d;
  out += grp * m * n;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, gc = k0 + c;
      const int gm = row0 + r, gn = col0 + r;
      Xs[c][r] = (gm < m && gc < d) ? X[(size_t)gm * d + gc] : 0.0f;
      Ys[c][r] = (gn < n && gc < d) ? Y[(size_t)gn * d + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = accumulate<FORM>(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  constexpr bool NORMS = FORM == SQEUCLIDEAN || FORM == L2 || FORM == COSINE;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
    const float xr = NORMS ? xx[grp * m + r] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= n) continue;
      const float yc = NORMS ? yy[grp * n + c] : 0.0f;
      out[(size_t)r * n + c] = finish<FORM>(acc[i][j], xr, yc);
    }
  }
}

template <int FORM>
void launch(const float* X, const float* Y, const float* xx, const float* yy,
            float* out, int G, int m, int n, int d, cudaStream_t s) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, G);
  pairwise_kernel<FORM><<<grid, THREADS, 0, s>>>(X, Y, xx, yy, out, m, n, d);
}

}  // namespace

// X[G,m,d], Y[G,n,d] fp32 contiguous; xx[G*m], yy[G*n] scratch for the row
// norms (Gram forms other than dot); out[G,m,n].
extern "C" int pairwise_launch(const void* X, const void* Y, void* xx, void* yy,
                               void* out, int G, int m, int n, int d, int form,
                               void* stream) {
  cudaGetLastError();
  if (G <= 0 || m <= 0 || n <= 0) return 0;
  if (G > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)X;
  const float* y = (const float*)Y;
  float* o = (float*)out;
  if (form == SQEUCLIDEAN || form == L2 || form == COSINE) {
    launch_sqnorm(x, (float*)xx, (long long)G * m, d, s);
    launch_sqnorm(y, (float*)yy, (long long)G * n, d, s);
  }
  const float* a = (const float*)xx;
  const float* b = (const float*)yy;
  switch (form) {
    case SQEUCLIDEAN: launch<SQEUCLIDEAN>(x, y, a, b, o, G, m, n, d, s); break;
    case L2: launch<L2>(x, y, a, b, o, G, m, n, d, s); break;
    case COSINE: launch<COSINE>(x, y, a, b, o, G, m, n, d, s); break;
    case DOT: launch<DOT>(x, y, a, b, o, G, m, n, d, s); break;
    case L1: launch<L1>(x, y, a, b, o, G, m, n, d, s); break;
    case CHEBYSHEV: launch<CHEBYSHEV>(x, y, a, b, o, G, m, n, d, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
