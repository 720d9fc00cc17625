// pairwise.cu — batched distance matrices X[G,m,d] x Y[G,n,d] -> out[G,m,n].
//
// Replaces: src/repro/kernels/pairwise.py::pairwise_pallas (_gram_kernel +
// _gram_epilogue at :168, _vpu_kernel at :184).
//
// What bounds it on the H100: bytes. On the main path the build calls it
// once per group_chunk slab with G = 1024 groups of 256 points at d = 100:
// 26.8 GFLOP against 4 * (2 * G * 256 * 100 + G * 256 * 256) = 478 MB, of
// which the [G, 256, 256] output is 268 MB. Bytes take 0.143 ms at 3.35
// TB/s; the products 0.081 ms at 3xTF32 on the tensor cores (0.200 ms in
// fp32 on the CUDA cores). The search calls it with G = 1 for the top
// level ([1000, 128]), where launch overhead dominates.
//
// Design. One block of two warpgroups per 128 x 128 output tile of one
// group; the tile index runs over groups x row tiles x column tiles in
// blockIdx.x, so G is not capped. Two blocks fit an SM, so one block's
// output stores overlap the other's products.
// - d streams through a two-stage cp.async ring, BK = 32 columns of both
//   the tile's 128 X rows and its 128 Y rows a stage (zero-filled past m, n
//   and d; d is padded to the MMA depth of 8), so any d works and no row is
//   held whole.
// - Gram forms (sqeuclidean, l2, cosine, dot) multiply on the tensor cores
//   in 3xTF32 (wgmma.cuh): each warp's 16 X rows are read by ldmatrix and
//   split in registers as wgmma's A; the Y slice is split once per stage
//   into hi and lo halves in core-matrix order as B (m64n128k8, three
//   products a k-step, the next fragment split while the tensor cores
//   run). Plain TF32 would not do: the build takes argmins over these
//   values. The tensor cores add into their accumulator without full fp32
//   rounding, a drift that grows with d; past d = 128 (PROMOTE) each
//   stage's 12 products go to a fresh accumulator that is then added to
//   the running one in fp32, which keeps a point's distance to itself
//   within the tolerance rule at d = 1536 (one block an SM for that
//   variant: twice the accumulators).
// - Row norms are exact fp32, summed in column order from the staged
//   slices by the threads that split them (Y) or by the other half of the
//   block (X): no extra pass over device memory. The epilogue is repro's:
//   max(xx + yy - 2g, 0), its square root, or the clipped cosine.
// - l1 and chebyshev accumulate |x - y| as a sum or a max in fp32 register
//   micro-tiles of 8 x 8 a thread, with 16-byte shared loads from the same
//   ring, and never build the [m, n, d] cube.
// - The output tile is staged through shared memory (reusing the ring) and
//   written as 16-byte row-contiguous streaming stores where n allows; rows
//   and columns past m and n are never written.
// - When X is Y (the build's symmetric slab), only the tiles on and above
//   the diagonal are computed; each tile off the diagonal is also written
//   transposed as its mirror (3 of 4 tiles at 256 points a group).
// Every sum is taken in a fixed order, so a repeat call is bit-identical;
// on integers of at most 11 bits whose products and sums stay below 2^24
// every value is exact and equals the plain version bit for bit.
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

using namespace pdasc;

namespace {

constexpr int BM = 128, BN = 128;  // output tile: X rows x Y rows
constexpr int BK = 32;             // columns of d per ring stage
constexpr int BS = BK + 4;         // stage row stride: conflict-free fragment reads
constexpr int STAGES = 2;
constexpr int OS = BN + 8;         // staged output row stride: conflict-free float2 stores
constexpr int THREADS = 256, NWARPS = THREADS / 32;

constexpr int PROMOTE_D = 128;     // longer d: promote each stage's products

__host__ __device__ constexpr bool is_gram(int form) { return form <= DOT; }
// Two blocks an SM for the Gram forms (64 accumulators a thread); the VPU
// forms' 8 x 8 micro-tiles with their operands, and the promoting Gram
// variant's second accumulator, need more registers.
__host__ __device__ constexpr int min_blocks(int form, bool promote) {
  return is_gram(form) && !promote ? 2 : 1;
}

// Shared floats of one block; mirrored by pairwise.pairwise_smem_bytes.
// The output staging [BM][OS] reuses the ring after the last stage.
constexpr size_t SMEM_FLOATS = (size_t)STAGES * 2 * BM * BS + 2 * (size_t)BN * BK + BM + BN;
static_assert((size_t)BM * OS <= (size_t)STAGES * 2 * BM * BS, "staging fits the ring");

// The staged tile ost[rows][OS] into out[., ld] at (r0, c0): 16-byte
// streaming stores along rows where ld allows, else 4-byte stores.
__device__ __forceinline__ void store_tile(float* out, const float* ost, int ld, int r0,
                                           int c0, int rows, int cols) {
  if ((ld & 3) == 0) {  // rows 16-byte aligned; cols a multiple of 4
    for (int e = threadIdx.x; e < rows * (BN / 4); e += THREADS) {
      const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
      if (c < cols)
        __stcs((float4*)(out + (size_t)(r0 + r) * ld + c0 + c),
               *(const float4*)(ost + r * OS + c));
    }
  } else {
    for (int e = threadIdx.x; e < rows * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      if (c < cols) out[(size_t)(r0 + r) * ld + c0 + c] = ost[r * OS + c];
    }
  }
}

template <int FORM, bool PROMOTE>
__global__ void __launch_bounds__(THREADS, min_blocks(FORM, PROMOTE))
pairwise_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                float* __restrict__ out, int m, int n, int d, int tiles_m, int tiles_n,
                int sym) {
  constexpr bool GRAM = is_gram(FORM);
  constexpr bool NORMS = FORM == SQEUCLIDEAN || FORM == L2 || FORM == COSINE;
  // The accumulator of a warp is WM x WN tiles of 16 x 8: row row0 + 16 mt
  // + g + 8 (e >> 1), column col0 + 8 nt + 2 t + (e & 1) for acc[(mt * WN +
  // nt) * 4 + e]. Gram: a warp's 16 X rows (wgmma's A) by all 128 Y rows.
  // VPU: warps 2 x 4, each 64 X rows by 32 Y rows.
  constexpr int WARPS_M = GRAM ? NWARPS : 2, WARPS_N = NWARPS / WARPS_M;
  constexpr int WM = BM / WARPS_M / 16, WN = BN / WARPS_N / 8;
  constexpr int NV = WM * WN * 4;

  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                        // [STAGES][X, Y][BM][BS]
  float* Yh = ring + STAGES * 2 * BM * BS;   // [BN * BK] TF32 hi, core-matrix order
  float* Yl = Yh + BN * BK;                  // its lo part
  float* xn = Yl + BN * BK;                  // [BM] ||x||^2
  float* yn = xn + BM;                       // [BN] ||y||^2

  // Block -> (group, row tile, column tile). With sym (X is Y), only the
  // tiles on and above the diagonal: tr <= tc, in row order.
  const long long tile = blockIdx.x;
  long long grp;
  int tr, tc;
  if (sym) {
    const int per = tiles_m * (tiles_m + 1) / 2;
    grp = tile / per;
    int u = (int)(tile % per);
    tr = 0;
    while (u >= tiles_m - tr) u -= tiles_m - tr++;
    tc = tr + u;
  } else {
    tc = (int)(tile % tiles_n);
    const long long rest = tile / tiles_n;
    tr = (int)(rest % tiles_m);
    grp = rest / tiles_m;
  }
  X += grp * m * d;
  Y += grp * n * d;
  out += grp * m * n;
  const int r0 = tr * BM, c0 = tc * BN;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / WARPS_N) * (BM / WARPS_M);
  const int col0 = (warp % WARPS_N) * (BN / WARPS_N);
  // ldmatrix row addresses of the A fragment (X rows of the stage): rows of
  // matrix l / 8 are +8 for odd matrices, columns +4 for the upper two
  const int lm = lane >> 3, lr = lane & 7;
  const int a_off = (row0 + lr + 8 * (lm & 1)) * BS + 4 * (lm >> 1);
  // The norm (and, for Y, split) row of this thread: X rows for the first
  // half of the block, Y rows for the second.
  const int nrow = threadIdx.x & (BM - 1);
  const bool yrow = threadIdx.x >= BM;

  const int dpad = (d + 7) & ~7;
  const int nch = (dpad + BK - 1) / BK;
  auto issue = [&](int s) {
    if (s < nch) {
      float* st = ring + (s % STAGES) * 2 * BM * BS;
      const int k0 = s * BK, w = min(BK, dpad - k0);
      load_rows<BM, BS, THREADS>(st, X, r0, m, d, k0, w);
      load_rows<BN, BS, THREADS>(st + BM * BS, Y, c0, n, d, k0, w);
    }
    cp_commit();
  };
  issue(0);

  float acc[NV], part[NV];  // part: the stage's products (PROMOTE)
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
  float nacc = 0.0f;
  uint32_t ah[2][4] = {}, al[2][4] = {};  // A fragments (hi, lo), double-buffered

  for (int s = 0; s < nch; ++s) {
    cp_wait<0>();  // stage s has landed (the only group in flight)
    __syncthreads();
    issue(s + 1);
    const float* st = ring + (s % STAGES) * 2 * BM * BS;
    const int w = min(BK, dpad - s * BK), ks = w / 8;
    if constexpr (GRAM) {
      // Norms in column order; Y rows split into hi and lo for wgmma's B.
      const float* src = st + (yrow ? BM * BS : 0) + nrow * BS;
      float npart = 0.0f;  // the stage's share, then one add: a short chain
      for (int c = 0; c < w; c += 4) {
        const float4 v = *(const float4*)(src + c);
        if (NORMS) {
          npart = fmaf(v.x, v.x, npart);
          npart = fmaf(v.y, v.y, npart);
          npart = fmaf(v.z, v.z, npart);
          npart = fmaf(v.w, v.w, npart);
        }
        if (yrow) {
          const int o = ((nrow >> 3) * (BK / 4) + (c >> 2)) * 32 + (nrow & 7) * 4;
          float4 h, l;
          h.x = __uint_as_float(tf32(v.x));
          h.y = __uint_as_float(tf32(v.y));
          h.z = __uint_as_float(tf32(v.z));
          h.w = __uint_as_float(tf32(v.w));
          l.x = __uint_as_float(tf32(v.x - h.x));
          l.y = __uint_as_float(tf32(v.y - h.y));
          l.z = __uint_as_float(tf32(v.z - h.z));
          l.w = __uint_as_float(tf32(v.w - h.w));
          *(float4*)(Yh + o) = h;
          *(float4*)(Yl + o) = l;
        }
      }
      nacc += npart;
      fence_async_smem();
      __syncthreads();
      // Each k-step: lo*Yhi + hi*Ylo + hi*Yhi on the warpgroup's tensor
      // cores; the next X fragment is split while those run. With PROMOTE
      // the stage's products go to `part`, added to acc in fp32 after.
      const uint32_t sbo = BK * 32;  // bytes between 8-row groups of B
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
        const uint64_t dh = kmajor_desc(Yh + kk * 64, sbo);
        const uint64_t dl = kmajor_desc(Yl + kk * 64, sbo);
        wg_fence();
        if constexpr (PROMOTE) {
          Wgmma<BN>::run(part, al[b], dh, kk > 0);
          Wgmma<BN>::run(part, ah[b], dl);
          Wgmma<BN>::run(part, ah[b], dh);
        } else {
          Wgmma<BN>::run(acc, al[b], dh);
          Wgmma<BN>::run(acc, ah[b], dl);
          Wgmma<BN>::run(acc, ah[b], dh);
        }
        wg_commit();
        if (kk + 1 < ks) {
          wg_wait<1>();  // the products of step kk - 1 are done: its buffer is free
          keep(ah[b ^ 1]);
          keep(al[b ^ 1]);
          split(kk + 1, ah[b ^ 1], al[b ^ 1]);
        }
      }
      wg_wait<0>();  // Yh and Yl are free for the next stage
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
      const float* xs = st;
      const float* ys = st + BM * BS;
      for (int kc = 0; kc < ks * 8; kc += 4) {
        float4 a[WM][2], b[WN][2];
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[mt][h] = *(const float4*)(xs + (row0 + mt * 16 + g + 8 * h) * BS + kc);
#pragma unroll
        for (int nt = 0; nt < WN; ++nt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1)
            b[nt][e1] = *(const float4*)(ys + (col0 + nt * 8 + 2 * t + e1) * BS + kc);
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
  }

  // ---- epilogue: distances into the staged tile, then row-wise stores ----
  if (NORMS) (yrow ? yn : xn)[nrow] = nacc;
  __syncthreads();  // the ring is free; the norms are visible
  float* ost = ring;  // [BM][OS]
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (mt * WN + nt) * 4 + e;
        const int r = row0 + 16 * mt + g + 8 * (e >> 1), c = col0 + 8 * nt + 2 * t + (e & 1);
        acc[i] = finish<FORM>(acc[i], NORMS ? xn[r] : 0.0f, NORMS ? yn[c] : 0.0f);
      }
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (mt * WN + nt) * 4 + 2 * h;
        const int r = row0 + 16 * mt + g + 8 * h, c = col0 + 8 * nt + 2 * t;
        *(float2*)(ost + r * OS + c) = make_float2(acc[i], acc[i + 1]);
      }
  __syncthreads();
  store_tile(out, ost, n, r0, c0, min(BM, m - r0), min(BN, n - c0));
  if (!sym || tr == tc) return;
  // Off the diagonal, X is Y: the tile's transpose is the mirrored tile.
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + 16 * mt + g + 8 * (e >> 1), c = col0 + 8 * nt + 2 * t + (e & 1);
        ost[c * OS + r] = acc[(mt * WN + nt) * 4 + e];
      }
  __syncthreads();
  store_tile(out, ost, n, c0, r0, min(BN, n - c0), min(BM, m - r0));
}

template <int FORM, bool PROMOTE>
int launch(const float* X, const float* Y, float* out, int G, int m, int n, int d,
           int sym, cudaStream_t s) {
  const size_t smem = sizeof(float) * SMEM_FLOATS;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)pairwise_kernel<FORM, PROMOTE>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tm = (m + BM - 1) / BM, tn = (n + BN - 1) / BN;
  const long long blocks = (long long)G * (sym ? tm * (tm + 1) / 2 : tm * tn);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pairwise_kernel<FORM, PROMOTE><<<(unsigned)blocks, THREADS, smem, s>>>(X, Y, out, m, n,
                                                                         d, tm, tn, sym);
  return 0;
}

}  // namespace

// X[G,m,d], Y[G,n,d] fp32 contiguous; out[G,m,n]. sym = 1 when X and Y
// are the same tensor (m == n): the tiles below the diagonal are mirrored.
extern "C" int pairwise_launch(const void* X, const void* Y, void* out, int G, int m,
                               int n, int d, int form, int sym, void* stream) {
  cudaGetLastError();
  if (G <= 0 || m <= 0 || n <= 0) return 0;
  if (d < 1 || (sym && (X != Y || m != n))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)X;
  const float* y = (const float*)Y;
  float* o = (float*)out;
  int err = 0;
  const bool promote = d > PROMOTE_D;
  switch (form) {
    case SQEUCLIDEAN:
      err = promote ? launch<SQEUCLIDEAN, true>(x, y, o, G, m, n, d, sym, s)
                    : launch<SQEUCLIDEAN, false>(x, y, o, G, m, n, d, sym, s);
      break;
    case L2:
      err = promote ? launch<L2, true>(x, y, o, G, m, n, d, sym, s)
                    : launch<L2, false>(x, y, o, G, m, n, d, sym, s);
      break;
    case COSINE:
      err = promote ? launch<COSINE, true>(x, y, o, G, m, n, d, sym, s)
                    : launch<COSINE, false>(x, y, o, G, m, n, d, sym, s);
      break;
    case DOT:
      err = promote ? launch<DOT, true>(x, y, o, G, m, n, d, sym, s)
                    : launch<DOT, false>(x, y, o, G, m, n, d, sym, s);
      break;
    case L1: err = launch<L1, false>(x, y, o, G, m, n, d, sym, s); break;
    case CHEBYSHEV: err = launch<CHEBYSHEV, false>(x, y, o, G, m, n, d, sym, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
