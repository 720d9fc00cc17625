// scan.cu — stage 1 of the two-stage search: unpack -> dequantise ->
// distance -> masked top-k of per-query candidates over the quantised
// payload codes.
//
// Replaces: src/repro/kernels/quantized.py::scan_pallas (pallas_call at
// :153, _scan_kernel at :69-92, _unpack_tile at :44-66), reached through
// ops.scan_quantized.
//
// Function: for query b, candidates are rows cand_idx[b, 0..w) of a shared
// code table codes[n, dc]; row r dequantises as code * scales[clip(r /
// block, 0, nb - 1)]. Containers: int8 or fp16 (dc = d), int4 as two signed
// nibbles per int8 byte, low nibble first (dc = ceil(d/2)), binary as eight
// sign bits per uint8 byte, LSB first, bit 1 -> +1, bit 0 -> -1 (dc =
// ceil(d/8)). Distances use the norms of the *dequantised* rows (the payload
// has no norm cache, by design). Masked slots (ok == 0) rank as BIG. Output:
// the k smallest as dists[b, k] ascending and slots[b, k] into [0, w), ties
// broken lower slot first (lax.top_k's order); missing entries are BIG with
// the -1 init clipped to slot 0, as scan_pallas does at quantized.py:174.
//
// What bounds it on the H100: bytes. Each unmasked candidate costs its code
// row (d bytes for int8, d/2 for int4, d/8 for binary, 2d for fp16) plus its
// index and mask, for about 3-4 FLOPs per dimension; at the two-stage
// path's shapes (b = 1000, w ~ 384, d = 100, k = R = 128) an int8 call
// reads about 40 MB for about 3 FLOPs per byte.
//
// Design: one block of 256 threads per query. The query row sits in shared
// memory; ||q||^2 is reduced once per block. The kernel reads each
// candidate's code row and its block scale itself, so the [b, w, dc] code
// cube and the [b, w] scale array that repro's ops.scan_quantized builds in
// HBM never exist. Candidates stream in tiles of 128: each warp takes one
// candidate at a time, lanes striding over the packed bytes (one int8 or
// fp16 value, two nibbles or eight sign bits per byte); the unpacked fp32
// values live only in registers. Each lane accumulates its distance partial
// and, for the norm forms, ||c||^2; a shuffle reduction finishes both.
// Masked slots skip the row read. Each tile merges into the block's top-k
// state in shared memory (merge_tile in common.cuh), keyed on
// (distance, slot).
#include <cuda_fp16.h>

#include "common.cuh"

using namespace pdasc;

namespace {

constexpr int THREADS = 256, TILE = 128;
constexpr int INT8 = 0, FP16 = 1, INT4 = 2, BINARY = 3;  // kernels/quantized.py

template <int FORM>
struct Acc {
  float dist = 0.0f, cc = 0.0f;
  static constexpr bool NORMS = FORM == SQEUCLIDEAN || FORM == L2 || FORM == COSINE;
  __device__ __forceinline__ void add(float q, float c) {
    dist = accumulate<FORM>(dist, q, c);
    if (NORMS) cc = fmaf(c, c, cc);
  }
};

// One lane's share of a candidate row: bytes lane, lane + 32, ... of the
// packed row, each unpacked and dequantised in registers.
template <int FORM, int FMT>
__device__ __forceinline__ void row_partial(Acc<FORM>& a, const float* q,
                                            const void* row, float scale,
                                            int d, int dc, int lane) {
  if (FMT == INT8) {
    const signed char* c = (const signed char*)row;
    for (int e = lane; e < dc; e += 32) a.add(q[e], (float)c[e] * scale);
  } else if (FMT == FP16) {
    const __half* c = (const __half*)row;
    for (int e = lane; e < dc; e += 32) a.add(q[e], __half2float(c[e]) * scale);
  } else if (FMT == INT4) {
    const unsigned char* c = (const unsigned char*)row;
    for (int j = lane; j < dc; j += 32) {
      const int byte = c[j];
      const int lo = ((byte & 0xF) ^ 0x8) - 0x8;
      const int hi = ((byte >> 4) ^ 0x8) - 0x8;
      a.add(q[2 * j], (float)lo * scale);
      if (2 * j + 1 < d) a.add(q[2 * j + 1], (float)hi * scale);
    }
  } else {  // BINARY
    const unsigned char* c = (const unsigned char*)row;
    for (int j = lane; j < dc; j += 32) {
      const int byte = c[j];
      const int lim = min(8, d - 8 * j);
      for (int t = 0; t < lim; ++t)
        a.add(q[8 * j + t], (float)(2 * ((byte >> t) & 1) - 1) * scale);
    }
  }
}

template <int FORM, int FMT>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ Q, const unsigned char* __restrict__ codes,
            const float* __restrict__ scales, const int* __restrict__ cidx,
            const unsigned char* __restrict__ ok, float* __restrict__ out_d,
            int* __restrict__ out_s, int n, int nb, int block, int d, int dc,
            int w, int k) {
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
  constexpr size_t ITEM = FMT == FP16 ? 2 : 1;  // container bytes per code
  for (int e = threadIdx.x; e < d; e += THREADS) q[e] = Q[b * d + e];
  init_state(sd, si, k);
  __syncthreads();

  float qq = 0.0f;
  if (Acc<FORM>::NORMS) {
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
          const float scale = scales[min(max(row / block, 0), nb - 1)];
          Acc<FORM> a;
          row_partial<FORM, FMT>(a, q, codes + (size_t)row * dc * ITEM, scale,
                                 d, dc, lane);
          a.dist = warp_reduce<FORM>(a.dist);
          if (Acc<FORM>::NORMS) a.cc = warp_reduce<SQEUCLIDEAN>(a.cc);
          dist = finish<FORM>(a.dist, qq, a.cc);
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

template <int FORM, int FMT>
int launch(const float* Q, const unsigned char* codes, const float* scales,
           const int* cidx, const unsigned char* ok, float* od, int* os, int b,
           int n, int nb, int block, int d, int dc, int w, int k, cudaStream_t s) {
  const size_t smem = sizeof(float) * (d + 4 * (size_t)k + 2 * TILE);
  cudaError_t err = set_smem((const void*)scan_kernel<FORM, FMT>, smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<FORM, FMT><<<b, THREADS, smem, s>>>(
      Q, codes, scales, cidx, ok, od, os, n, nb, block, d, dc, w, k);
  return 0;
}

template <int FORM>
int launch_fmt(int fmt, const float* Q, const unsigned char* codes,
               const float* scales, const int* cidx, const unsigned char* ok,
               float* od, int* os, int b, int n, int nb, int block, int d,
               int dc, int w, int k, cudaStream_t s) {
  switch (fmt) {
    case INT8: return launch<FORM, INT8>(Q, codes, scales, cidx, ok, od, os, b, n, nb, block, d, dc, w, k, s);
    case FP16: return launch<FORM, FP16>(Q, codes, scales, cidx, ok, od, os, b, n, nb, block, d, dc, w, k, s);
    case INT4: return launch<FORM, INT4>(Q, codes, scales, cidx, ok, od, os, b, n, nb, block, d, dc, w, k, s);
    case BINARY: return launch<FORM, BINARY>(Q, codes, scales, cidx, ok, od, os, b, n, nb, block, d, dc, w, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Q[b,d] fp32; codes[n,dc] in the container of fmt (0 int8, 1 fp16, 2 int4
// packed in int8, 3 binary packed in uint8); scales[nb] fp32, one per block
// rows; cand_idx[b,w] int32; ok[b,w] bool; out dists[b,k] fp32, slots[b,k]
// int32. Requires 1 <= k <= w.
extern "C" int scan_launch(const void* Q, const void* codes, const void* scales,
                           const void* cand_idx, const void* ok, void* out_d,
                           void* out_s, int b, int n, int nb, int block, int d,
                           int dc, int w, int k, int form, int fmt, void* stream) {
  cudaGetLastError();
  if (b <= 0) return 0;
  if (k < 1 || k > w || n < 1 || nb < 1 || block < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* q = (const float*)Q;
  const unsigned char* c = (const unsigned char*)codes;
  const float* sc = (const float*)scales;
  const int* ci = (const int*)cand_idx;
  const unsigned char* m = (const unsigned char*)ok;
  float* od = (float*)out_d;
  int* os = (int*)out_s;
  int err = 0;
  switch (form) {
    case SQEUCLIDEAN: err = launch_fmt<SQEUCLIDEAN>(fmt, q, c, sc, ci, m, od, os, b, n, nb, block, d, dc, w, k, s); break;
    case L2: err = launch_fmt<L2>(fmt, q, c, sc, ci, m, od, os, b, n, nb, block, d, dc, w, k, s); break;
    case COSINE: err = launch_fmt<COSINE>(fmt, q, c, sc, ci, m, od, os, b, n, nb, block, d, dc, w, k, s); break;
    case DOT: err = launch_fmt<DOT>(fmt, q, c, sc, ci, m, od, os, b, n, nb, block, d, dc, w, k, s); break;
    case L1: err = launch_fmt<L1>(fmt, q, c, sc, ci, m, od, os, b, n, nb, block, d, dc, w, k, s); break;
    case CHEBYSHEV: err = launch_fmt<CHEBYSHEV>(fmt, q, c, sc, ci, m, od, os, b, n, nb, block, d, dc, w, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
