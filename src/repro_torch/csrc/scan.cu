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
// index and mask, for about 3-5 FLOPs per dimension; at the two-stage
// path's shapes (b = 1000, w = 384 of which ~115 unmasked, d = 100, k = R =
// 128) an int8 call needs ~14 MB: 0.0044 ms at 3.35 TB/s.
//
// Design: rank.cu's (this kernel's first design, a block a query, a warp a
// candidate and a block-wide merge per 128-slot tile, was bound by its
// merges: its four formats took the same time while their bytes differ
// 15x). The ring, the per-warp top-k and the merges are topk.cuh's:
// - A query is WPQ warps and a block QPB queries (topk.rank_geometry's
//   shape: the per-query shared memory is rank's). Warp i of a query takes
//   the 32-slot tiles i, i + WPQ, ...; their ok and cand_idx are read
//   coalesced and the unmasked slots compacted into the warp's ring, so
//   masked slots cost nothing.
// - Eight lanes share a candidate, each group four candidates a step:
//   sixteen code rows in flight a warp. A lane reads VEC bytes at a time
//   (16, 8, 4, 2 or 1, binary at most 4: the largest that divides the row
//   stride and the table's base address, picked by the wrapper; code rows
//   are 100, 50 or 13 bytes at d = 100, so a wider load would fault or
//   straddle rows),
//   unpacks and dequantises them in registers, and accumulates against the
//   query row in shared memory; values past d (a padded nibble or sign bit)
//   count as zero. A three-step shuffle sums the partials and, for the
//   norm forms, ||c||^2. The [b, w, dc] code cube never exists in HBM.
// - Each warp keeps its own top-k state; only values that beat its k-th
//   entry enter its buffer, merged by rank when it may overflow and once at
//   the end; a query's warps then merge into the first one's. At the
//   path's shape (~115 unmasked slots, k = 128) every candidate enters and
//   each warp merges once. Every merge ranks by (distance, slot) strictly,
//   so a repeat call is bit-identical, binary's many ties included.
// The accumulation is a template parameter (Gram, l1 or chebyshev) and the
// form's epilogue a runtime switch, to keep the build short.
#include <cuda_fp16.h>
#include <stdint.h>

#include "topk.cuh"

using namespace pdasc;

namespace {

constexpr int THREADS = 256;                  // at most: QPB queries x WPQ warps
constexpr int GROUP = 8;                      // lanes a candidate
constexpr int PER_GROUP = 4;                  // candidates a group a step
constexpr int STEP = 32 / GROUP * PER_GROUP;  // candidates a warp a step
constexpr int INT8 = 0, FP16 = 1, INT4 = 2, BINARY = 3;  // kernels/quantized.py
constexpr int GRAM = 0, ABS_SUM = 1, ABS_MAX = 2;        // accumulations

__host__ __device__ constexpr int acc_of(int form) {
  return form == L1 ? ABS_SUM : form == CHEBYSHEV ? ABS_MAX : GRAM;
}
__host__ __device__ constexpr int item_bytes(int fmt) { return fmt == FP16 ? 2 : 1; }
// values a chunk of VEC container bytes holds
__host__ __device__ constexpr int values_of(int fmt, int vec) {
  return fmt == INT8 ? vec : fmt == FP16 ? vec / 2 : fmt == INT4 ? 2 * vec : 8 * vec;
}

// VEC container bytes at p (VEC-aligned) as 32-bit words, low byte first.
template <int VEC>
__device__ __forceinline__ void load_chunk(uint32_t (&wd)[(VEC + 3) / 4], const unsigned char* p) {
  if constexpr (VEC == 16) {
    const uint4 v = __ldg((const uint4*)p);
    wd[0] = v.x; wd[1] = v.y; wd[2] = v.z; wd[3] = v.w;
  } else if constexpr (VEC == 8) {
    const uint2 v = __ldg((const uint2*)p);
    wd[0] = v.x; wd[1] = v.y;
  } else if constexpr (VEC == 4) {
    wd[0] = __ldg((const unsigned int*)p);
  } else if constexpr (VEC == 2) {
    wd[0] = __ldg((const unsigned short*)p);
  } else {
    wd[0] = __ldg(p);
  }
}

// Code j of a chunk, as a float (before its scale).
template <int FMT>
__device__ __forceinline__ float code_at(const uint32_t* wd, int j) {
  if constexpr (FMT == INT8) {
    return (float)(signed char)(wd[j >> 2] >> (8 * (j & 3)));
  } else if constexpr (FMT == FP16) {
    return __half2float(__ushort_as_half((unsigned short)(wd[j >> 1] >> (16 * (j & 1)))));
  } else if constexpr (FMT == INT4) {  // nibble j: low nibble of a byte first
    const int x = (wd[j >> 3] >> (4 * (j & 7))) & 0xF;
    return (float)((x ^ 0x8) - 0x8);
  } else {  // BINARY: bit j, LSB first; 1 -> +1, 0 -> -1
    return (float)(2 * (int)((wd[j >> 5] >> (j & 31)) & 1u) - 1);
  }
}

__device__ __forceinline__ float finish_form(int form, float g, float qq, float cc) {
  switch (form) {
    case SQEUCLIDEAN: return finish<SQEUCLIDEAN>(g, qq, cc);
    case L2: return finish<L2>(g, qq, cc);
    case COSINE: return finish<COSINE>(g, qq, cc);
    case DOT: return finish<DOT>(g, qq, cc);
    default: return g;  // l1, chebyshev: the accumulator is the distance
  }
}

template <int ACC, int FMT, int VEC>
__global__ void __launch_bounds__(THREADS, 4)
scan_kernel(const float* __restrict__ Q, const unsigned char* __restrict__ codes,
            const float* __restrict__ scales, const int* __restrict__ cidx,
            const unsigned char* __restrict__ ok, float* __restrict__ out_d,
            int* __restrict__ out_s, int b, int n, int nb, int block, int d, int dc,
            int w, int k, int form, int wpq, int qpb) {
  constexpr int VPC = values_of(FMT, VEC);            // values a chunk
  constexpr bool TAIL = FMT == INT4 || FMT == BINARY;  // packed past d
  constexpr int FORM_ACC = ACC == ABS_SUM ? L1 : ACC == ABS_MAX ? CHEBYSHEV : DOT;
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

  const bool norms = form == SQEUCLIDEAN || form == L2 || form == COSINE;
  float qq = 0.0f;
  if (norms) {
    for (int e = lane; e < d; e += 32) qq = fmaf(q[e], q[e], qq);
    qq = warp_reduce<SQEUCLIDEAN>(qq);
  }
  const int grp = lane / GROUP, gl = lane % GROUP;
  const size_t row_bytes = (size_t)dc * item_bytes(FMT);
  const int chunks = (int)(row_bytes / VEC);

  // Distances of the ring's `take` candidates from `head` (STEP at most),
  // and the appends of those that beat the k-th entry.
  auto step = [&](int head, int take) {
    const unsigned char* rowp[PER_GROUP];
    float scale[PER_GROUP], acc[PER_GROUP], cc[PER_GROUP];
#pragma unroll
    for (int h = 0; h < PER_GROUP; ++h) {
      const int j = h * (32 / GROUP) + grp;
      const int row = lrow[(head + (j < take ? j : 0)) % RING];
      rowp[h] = codes + (size_t)row * row_bytes;
      scale[h] = __ldg(scales + min(max(row / block, 0), nb - 1));
      acc[h] = cc[h] = 0.0f;
    }
#pragma unroll 2
    for (int c = gl; c < chunks; c += GROUP) {
      uint32_t wd[PER_GROUP][(VEC + 3) / 4];
#pragma unroll
      for (int h = 0; h < PER_GROUP; ++h) load_chunk<VEC>(wd[h], rowp[h] + (size_t)c * VEC);
      const int e0 = c * VPC;
      const int lim = TAIL ? min(VPC, d - e0) : VPC;  // values before d
#pragma unroll
      for (int j = 0; j < VPC; ++j) {
        if (TAIL && j >= lim) break;
        const float x = q[e0 + j];
#pragma unroll
        for (int h = 0; h < PER_GROUP; ++h) {
          const float y = code_at<FMT>(wd[h], j) * scale[h];
          acc[h] = accumulate<FORM_ACC>(acc[h], x, y);
          if (ACC == GRAM) cc[h] = fmaf(y, y, cc[h]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < PER_GROUP; ++h) {
#pragma unroll
      for (int off = GROUP / 2; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, acc[h], off);
        acc[h] = ACC == ABS_MAX ? fmaxf(acc[h], o) : acc[h] + o;
        if (ACC == GRAM) cc[h] += __shfl_xor_sync(0xffffffffu, cc[h], off);
      }
      const int j = h * (32 / GROUP) + grp;
      const float dist = finish_form(form, acc[h], qq, cc[h]);
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

struct Args {
  const float* Q;
  const unsigned char* codes;
  const float *scales;
  const int* cidx;
  const unsigned char* ok;
  float* od;
  int* os;
  int b, n, nb, block, d, dc, w, k, form, wpq, qpb;
};

template <int ACC, int FMT, int VEC>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem = sizeof(float) * a.qpb * query_floats(a.d, a.k, a.wpq);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)scan_kernel<ACC, FMT, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<ACC, FMT, VEC><<<(a.b + a.qpb - 1) / a.qpb, 32 * a.wpq * a.qpb, smem, s>>>(
      a.Q, a.codes, a.scales, a.cidx, a.ok, a.od, a.os, a.b, a.n, a.nb, a.block, a.d, a.dc,
      a.w, a.k, a.form, a.wpq, a.qpb);
  return 0;
}

template <int ACC, int FMT>
int launch_vec(int vec, const Args& a, cudaStream_t s) {
  if (FMT == BINARY && vec > 4) return (int)cudaErrorInvalidValue;  // 32 values a load
  switch (vec) {
    case 16:
      if constexpr (FMT != BINARY) return launch<ACC, FMT, 16>(a, s);
      return (int)cudaErrorInvalidValue;
    case 8:
      if constexpr (FMT != BINARY) return launch<ACC, FMT, 8>(a, s);
      return (int)cudaErrorInvalidValue;
    case 4: return launch<ACC, FMT, 4>(a, s);
    case 2: return launch<ACC, FMT, 2>(a, s);
    case 1:
      if constexpr (FMT != FP16) return launch<ACC, FMT, 1>(a, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int ACC>
int launch_fmt(int fmt, int vec, const Args& a, cudaStream_t s) {
  switch (fmt) {
    case INT8: return launch_vec<ACC, INT8>(vec, a, s);
    case FP16: return launch_vec<ACC, FP16>(vec, a, s);
    case INT4: return launch_vec<ACC, INT4>(vec, a, s);
    case BINARY: return launch_vec<ACC, BINARY>(vec, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Q[b,d] fp32; codes[n,dc] in the container of fmt (0 int8, 1 fp16, 2 int4
// packed in int8, 3 binary packed in uint8); scales[nb] fp32, one per block
// rows; cand_idx[b,w] int32; ok[b,w] bool; out dists[b,k] fp32, slots[b,k]
// int32. Requires 1 <= k <= w; a block of qpb queries of wpq warps each (at
// most 8 warps); vec (16, 8, 4, 2 or 1; fp16 at least 2, binary at most 4)
// bytes a code load, which must divide the row stride and the table's
// address.
extern "C" int scan_launch(const void* Q, const void* codes, const void* scales,
                           const void* cand_idx, const void* ok, void* out_d,
                           void* out_s, int b, int n, int nb, int block, int d,
                           int dc, int w, int k, int form, int fmt, int wpq, int qpb,
                           int vec, void* stream) {
  cudaGetLastError();
  if (b <= 0) return 0;
  const size_t row_bytes = (size_t)dc * item_bytes(fmt);
  if (k < 1 || k > w || n < 1 || nb < 1 || block < 1 || d < 1 || dc < 1 || wpq < 1 ||
      qpb < 1 || wpq * qpb > THREADS / 32 || form < SQEUCLIDEAN || form > CHEBYSHEV ||
      vec < 1 || vec > 16 || (vec & (vec - 1)) || row_bytes % vec || (size_t)codes % vec)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)Q, (const unsigned char*)codes, (const float*)scales,
               (const int*)cand_idx, (const unsigned char*)ok, (float*)out_d, (int*)out_s,
               b, n, nb, block, d, dc, w, k, form, wpq, qpb};
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  switch (acc_of(form)) {
    case GRAM: err = launch_fmt<GRAM>(fmt, vec, a, s); break;
    case ABS_SUM: err = launch_fmt<ABS_SUM>(fmt, vec, a, s); break;
    default: err = launch_fmt<ABS_MAX>(fmt, vec, a, s); break;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
