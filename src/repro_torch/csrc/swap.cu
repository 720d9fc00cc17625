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
// g = 256 with k = 128 reads 4*G*g*g bytes (268 MB) and writes 4*G*k*g
// (134 MB): 0.121 ms at 3.35 TB/s.
//
// Design: the TPU kernel walks row tiles in sequence and adds into one
// revisited [k, g] output block (kmedoids.py:49-72); CUDA blocks cannot
// carry that, so a block owns one group (blockIdx.y), a 64-column tile
// (blockIdx.x) and a range of slots (blockIdx.z), one thread a column, for
// the whole walk over its slots' rows.
// - A small first kernel orders each group's valid rows by slot n1_o,
//   ascending within a slot (a stable counting sort, one warp a group), and
//   writes d1, d2 and the slot in that order, and where each slot's rows
//   start. Walking rows in that order, T[i, j] is a running sum in a
//   register, stored once when slot i's rows end: no load-add-store chain
//   through shared memory, no atomics, no idle warp, and each slot adds its
//   rows in ascending order, the same on every run (the build takes argmins
//   over it). S sums in walk order, also fixed.
// - The rows stream in walk order through a 4-stage cp.async ring of
//   16-row stages (12 KB in flight a block, four blocks an SM); the ordered
//   caches are staged CHUNK rows at a time, so a group of any size fits.
// - Where the [k, 64] T tile, the ring and the staged caches fit in one
//   block's shared memory, one block holds every slot (blockIdx.z = 0
//   only) and writes S + T. Past that (k > ~760) each block holds KB slots
//   and walks only their rows, which lie contiguous in walk order; the
//   last slot block also walks the valid rows with no slot (they add to S
//   only). Each block then writes its T rows and its partial S over its
//   rows, and a third kernel adds the partials, in slot-block order, to
//   every row of the column: the same sum on every run.
// - The output tile goes out in 16-byte stores, row by row.
#include "common.cuh"

using namespace pdasc;

namespace {

constexpr int BN = 64, THREADS = BN;  // one thread a column
constexpr int R = 16, STAGES = 4;     // ring: 16-row stages
constexpr int CHUNK = 1024;           // rows whose caches a block stages at once
constexpr int KB = 256;               // slots a block once all k do not fit
constexpr int ORDER_WARPS = 4;        // groups a block of the order kernel
constexpr int FINISH_THREADS = 256;   // columns a block of the finish kernel
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block

// Rows whose caches a sweep block stages at once.
__host__ __device__ int staged_rows(int g) {
  const int rows = (g + R - 1) / R * R;
  return rows < CHUNK ? rows : CHUNK;
}

// Shared bytes of one sweep block holding kb slots; mirrored by
// kmedoids.swap_smem_bytes.
size_t smem_bytes(int g, int kb) {
  return sizeof(float) * ((size_t)kb * BN + STAGES * R * BN + BN) +
         (sizeof(float4) + sizeof(int)) * (size_t)staged_rows(g);
}

// Slots a sweep block holds: all k where they fit, else KB; mirrored by
// kmedoids.swap_geometry.
int slot_block(int g, int k) { return smem_bytes(g, k) <= SMEM_LIMIT ? k : KB; }

// The walk order of each group, one warp a group: its valid rows grouped by
// slot (slot k, a valid row with no T term, last), ascending within a
// slot. A stable counting sort: slot counts, an exclusive scan, then 32
// rows at a time, each placed at its slot's offset plus its rank among the
// lanes of equal slot (match_any). Writes perm[G, g] (walk position ->
// row), rc[G, g] (d1, d2, slot in walk order), off[G, k + 1] (walk
// position where each slot's rows start; null unless the slots split
// across blocks) and nv[G] (valid rows).
__global__ void __launch_bounds__(ORDER_WARPS * 32)
swap_order_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                  const int* __restrict__ n1, const unsigned char* __restrict__ valid,
                  int* __restrict__ perm, float4* __restrict__ rc, int* __restrict__ off,
                  int* __restrict__ nv, int G, int g, int k) {
  extern __shared__ int counts[];  // [ORDER_WARPS][k + 1]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int grp = blockIdx.x * ORDER_WARPS + w;
  if (grp >= G) return;  // warp-uniform; no block barrier below
  int* bucket = counts + w * (k + 1);
  const size_t base = (size_t)grp * g;
  auto key = [&](int o) {
    if (o >= g || !valid[base + o]) return -1;
    const int sl = n1[base + o];
    return sl >= 0 && sl < k ? sl : k;
  };
  for (int i = lane; i <= k; i += 32) bucket[i] = 0;
  __syncwarp();
  for (int o = lane; o < g; o += 32) {
    const int sl = key(o);
    if (sl >= 0) atomicAdd(&bucket[sl], 1);  // counts only
  }
  __syncwarp();
  int carry = 0;
  for (int b0 = 0; b0 <= k; b0 += 32) {
    const int i = b0 + lane, c = i <= k ? bucket[i] : 0;
    int v = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (i <= k) {
      bucket[i] = carry + v - c;
      if (off != nullptr) off[(size_t)grp * (k + 1) + i] = carry + v - c;
    }
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
  __syncwarp();
  for (int b0 = 0; b0 < g; b0 += 32) {
    const int o = b0 + lane, sl = key(o);
    const unsigned same = __match_any_sync(0xffffffffu, sl);
    const int rank = __popc(same & ((1u << lane) - 1));
    const int pos = sl >= 0 ? bucket[sl] + rank : 0;
    __syncwarp();
    if (sl >= 0) {
      perm[base + pos] = o;
      rc[base + pos] = make_float4(d1[base + o], d2[base + o], __int_as_float(sl), 0.0f);
      if (rank == 0) bucket[sl] += __popc(same);
    }
    __syncwarp();
  }
  if (lane == 0) nv[grp] = carry;
}

__global__ void __launch_bounds__(THREADS)
swap_kernel(const float* __restrict__ D, const int* __restrict__ perm,
            const float4* __restrict__ rc, const int* __restrict__ nvs,
            const int* __restrict__ off, float* __restrict__ out,
            float* __restrict__ Sp, int g, int k, int kb) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = staged_rows(g);
  float* acc = smem;                         // [kb][BN]
  float* ring = acc + (size_t)kb * BN;       // [STAGES][R][BN]
  float* Ss = ring + STAGES * R * BN;        // [BN]
  float4* rcs = (float4*)(Ss + BN);          // [chunk] d1, d2, slot in walk order
  int* ps = (int*)(rcs + chunk);             // [chunk] walk position -> row

  const size_t grp = blockIdx.y;
  const int z = blockIdx.z, nz = gridDim.z;
  const int i0 = z * kb, i1 = min(i0 + kb, k);
  const int j0 = blockIdx.x * BN, j = threadIdx.x;
  const float* Dg = D + grp * g * g;
  const int* go = off + grp * (k + 1);
  // this block's rows in walk order: its slots', and on the last slot
  // block also the valid rows with no slot (an unsplit block: all of them)
  const int lo = nz == 1 ? 0 : go[i0];
  const int hi = z == nz - 1 ? nvs[grp] : go[i1];

  // Each slot's T is a running register sum, stored once when its rows end.
  float S = 0.0f, run = 0.0f;
  int cur = k;
  // the rows [c0, c0 + nc) in walk order, one chunk of caches at a time
  // (with no rows, one empty pass)
  int c0 = lo;
  do {
    const int nc = min(chunk, hi - c0);
    if (c0 > lo) __syncthreads();  // the last chunk's stages and caches are read
    for (int i = j; i < nc; i += THREADS) {
      ps[i] = perm[grp * g + c0 + i];
      rcs[i] = rc[grp * g + c0 + i];
    }
    if (c0 == lo)  // while the first caches load
      for (int e = j; e < kb * BN; e += THREADS) acc[e] = 0.0f;
    __syncthreads();

    const int nst = (nc + R - 1) / R;
    auto issue = [&](int s) {
      if (s < nst) {
        float* st = ring + (s % STAGES) * R * BN;
        if ((g & 3) == 0) {
          for (int e = j; e < R * BN / 4; e += THREADS) {
            const int r = e / (BN / 4), c = 4 * (e % (BN / 4)), i = s * R + r;
            const bool ok = i < nc && j0 + c < g;
            cp_async16(st + r * BN + c, ok ? Dg + (size_t)ps[i] * g + j0 + c : Dg, ok);
          }
        } else {
          for (int e = j; e < R * BN; e += THREADS) {
            const int r = e / BN, c = e % BN, i = s * R + r;
            const bool ok = i < nc && j0 + c < g;
            cp_async4(st + r * BN + c, ok ? Dg + (size_t)ps[i] * g + j0 + c : Dg, ok);
          }
        }
      }
      cp_commit();  // empty groups keep the wait count uniform
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);

    for (int s = 0; s < nst; ++s) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      issue(s + STAGES - 1);
      const float* st = ring + (s % STAGES) * R * BN;
      const int n = min(R, nc - s * R);
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const float4 c = rcs[s * R + r];
        const float x = st[r * BN + j];
        const int sl = __float_as_int(c.z);
        S += fminf(x - c.x, 0.0f);
        if (sl != cur) {  // block-uniform
          if (cur < k) acc[(cur - i0) * BN + j] = run;
          cur = sl;
          run = 0.0f;
        }
        run += x >= c.x ? fminf(c.y, x) - c.x : 0.0f;
      }
    }
    c0 += chunk;
  } while (c0 < hi);
  if (cur < k) acc[(cur - i0) * BN + j] = run;
  Ss[j] = nz == 1 ? S : 0.0f;  // split: S adds in the finish kernel
  if (nz > 1 && j0 + j < g) Sp[(grp * nz + z) * g + j0 + j] = S;
  __syncthreads();

  float* og = out + (grp * k + i0) * g;
  const int rows = i1 - i0;
  if ((g & 3) == 0) {
    for (int e = j; e < rows * BN / 4; e += THREADS) {
      const int i = e / (BN / 4), c = 4 * (e % (BN / 4));
      if (j0 + c >= g) continue;
      const float4 a = *(const float4*)(acc + i * BN + c);
      const float4 sv = *(const float4*)(Ss + c);
      *(float4*)(og + (size_t)i * g + j0 + c) =
          make_float4(sv.x + a.x, sv.y + a.y, sv.z + a.z, sv.w + a.w);
    }
  } else {
    for (int e = j; e < rows * BN; e += THREADS) {
      const int i = e / BN, c = e % BN;
      if (j0 + c < g) og[(size_t)i * g + j0 + c] = Ss[c] + acc[e];
    }
  }
}

// The split sweep's S: the slot blocks' partial sums, added in slot-block
// order, then onto every T row of the column.
__global__ void __launch_bounds__(FINISH_THREADS)
swap_finish_kernel(const float* __restrict__ Sp, float* __restrict__ out, int g,
                   int k, int nz) {
  const size_t grp = blockIdx.y;
  const int j = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (j >= g) return;
  float S = 0.0f;
  for (int z = 0; z < nz; ++z) S += Sp[(grp * nz + z) * g + j];
  float* o = out + grp * k * g + j;
  for (int i = 0; i < k; ++i) o[(size_t)i * g] = S + o[(size_t)i * g];
}

}  // namespace

// D[G,g,g], d1/d2[G,g] fp32; n1[G,g] int32; valid[G,g] bool; out[G,k,g];
// perm[G,g] int32, rc[G,g,4] fp32, off[G,k+1] int32, nv[G] int32 and
// Sp[G,nz,g] fp32 (nz = ceil(k / slot_block), unused when nz = 1) scratch.
extern "C" int swap_launch(const void* D, const void* d1, const void* d2,
                           const void* n1, const void* valid, void* out, void* perm,
                           void* rc, void* off, void* nv, void* Sp, int G, int g,
                           int k, void* stream) {
  cudaGetLastError();
  if (G <= 0 || g <= 0) return 0;
  const int kb = slot_block(g, k), nz = (k + kb - 1) / kb;
  const size_t smem = smem_bytes(g, kb);
  // the order kernel's slot counts: k <= 14,527 (kmedoids.SWAP_MAX_K)
  const size_t osmem = sizeof(int) * ORDER_WARPS * ((size_t)k + 1);
  if (k < 1 || G > 65535 || nz > 65535 || smem > SMEM_LIMIT || osmem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = set_smem((const void*)swap_order_kernel, osmem);
  if (err != cudaSuccess) return (int)err;
  swap_order_kernel<<<(G + ORDER_WARPS - 1) / ORDER_WARPS, ORDER_WARPS * 32, osmem, s>>>(
      (const float*)d1, (const float*)d2, (const int*)n1, (const unsigned char*)valid,
      (int*)perm, (float4*)rc, nz > 1 ? (int*)off : nullptr, (int*)nv, G, g, k);
  err = set_smem((const void*)swap_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g + BN - 1) / BN, G, nz);
  swap_kernel<<<grid, THREADS, smem, s>>>((const float*)D, (const int*)perm,
                                          (const float4*)rc, (const int*)nv,
                                          (const int*)off, (float*)out, (float*)Sp,
                                          g, k, kb);
  if (nz > 1)
    swap_finish_kernel<<<dim3((g + FINISH_THREADS - 1) / FINISH_THREADS, G),
                         FINISH_THREADS, 0, s>>>((const float*)Sp, (float*)out, g, k, nz);
  return (int)cudaGetLastError();
}
