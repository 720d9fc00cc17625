// Shared device code of the per-query candidate kernels (rank.cu, scan.cu):
// warps a query, each compacting the unmasked slots of its 32-slot tiles
// into a ring, keeping its own top-k state with a buffer of the values that
// beat its k-th entry, and the merge of a query's warps' states at the end.
//
// Shared memory of a block (mirrored by topk.rank_smem_bytes): per query
// its row (padded to 4) and, per warp, a top-k state (k padded to 2), a
// CAP-entry buffer and a RING-entry ring of compacted candidates, each as
// a distance or row and an id or slot; every query's row starts 16-byte
// aligned. Every merge ranks by (distance, slot) strictly (key_less), so
// the result does not depend on which warp or step found an entry: a
// repeat call is bit-identical.
#pragma once

#include "common.cuh"

namespace pdasc {

constexpr int CAP = 64;   // buffer entries a warp
constexpr int RING = 64;  // compacted candidates a warp

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
// Where every buffer entry lies below BIG (the usual case), a state entry
// still at its init (BIG, id < 0) has all c of them below it, uncounted.
__device__ void warp_merge(float* sd, int* si, const float* bd, const int* bi, int c,
                           int k) {
  const int lane = threadIdx.x & 31;
  bool real = true;
#pragma unroll
  for (int h = 0; h < CAP / 32; ++h) real &= lane + 32 * h >= c || bd[lane + 32 * h] < BIG;
  const bool below_big = __all_sync(0xffffffffu, real);
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
      if (below_big && id < 0)
        p += c;
      else
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

// One warp's top-k: the ascending state (sd, si)[k] in shared memory,
// initialised to BIG with distinct negative ids (below any real slot at
// BIG), its k-th entry in registers, and the buffer (bd, bi)[CAP].
struct WarpTopk {
  float* sd;
  int* si;
  float* bd;
  int* bi;
  int k;
  float kd = BIG;  // the state's k-th entry
  int ks = -1;
  int bc = 0;      // buffer fill

  // `state`: the warp's warp_floats(k): state, buffer, then the ring.
  __device__ WarpTopk(float* state, int k_) : k(k_) {
    sd = state;
    si = (int*)(sd + k);
    bd = (float*)(si + k);
    bi = (int*)(bd + CAP);
    for (int i = threadIdx.x & 31; i < k; i += 32) { sd[i] = BIG; si[i] = i - k; }
  }
  __device__ int* ring_rows() const { return bi + CAP; }      // [RING]
  __device__ int* ring_slots() const { return bi + CAP + RING; }

  // Warp-collective: each lane's (dist, id) where `valid` is appended to
  // the buffer if it beats the k-th entry.
  __device__ __forceinline__ void offer(bool valid, float dist, int id) {
    const bool pass = valid && key_less(dist, id, kd, ks);
    const unsigned pm = __ballot_sync(0xffffffffu, pass);
    if (pass) {
      const int at = bc + __popc(pm & ((1u << (threadIdx.x & 31)) - 1));
      bd[at] = dist;
      bi[at] = id;
    }
    bc += __popc(pm);
  }

  // Merge the buffer into the state if `room` more appends could overflow it.
  __device__ __forceinline__ void make_room(int room) {
    if (bc > CAP - room) {
      __syncwarp();
      warp_merge(sd, si, bd, bi, bc, k);
      bc = 0;
      kd = sd[k - 1];
      ks = si[k - 1];
    }
  }

  // The last merge; then the count of real entries (ids >= 0, a prefix of
  // the state: every real distance lies below the BIG init entries) goes
  // to the first ring slot, for the query's other warps.
  __device__ __forceinline__ void flush() {
    if (bc > 0) {
      __syncwarp();
      warp_merge(sd, si, bd, bi, bc, k);
    }
    int real = 0;
    for (int base = 0; base < k; base += 32) {
      const int i = base + (threadIdx.x & 31);
      const unsigned m = __ballot_sync(0xffffffffu, i < k && si[i] >= 0);
      real += __popc(m);
      if (m != 0xffffffffu) break;
    }
    if ((threadIdx.x & 31) == 0) ring_rows()[0] = real;
  }

  // After a block barrier, by every warp wi of a live query's wpq: the
  // real entries of the query's warps (each list ascending, with its count
  // in its first ring slot) merge by rank: an entry's place is its index
  // in its list plus the entries below it in each other list (a binary
  // search); places past them are BIG with slot 0 (repro's -1 init
  // clipped). Slots are written clipped to [0, w).
  __device__ void write_query(int wi, int wpq, int w, float* out_d, int* out_s) const {
    const int lane = threadIdx.x & 31;
    const float* sd0 = sd - wi * warp_floats(k);  // the query's first warp
    int total = 0;
    for (int j = 0; j < wpq; ++j) total += *((const int*)(sd0 + j * warp_floats(k)) + 2 * k + 2 * CAP);
    const int own = ring_rows()[0];
    for (int p = lane; p < own; p += 32) {
      const float v = sd[p];
      const int id = si[p];
      int at = p;
      for (int j = 0; j < wpq; ++j) {
        if (j == wi) continue;
        const float* od = sd0 + j * warp_floats(k);
        const int* oi = (const int*)(od + k);
        int lo = 0, hi = *(oi + k + 2 * CAP);  // that warp's real count
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (key_less(od[mid], oi[mid], v, id)) lo = mid + 1; else hi = mid;
        }
        at += lo;
      }
      if (at < k) {
        out_d[at] = v;
        out_s[at] = min(id, w - 1);
      }
    }
    for (int i = min(total, k) + wi * 32 + lane; i < k; i += wpq * 32) {
      out_d[i] = BIG;
      out_s[i] = 0;
    }
  }
};

// The ring of one warp's compacted candidates: the unmasked slots of its
// tiles t0, t0 + stride, ... (< tiles) of a query's w slots, with their
// table rows clipped to [0, n). A tile's ok and cand_idx are read
// coalesced, a slot a lane, one tile ahead of their use; __ballot_sync /
// __popc compact the unmasked ones, so masked slots cost nothing (a masked
// slot never beats the BIG init entries, which carry lower ids). `step(at,
// take)` handles the `take` (at most STEP) candidates from ring position
// `at` (rows lrow[(at + j) % RING], slots lslot[...]) whenever the ring
// holds STEP, and once for the rest.
template <int STEP, class Step>
__device__ __forceinline__ void for_each_candidate(const int* crow, const unsigned char* okrow,
                                                   int w, int n, int t0, int stride,
                                                   int tiles, int* lrow, int* lslot,
                                                   Step&& step) {
  static_assert(STEP - 1 + 32 <= RING, "a tile always fits the ring");
  const int lane = threadIdx.x & 31;
  bool nv = false;
  int nr = 0;
  if (t0 < tiles) {  // the first tile's mask and rows
    const int slot = t0 * 32 + lane;
    nv = slot < w && okrow[slot];
    nr = slot < w ? crow[slot] : 0;
  }
  int head = 0, cnt = 0;
  for (int t = t0; t < tiles; t += stride) {
    const bool v = nv;
    const int r = min(max(nr, 0), n - 1), slot = t * 32 + lane;
    const int tn = t + stride;  // the next tile's, read ahead
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
    while (cnt >= STEP) {
      step(head, STEP);
      head = (head + STEP) % RING;
      cnt -= STEP;
      __syncwarp();  // the ring's entries are read before they are reused
    }
  }
  if (cnt > 0) {
    step(head, cnt);
    __syncwarp();
  }
}

}  // namespace pdasc
