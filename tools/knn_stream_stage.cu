// knn_stream_stage.cu — what each piece of a stage of knn.cu's streaming
// route costs when the ring is loaded by cp.async and the queries are split
// a stage, as that route was first built for the tensor cores (its Gram
// forms now load by TMA, with the queries split once a call: this
// measurement is why). Standalone (no PyTorch); build and run from the
// root of the checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/tools/knn_stream_stage tools/knn_stream_stage.cu
//   build/tools/knn_stream_stage
//
// The stage at the route's timed shape (128 queries x 128 DB rows a block,
// 32 columns of d a stage, a 3-stage cp.async ring, 2 x 64 rows of 3xTF32
// wgmma m64n128k8 with the stage's products promoted into an fp32 sum),
// one block an SM on 128 SMs, 49 x 48 stages a block (d = 1536, 6,272 DB
// rows a split), built up level by level:
//   L0  the products and their promotion, one block barrier a stage;
//   L1  + each warp's A fragment read by ldmatrix and split in registers;
//   L2  + the stage's query rows split into hi and lo in shared memory,
//       with a fence and a second block barrier;
//   L3  + the ring's loads (DB rows shared by the 8 blocks of a split,
//       the block's query rows), 2,048 16-byte cp.async a stage;
// each with cvt.rna.tf32 rounding and with the integer form (tf32_int).
// Prints the time and the cycles a stage of each. The ideal is 1536 cycles
// a stage: 24 wgmma of 64 cycles each at the TF32 peak.
#include <stdint.h>
#include <cstdio>

#include "../src/repro_torch/csrc/common.cuh"
#include "../src/repro_torch/csrc/wgmma.cuh"

using namespace pdasc;

constexpr int KB = 32, RS = KB + 4, TN = 128, BQ = 128, NST = 3;  // as knn.cu's stream
constexpr int SPLITS = 16, SPLIT_ROWS = 6272, D = 1536;          // its geometry there

template <int LEVEL, bool INT_ROUNDING>
__global__ void __launch_bounds__(256, 1)
stage_bench(const float* __restrict__ DB, const float* __restrict__ Q, float* out,
            long long* cycles, int stages) {
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                       // [NST][TN + BQ][RS]
  float* Qh = ring + NST * (TN + BQ) * RS;  // [BQ * KB], core-matrix order
  float* Ql = Qh + BQ * KB;
  for (int i = threadIdx.x; i < NST * (TN + BQ) * RS + 2 * BQ * KB; i += 256)
    smem[i] = 0.001f * (i % 13);
  fence_async_smem();
  __syncthreads();
  auto round = [](float x) { return INT_ROUNDING ? tf32_int(x) : tf32(x); };
  float acc[64], part[64];
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t ah[2][4] = {}, al[2][4] = {};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lm = lane >> 3, lr = lane & 7;
  const int a_off = (warp * 16 + lr + 8 * (lm & 1)) * RS + 4 * (lm >> 1);
  const int n0 = (blockIdx.x % SPLITS) * SPLIT_ROWS;  // 8 blocks share a split's rows
  auto issue = [&](int s) {
    if (LEVEL >= 3 && s < stages) {
      float* st = ring + (s % NST) * (TN + BQ) * RS;
      const int c0 = (s % (D / KB)) * KB, t0 = n0 + (s / (D / KB)) * TN;
      const int c = 4 * (threadIdx.x % 8);
      for (int r = threadIdx.x / 8; r < TN; r += 32)
        cp_async16(st + r * RS + c, DB + (size_t)(t0 + r) * D + c0 + c, true);
      for (int r = threadIdx.x / 8; r < BQ; r += 32)
        cp_async16(st + (TN + r) * RS + c, Q + (size_t)r * D + c0 + c, true);
    }
    cp_commit();
  };
  issue(0);
  issue(1);
  const long long t0 = clock64();
  for (int s = 0; s < stages; ++s) {
    cp_wait<1>();
    __syncthreads();
    issue(s + 2);
    const float* st = ring + (s % NST) * (TN + BQ) * RS;
    if (LEVEL >= 2) {
      for (int e = threadIdx.x; e < BQ * (KB / 4); e += 256) {
        const int r = e % BQ, c = 4 * (e / BQ);
        const float4 v = *(const float4*)(st + (TN + r) * RS + c);
        const int o = ((r >> 3) * (KB / 4) + (c >> 2)) * 32 + (r & 7) * 4;
        float4 h, l;
        h.x = __uint_as_float(round(v.x));
        h.y = __uint_as_float(round(v.y));
        h.z = __uint_as_float(round(v.z));
        h.w = __uint_as_float(round(v.w));
        l.x = __uint_as_float(round(v.x - h.x));
        l.y = __uint_as_float(round(v.y - h.y));
        l.z = __uint_as_float(round(v.z - h.z));
        l.w = __uint_as_float(round(v.w - h.w));
        *(float4*)(Qh + o) = h;
        *(float4*)(Ql + o) = l;
      }
      fence_async_smem();
      __syncthreads();
    }
    auto split = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
      if (LEVEL >= 1) {
        uint32_t raw[4];
        ldsm_x4(raw, st + a_off + kk * 8);
        for (int i = 0; i < 4; ++i) {
          const float x = __uint_as_float(raw[i]);
          h[i] = round(x);
          l[i] = round(x - __uint_as_float(h[i]));
        }
      }
    };
    split(0, ah[0], al[0]);
#pragma unroll
    for (int kk = 0; kk < KB / 8; ++kk) {
      const int b = kk & 1;
      const uint64_t dh = kmajor_desc(Qh + kk * 64, KB * 32);
      const uint64_t dl = kmajor_desc(Ql + kk * 64, KB * 32);
      wg_fence();
      Wgmma<128>::run(part, al[b], dh, kk > 0);
      Wgmma<128>::run(part, ah[b], dl);
      Wgmma<128>::run(part, ah[b], dh);
      wg_commit();
      if (kk + 1 < KB / 8) {
        wg_wait<1>();
        keep(ah[b ^ 1]);
        keep(al[b ^ 1]);
        split(kk + 1, ah[b ^ 1], al[b ^ 1]);
      }
    }
    wg_wait<0>();
    keep(part);
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    keep(acc);
    keep(ah[0]);
    keep(al[0]);
    keep(ah[1]);
    keep(al[1]);
  }
  const long long t1 = clock64();
  float sum = 0.0f;
  for (int i = 0; i < 64; ++i) sum += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = sum;  // keeps the products
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

int main() {
  const int blocks = 8 * SPLITS, stages = (SPLIT_ROWS / TN) * (D / KB);
  float *DB, *Q, *out;
  long long* cycles;
  cudaMalloc(&DB, (size_t)SPLITS * SPLIT_ROWS * D * 4);
  cudaMalloc(&Q, (size_t)BQ * D * 4);
  cudaMalloc(&out, blocks * 256 * 4);
  cudaMalloc(&cycles, blocks * 8);
  cudaMemset(DB, 0, (size_t)SPLITS * SPLIT_ROWS * D * 4);  // values do not change the timing
  cudaMemset(Q, 0, (size_t)BQ * D * 4);
  const size_t smem = 4 * (NST * (TN + BQ) * RS + 2 * BQ * KB);
  int failed = 0;
  auto run = [&](auto kernel, const char* name) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kernel<<<16, 256, smem>>>(DB, Q, out, cycles, 100);  // warm up
    cudaDeviceSynchronize();
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    kernel<<<blocks, 256, smem>>>(DB, Q, out, cycles, stages);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    long long c;
    cudaMemcpy(&c, cycles, 8, cudaMemcpyDeviceToHost);
    const cudaError_t err = cudaGetLastError();
    failed |= err != cudaSuccess;
    printf("%s: %.3f ms, %.1f cycles a stage (%s)\n", name, ms, (double)c / stages,
           cudaGetErrorString(err));
  };
  run(stage_bench<0, false>, "L0 products, promotion, one barrier");
  run(stage_bench<1, false>, "L1 + A fragment split (cvt)");
  run(stage_bench<2, false>, "L2 + query split, second barrier (cvt)");
  run(stage_bench<3, false>, "L3 + ring loads (cvt)");
  run(stage_bench<1, true>, "L1 (integer rounding)");
  run(stage_bench<2, true>, "L2 (integer rounding)");
  run(stage_bench<3, true>, "L3 (integer rounding)");
  return failed;
}
