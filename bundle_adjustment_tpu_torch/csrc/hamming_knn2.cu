// Hamming 2-NN over packed 256-bit descriptors, for Hopper (sm_90a).
//
// Replaces: bundle_adjustment_tpu/ops/hamming_pallas.py, _knn2_kernel
// (driven by knn2_pallas).  For each query row of d1 (N1, 8 words) it finds
// the smallest Hamming distance over the train rows of d2 (N2, 8 words), the
// index of that row, and the second-smallest distance, without storing the
// N1 x N2 distance matrix.
//
// Semantics (the XLA oracle hamming.knn2 / _top2_rows):
//   * train rows are scanned in increasing order and the running
//     (best, idx, second) updates with strict '<', so idx is the FIRST
//     index of the minimum and a tie gives second == best;
//   * an invalid train row scores exactly INVALID_DIST (1e9) -- the Pallas
//     kernel adds 1e9 to the count instead, which the ratio test cannot tell
//     apart (best < INVALID_DIST gate);
//   * with a single train row, second stays +inf.
//
// What bounds it on this card: at the main path's 4000 x 4000 the inputs
// are 2 x 128 KB, so bytes are nothing; the work is 4000*4000*8 XOR+POPC
// plus the compare/select, integer ALU work on the CUDA cores (the tensor
// cores have no popcount).  Design: one thread per query row holds its 8
// words in registers; train rows stream through shared memory in tiles of
// 256 rows, each word read by all threads of the block at once (a shared
// memory broadcast, no bank conflicts).  Distances stay integers until the
// final store, so results are exact.  Small blocks (64 threads) spread the
// 4000 queries over ~63 SMs; splitting the train set across blocks to fill
// all 132 SMs is later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 256;
constexpr int kInvalid = 1000000000;  // INVALID_DIST, exact in float32

__global__ void knn2_kernel(const uint32_t* __restrict__ d1, int n1,
                            const uint32_t* __restrict__ d2, int n2,
                            const uint8_t* __restrict__ valid2,
                            float* __restrict__ best_out,
                            int* __restrict__ idx_out,
                            float* __restrict__ second_out) {
  __shared__ uint32_t tile[kTile][8];
  __shared__ uint8_t tvalid[kTile];

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = (q < n1) ? d1[(size_t)q * 8 + k] : 0u;

  int best = INT_MAX, second = INT_MAX, idx = 0;
  for (int t0 = 0; t0 < n2; t0 += kTile) {
    const int nt = min(kTile, n2 - t0);
    for (int e = threadIdx.x; e < nt * 8; e += blockDim.x) {
      tile[e >> 3][e & 7] = d2[(size_t)t0 * 8 + e];
    }
    for (int j = threadIdx.x; j < nt; j += blockDim.x) tvalid[j] = valid2[t0 + j];
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      int d = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) d += __popc(a[k] ^ tile[j][k]);
      d = tvalid[j] ? d : kInvalid;
      if (d < best) {
        second = best;
        best = d;
        idx = t0 + j;
      } else if (d < second) {
        second = d;
      }
    }
    __syncthreads();
  }
  if (q < n1) {
    best_out[q] = (best == INT_MAX) ? INFINITY : (float)best;
    idx_out[q] = idx;
    second_out[q] = (second == INT_MAX) ? INFINITY : (float)second;
  }
}

}  // namespace

extern "C" int hamming_knn2(const void* d1, int n1, const void* d2, int n2,
                            const void* valid2, void* best, void* idx,
                            void* second, void* stream) {
  if (n1 > 0) {
    const int blocks = (n1 + kThreads - 1) / kThreads;
    knn2_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)d1, n1, (const uint32_t*)d2, n2,
        (const uint8_t*)valid2, (float*)best, (int*)idx, (float*)second);
  }
  return (int)cudaGetLastError();
}
