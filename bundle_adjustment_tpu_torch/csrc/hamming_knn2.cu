// Hamming 2-NN over packed 256-bit descriptors, for Hopper (sm_90a).
//
// Replaces: bundle_adjustment_tpu/ops/hamming_pallas.py, _knn2_kernel
// (driven by knn2_pallas).  For each query row of d1 (N1, 8 words) it finds
// the smallest Hamming distance over the train rows of d2 (N2, 8 words), the
// index of that row, and the second-smallest distance, without storing the
// N1 x N2 distance matrix.
//
// Semantics (the XLA oracle hamming.knn2 / _top2_rows): idx is the FIRST
// index of the minimum and a tie gives second == best; an invalid train row
// scores exactly INVALID_DIST (1e9) -- the Pallas kernel adds 1e9 to the
// count instead, which the ratio test cannot tell apart (best < INVALID_DIST
// gate); with a single train row, second stays +inf.
//
// Distances are computed as the TPU kernel computes them on its matrix unit
// (hamming_pallas.py:46-49): d = popc(a) + popc(b) - 2 * popc(a AND b).  The
// inner term is an exact integer product on the tensor cores: the binary
// mma.m16n8k256 .b1 .and.popc, one MMA per 16 x 8 tile of pairs, the packed
// words used as they are.  (An m16n8k32 .s8 form on 0/1 bytes, eight MMAs per
// tile on words expanded to bytes, was built beside it and measured slower on
// an H100: 0.0537 against 0.0226 ms of device time at 4000 x 4000.)  popc(a)
// and popc(b) come from __popc as the rows load.  Every sum is an s32 integer,
// so the result is exact.
//
// Layout: a 2-D grid of 128-query tiles x train splits.  Each warp holds two
// 16-row query tiles as MMA fragments and walks the block's train split in
// 8-row tiles staged through shared memory; each thread folds the (best, idx,
// second) of its two query rows per tile over the columns of its accumulator
// fragment, in increasing train index (strict '<').  The four lanes that share
// a query row merge by shuffles; one partial per (query, split) goes to a
// scratch buffer that the wrapper allocates.  A second small pass merges the
// splits per query.  Every merge uses the rule that is independent of merge
// order and equals the sequential scan with strict '<':
//   best   = the lexicographic minimum of (distance, index) over the parts;
//   second = the smallest of all the other candidates' values
//            (min of the loser's best and both parts' seconds).
// The wrapper (ops/hamming_kernel.split_plan) picks the split count from the
// card's SM count and the query tile, which it passes to the C entry to be
// checked against kBlockQ.
//
// What bounds it on this card: operations, and before them latency.  At the
// main path's 4000 x 4000 the inputs are 2 x 128 KB and the products 0.13 M
// binary MMAs, a few microseconds of tensor-core time; the running top-2 is
// 16 M compare/selects on the CUDA cores.  The grid has 32 x 17 = 544 blocks
// of 4 warps, four times the 132 SMs, where the one-thread-per-query design
// filled 63 SMs with two warps each.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTiles = 2;                       // 16-row query tiles per warp
constexpr int kBlockQ = 16 * kQTiles * kWarps;   // 128 queries per block
constexpr int kChunk = 64;                       // train rows staged at a time
constexpr int kStride = 12;                      // words per staged row (8 + pad)
constexpr int kInvalid = 1000000000;             // INVALID_DIST, exact in float32

// (b, i, s) <- merge of (b, i, s) and (b2, i2, s2); see the header.
__device__ __forceinline__ void merge(int& b, int& i, int& s, int b2, int i2, int s2) {
  if (b2 < b || (b2 == b && i2 < i)) {
    s = min(b, s2);
    b = b2;
    i = i2;
  } else {
    s = min(s, b2);
  }
}

__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: 128 queries against the train rows [lo, hi) of split blockIdx.y.
// part holds three (splits, n1) int planes: best, idx, second.
__global__ void __launch_bounds__(kThreads)
    knn2_split_kernel(const uint32_t* __restrict__ d1, int n1,
                      const uint32_t* __restrict__ d2, int n2,
                      const uint8_t* __restrict__ valid2, int rows_per_split,
                      int* __restrict__ part) {
  __shared__ uint32_t tw[kChunk * kStride];
  __shared__ int tpop[kChunk];
  __shared__ uint8_t tval[kChunk];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;         // MMA group and thread in group
  const int q0 = blockIdx.x * kBlockQ + warp * 16 * kQTiles;
  const int splits = gridDim.y;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n2, lo + rows_per_split);

  // A fragments of the two query rows g and g + 8 of each tile (the PTX
  // fragment layout: a0 / a2 row g, a1 / a3 row g + 8; a0 / a1 the lower half
  // of K, a2 / a3 the upper), and their popcounts
  uint32_t a[kQTiles][4];
  int pa[kQTiles][2];
#pragma unroll
  for (int qt = 0; qt < kQTiles; ++qt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * qt + g + 8 * h;
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = row < n1 ? d1[(size_t)row * 8 + k] : 0u;
      int pc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) pc += __popc(w[k]);
      pa[qt][h] = pc;
      a[qt][h] = w[t];                           // bits 32t .. 32t + 31
      a[qt][2 + h] = w[t + 4];                   // bits 128 + 32t ..
    }
  }

  int best[kQTiles][2], idx[kQTiles][2], second[kQTiles][2];
#pragma unroll
  for (int qt = 0; qt < kQTiles; ++qt)
#pragma unroll
    for (int h = 0; h < 2; ++h) best[qt][h] = idx[qt][h] = second[qt][h] = INT_MAX;

  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int nc = min(kChunk, hi - c0);
    __syncthreads();                             // the previous chunk is consumed
    for (int e = tid; e < kChunk * 8; e += kThreads) {
      const int r = e >> 3, k = e & 7;
      tw[r * kStride + k] = r < nc ? d2[(size_t)(c0 + r) * 8 + k] : 0u;
    }
    for (int r = tid; r < kChunk; r += kThreads) {
      int pc = 0;
      if (r < nc) {
#pragma unroll
        for (int k = 0; k < 8; ++k) pc += __popc(d2[(size_t)(c0 + r) * 8 + k]);
      }
      tpop[r] = pc;
      tval[r] = r < nc ? valid2[c0 + r] : 0;
    }
    __syncthreads();

    for (int n0 = 0; n0 < nc; n0 += 8) {
      // B fragment of train row n0 + g (b0 the lower half of K, b1 the upper)
      const uint32_t* br = tw + (n0 + g) * kStride;
      const uint32_t b0 = br[t], b1 = br[t + 4];
      // this thread's accumulator columns: train rows n0 + 2t and n0 + 2t + 1
      int pb[2], col_ok[2], col_val[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 2 * t + h;
        col_ok[h] = col < nc;
        pb[h] = tpop[col];
        col_val[h] = tval[col];
      }
#pragma unroll
      for (int qt = 0; qt < kQTiles; ++qt) {
        int c[4] = {0, 0, 0, 0};
        mma_b1(c, a[qt], b0, b1);
        // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int d = !col_ok[h] ? INT_MAX
                          : col_val[h] ? pa[qt][hr] + pb[h] - 2 * c[2 * hr + h]
                                       : kInvalid;
            if (d < best[qt][hr]) {              // train index increases: strict '<'
              second[qt][hr] = best[qt][hr];
              best[qt][hr] = d;
              idx[qt][hr] = c0 + n0 + 2 * t + h;
            } else if (d < second[qt][hr]) {
              second[qt][hr] = d;
            }
          }
        }
      }
    }
  }

  // the four lanes of a query row merge; lane t == 0 writes the partial
#pragma unroll
  for (int qt = 0; qt < kQTiles; ++qt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      int b = best[qt][hr], i = idx[qt][hr], s = second[qt][hr];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const int b2 = __shfl_xor_sync(0xffffffffu, b, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
        const int s2 = __shfl_xor_sync(0xffffffffu, s, o);
        merge(b, i, s, b2, i2, s2);
      }
      const int row = q0 + 16 * qt + g + 8 * hr;
      if (t == 0 && row < n1) {
        const size_t at = (size_t)blockIdx.y * n1 + row;
        part[at] = b;
        part[(size_t)splits * n1 + at] = i;
        part[(size_t)2 * splits * n1 + at] = s;
      }
    }
  }
}

// One thread per query: the splits' partials merged in split order.
__global__ void knn2_merge_kernel(const int* __restrict__ part, int n1, int splits,
                                  float* __restrict__ best_out, int* __restrict__ idx_out,
                                  float* __restrict__ second_out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n1) return;
  int b = INT_MAX, i = INT_MAX, s = INT_MAX;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t at = (size_t)sp * n1 + q;
    merge(b, i, s, part[at], part[(size_t)splits * n1 + at], part[(size_t)2 * splits * n1 + at]);
  }
  best_out[q] = b == INT_MAX ? INFINITY : (float)b;
  idx_out[q] = i;
  second_out[q] = s == INT_MAX ? INFINITY : (float)s;
}

}  // namespace

// splits x rows_per_split must cover n2 with no empty split; part holds
// 3 * splits * n1 ints.  query_tile is the wrapper's idea of kBlockQ, on which
// its split count rests: a mismatch is refused.
extern "C" int hamming_knn2(const void* d1, int n1, const void* d2, int n2,
                            const void* valid2, int splits, int rows_per_split,
                            void* part, int query_tile, void* best, void* idx,
                            void* second, void* stream) {
  if (n1 < 0 || n2 < 1 || splits < 1 || rows_per_split < 1 || query_tile != kBlockQ ||
      (long long)splits * rows_per_split < n2 ||
      (long long)(splits - 1) * rows_per_split >= n2)
    return (int)cudaErrorInvalidValue;
  if (n1 == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n1 + kBlockQ - 1) / kBlockQ, splits);
  knn2_split_kernel<<<grid, kThreads, 0, st>>>(
      (const uint32_t*)d1, n1, (const uint32_t*)d2, n2, (const uint8_t*)valid2,
      rows_per_split, (int*)part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn2_merge_kernel<<<(n1 + 127) / 128, 128, 0, st>>>((const int*)part, n1, splits,
                                                       (float*)best, (int*)idx, (float*)second);
  return (int)cudaGetLastError();
}
