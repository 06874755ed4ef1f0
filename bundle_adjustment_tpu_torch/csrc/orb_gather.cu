// ORB descriptor patch gather, for Hopper (sm_90a).
//
// Replaces: bundle_adjustment_tpu/ops/orb_pallas.py, _gather_kernel (driven
// by gather_patches40).  For each keypoint b it writes the 40x40 window of
// the blurred level image whose top-left corner is (start_y[b], start_x[b]),
// minus 128:
//
//     out[b, i, j] = (in_image ? img[start_y[b] + i, start_x[b] + j] : 0) - 128
//
// so a pixel past the image edge reads as 0 and comes out as -128, exactly
// the zero-padded dynamic_slice oracle in orb._extract_patches.  The value
// is exact in float32: nothing here rounds through bf16, unlike the TPU
// kernel's one-hot MXU selection (<= 0.25 rounding).
//
// What bounds it on this card: bytes.  It does no arithmetic beyond one
// subtract per output; each output element is 4 bytes written and (at most)
// 4 bytes read, the reads mostly from L2 because neighbouring keypoints'
// windows overlap.  Design: one block per keypoint, its 256 threads looping
// over the 1600 outputs in row-major order, so consecutive threads touch
// consecutive addresses in each image row and in the output.  The TPU's
// aligned DMA bands and one-hot selection matmuls are answers to Mosaic's
// (8, 128) tiling and are not carried over.  Fusing this gather with the
// descriptor matmul (orb._describe) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 40;

__global__ void gather40_kernel(const float* __restrict__ img, int H, int W,
                                const int* __restrict__ start_y,
                                const int* __restrict__ start_x,
                                float* __restrict__ out) {
  const int b = blockIdx.x;
  const int sy = start_y[b];
  const int sx = start_x[b];
  float* o = out + (size_t)b * kSide * kSide;
  for (int k = threadIdx.x; k < kSide * kSide; k += blockDim.x) {
    const int y = sy + k / kSide;
    const int x = sx + k % kSide;
    const bool inside = (y >= 0) && (y < H) && (x >= 0) && (x < W);
    o[k] = (inside ? img[(size_t)y * W + x] : 0.0f) - 128.0f;
  }
}

}  // namespace

extern "C" int orb_gather40(const void* img, int H, int W, const void* start_y,
                            const void* start_x, int B, void* out,
                            void* stream) {
  if (B > 0) {
    gather40_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)img, H, W, (const int*)start_y, (const int*)start_x,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
