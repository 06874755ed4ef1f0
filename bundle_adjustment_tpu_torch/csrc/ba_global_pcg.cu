// Global bundle adjustment by matrix-free PCG on the Schur complement: the
// four per-observation passes of one LM iteration, for Hopper (sm_90a).
//
// Replaces: bundle_adjustment_tpu/ops/ba_global_pallas.py, the kernels that
// ba_solve_global_pallas drives, one entry point per role here for all of a
// role's TPU dressings (in-kernel one-hot gather, pregather, split, chunk
// skip):
//
//   ba_global_setup    _setup_kernel_gather, _setup_math_kernel_skipg +
//                      _scatter54_kernel (body _setup_body)
//   ba_global_matvec   _matvec_kernel_gather, _matvec_kernel_pre_skip
//                      (body _coupling_body)
//   ba_global_backsub  _backsub_kernel_gather, _backsub_kernel_skipg
//   ba_global_cost     _cost_kernel_gather, _cost_kernel_skipg (_cost_body)
//
// The LM control, the PCG recurrences, Rodrigues and the (C', 6)-sized camera
// algebra stay outside, in ops/ba_global_kernel.py, as they stay outside the
// TPU kernels.
//
// Layouts, point index fastest so that neighbouring threads read neighbouring
// addresses: points (3, P), cam_slot (D, P) int32, mask (D, P), uv (2D, P),
// point mask (P,) float; per camera one contiguous row: `cam` (C, 39) =
// R (9, row-major), dR (27, [k*9 + i*3 + j] = dR_ij/dr_k), t (3); `camc`
// (C, 12) = R, t; x (C', 6) over the adjustable cameras.  `scal` (8,) =
// fx, fy, cx, cy, lambda, Huber delta, 0, 0 on the device, so that lambda
// needs no host round trip.  Outputs: Y (D*18, P) with row d*18 + i*3 + l,
// V^-1 (6, P) as 00 01 02 11 12 22, z_p (3, P), and per adjustable camera the
// 54 lanes U upper triangle (21) | g_c (6) | W V^-1 g_p (6) | W V^-1 W^T
// upper triangle (21).
//
// Gather and scatter.  The TPU kernels move camera rows with one-hot matmuls.
// Here a thread reads its slot's camera row by index, and the sums over the
// points of one camera are a segmented sum: the caller builds once per solve
// a camera-major list of the live (slot, point) pairs of adjustable cameras
// (`pairs`, entry d*P + p, with `offsets` per camera: a stable sort, since
// cam_slot and mask do not change during a solve), the per-point pass writes
// one row of values per pair, and camera_sum_kernel, one block per camera,
// adds that camera's rows in list order: per-thread partials over a fixed
// stride, a butterfly of warp shuffles, then the warps' partials in warp
// order.  No float atomics: two launches on the same input give the same
// bits.  The same kernel serves setup (54 columns) and matvec (6).
//
// A slot is dead when its mask is 0 or its camera index lies outside [0, C):
// it is skipped, adds exact zeros as the masked one-hot does, and whatever
// sits in its cam_slot is never used as an index.  Gauge-fixed cameras
// (index < n_fixed) project in setup and cost and enter V and g_p, but have
// zero camera Jacobians: their Y rows are zeros and they own no pair.
//
// The 3x3 adjugate and determinant round every product and difference on its
// own (__fmul_rn, __fsub_rn), as eager PyTorch does in the plain version;
// |det| < 1e-12 becomes 1e-12, the point mask is folded into 1/det, and an
// inverse that is not finite (a point on a camera centre) becomes 0.
//
// What bounds it on this card: bytes, and before them latency.  At C = 200,
// P = 32,768, D = 4 setup writes Y, V^-1 and z_p (10.6 MB) and moves its
// 54-lane rows once out and once back (28 MB each way, mostly in the 50 MB
// L2); matvec and backsub stream Y (9.4 MB); cost reads 3 MB.  That is a few
// microseconds of device-memory time per pass against roughly 1e8
// operations at most (setup), so each pass is a launch-and-latency-sized
// piece of work; the per-camera sum runs C' blocks, fewer than two per SM.
// The design keeps every pass one simple kernel and spends nothing on tiling.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPointThreads = 128;   // per-point passes
constexpr int kSumThreads = 128;     // per-camera segmented sum
constexpr int kCostThreads = 256;
constexpr int kCam = 39;             // R 9, dR 27, t 3
constexpr int kCamC = 12;            // R 9, t 3
constexpr int kRed = 54;

struct Intrinsics {
  float fx, fy, cx, cy;
};

// Sum v[0..N) over a block of THREADS threads in a fixed order.  Thread i < N
// returns the i-th sum; `part` is shared memory of (THREADS / 32) * N floats.
template <int N, int THREADS>
__device__ float block_sum(float (&v)[N], float* part) {
  constexpr int kWarps = THREADS / 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    v[i] = x;
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) part[(threadIdx.x >> 5) * N + i] = v[i];
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < N)
    for (int w = 0; w < kWarps; ++w) s += part[w * N + threadIdx.x];
  return s;
}

__device__ __forceinline__ bool slot_live(const int* slot, const float* mask, int C, int P,
                                          int d, int p, int& c, float& m) {
  m = mask[(size_t)d * P + p];
  c = slot[(size_t)d * P + p];
  return m != 0.0f && (unsigned)c < (unsigned)C;
}

// Camera-frame point, the safe 1/z and the masked residual of one slot.
__device__ __forceinline__ void slot_residual(const float* R, const float* t, const float* X,
                                              const float* uv, float m, const Intrinsics& k,
                                              float* Xc, float& inv_z, float* r) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    Xc[i] = R[3 * i] * X[0] + R[3 * i + 1] * X[1] + R[3 * i + 2] * X[2] + t[i];
  const float z = Xc[2];
  const float z_safe = fabsf(z) < 1e-9f ? 1e-9f : z;
  inv_z = 1.0f / z_safe;
  const float u = k.fx * Xc[0] * inv_z + k.cx;
  const float v = k.fy * Xc[1] * inv_z + k.cy;
  r[0] = (u - uv[0]) * m;
  r[1] = (v - uv[1]) * m;
}

struct SlotTerms {
  float r[2], w[2];     // residual, Huber weight times mask
  float jc[2][6];       // d r / d (rvec, tvec)
  float jp[2][3];       // d r / d point
};

// Residual, weights and Jacobians of one slot from its camera row (kCam).
__device__ __forceinline__ void slot_terms(const float* cam, const float* X, const float* uv,
                                           float m, float delta, const Intrinsics& k,
                                           SlotTerms& s) {
  const float* R = cam;
  const float* dR = cam + 9;
  const float* t = cam + 36;
  float Xc[3], inv_z;
  slot_residual(R, t, X, uv, m, k, Xc, inv_z, s.r);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float ak = fabsf(s.r[q]);
    s.w[q] = (ak <= delta ? 1.0f : delta / fmaxf(ak, 1e-12f)) * m;
  }
  const float duv[2][3] = {{k.fx * inv_z, 0.0f, -k.fx * Xc[0] * inv_z * inv_z},
                           {0.0f, k.fy * inv_z, -k.fy * Xc[1] * inv_z * inv_z}};
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      s.jp[q][j] = duv[q][0] * R[j] + duv[q][1] * R[3 + j] + duv[q][2] * R[6 + j];
  float dXdr[3][3];     // [i][kk] = sum_j dR_ij/dr_kk * X_j
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      const float* d = dR + kk * 9 + i * 3;
      dXdr[i][kk] = d[0] * X[0] + d[1] * X[1] + d[2] * X[2];
    }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int kk = 0; kk < 3; ++kk)
      s.jc[q][kk] = duv[q][0] * dXdr[0][kk] + duv[q][1] * dXdr[1][kk] +
                    duv[q][2] * dXdr[2][kk];
#pragma unroll
    for (int i = 0; i < 3; ++i) s.jc[q][3 + i] = duv[q][i];
  }
}

// y = V^-1 q with V^-1 packed as 00 01 02 11 12 22.
__device__ __forceinline__ void vinv_apply(const float* iv, const float* q, float* y) {
  y[0] = iv[0] * q[0] + iv[1] * q[1] + iv[2] * q[2];
  y[1] = iv[1] * q[0] + iv[3] * q[1] + iv[4] * q[2];
  y[2] = iv[2] * q[0] + iv[4] * q[1] + iv[5] * q[2];
}

// ---------------------------------------------------------------------------
// setup, the per-point pass: one thread per point, two loops over its slots.
// The first sums V and g_p; the second computes the slot's Jacobians again
// (holding D slots' Jacobians in registers would spill), then Y and the 54
// reduction lanes of each live slot of an adjustable camera.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPointThreads)
setup_points_kernel(const float* __restrict__ cam, const float* __restrict__ pt,
                    const int* __restrict__ slot, const float* __restrict__ mask,
                    const float* __restrict__ uv, const float* __restrict__ pmask,
                    const float* __restrict__ scal, int C, int P, int D, int n_fixed,
                    float* __restrict__ Y, float* __restrict__ Vinv, float* __restrict__ zp,
                    float* __restrict__ rows) {
  const int p = blockIdx.x * kPointThreads + threadIdx.x;
  if (p >= P) return;
  const Intrinsics k = {scal[0], scal[1], scal[2], scal[3]};
  const float lam = scal[4], delta = scal[5];
  const float X[3] = {pt[p], pt[(size_t)P + p], pt[(size_t)2 * P + p]};

  float V[6] = {0, 0, 0, 0, 0, 0};        // 00 01 02 11 12 22
  float gp[3] = {0, 0, 0};
  for (int d = 0; d < D; ++d) {
    int c;
    float m;
    if (!slot_live(slot, mask, C, P, d, p, c, m)) continue;
    const float uvd[2] = {uv[(size_t)(2 * d) * P + p], uv[(size_t)(2 * d + 1) * P + p]};
    SlotTerms s;
    slot_terms(cam + (size_t)c * kCam, X, uvd, m, delta, k, s);
    int e = 0;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
#pragma unroll
      for (int lp = l; lp < 3; ++lp)
        V[e++] += s.w[0] * s.jp[0][l] * s.jp[0][lp] + s.w[1] * s.jp[1][l] * s.jp[1][lp];
      gp[l] += s.w[0] * s.jp[0][l] * s.r[0] + s.w[1] * s.jp[1][l] * s.r[1];
    }
  }

  const float v00 = V[0] + lam * fabsf(V[0]) + lam * 1e-6f;
  const float v11 = V[3] + lam * fabsf(V[3]) + lam * 1e-6f;
  const float v22 = V[5] + lam * fabsf(V[5]) + lam * 1e-6f;
  const float v01 = V[1], v02 = V[2], v12 = V[4];
  const float A_ = __fsub_rn(__fmul_rn(v11, v22), __fmul_rn(v12, v12));
  const float B_ = __fsub_rn(__fmul_rn(v02, v12), __fmul_rn(v01, v22));
  const float C_ = __fsub_rn(__fmul_rn(v01, v12), __fmul_rn(v02, v11));
  const float E_ = __fsub_rn(__fmul_rn(v00, v22), __fmul_rn(v02, v02));
  const float F_ = __fsub_rn(__fmul_rn(v01, v02), __fmul_rn(v00, v12));
  const float I_ = __fsub_rn(__fmul_rn(v00, v11), __fmul_rn(v01, v01));
  float det = __fadd_rn(__fadd_rn(__fmul_rn(v00, A_), __fmul_rn(v01, B_)),
                        __fmul_rn(v02, C_));
  if (fabsf(det) < 1e-12f) det = 1e-12f;
  const float inv_det = pmask[p] / det;
  float iv[6] = {A_ * inv_det, B_ * inv_det, C_ * inv_det,
                 E_ * inv_det, F_ * inv_det, I_ * inv_det};
  bool ok = true;
#pragma unroll
  for (int e = 0; e < 6; ++e) ok = ok && isfinite(iv[e]);
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    iv[e] = ok ? iv[e] : 0.0f;
    Vinv[(size_t)e * P + p] = iv[e];
  }
  float z[3];
  vinv_apply(iv, gp, z);
#pragma unroll
  for (int l = 0; l < 3; ++l) zp[(size_t)l * P + p] = z[l];

  for (int d = 0; d < D; ++d) {
    int c;
    float m;
    float* Yd = Y + (size_t)(d * 18) * P + p;
    if (!slot_live(slot, mask, C, P, d, p, c, m) || c < n_fixed) {
#pragma unroll
      for (int e = 0; e < 18; ++e) Yd[(size_t)e * P] = 0.0f;
      continue;
    }
    const float uvd[2] = {uv[(size_t)(2 * d) * P + p], uv[(size_t)(2 * d + 1) * P + p]};
    SlotTerms s;
    slot_terms(cam + (size_t)c * kCam, X, uvd, m, delta, k, s);
    float Ys[6][3], YV[6][3];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        Ys[i][l] = s.w[0] * s.jc[0][i] * s.jp[0][l] + s.w[1] * s.jc[1][i] * s.jp[1][l];
        Yd[(size_t)(i * 3 + l) * P] = Ys[i][l];
      }
      vinv_apply(iv, Ys[i], YV[i]);      // V^-1 is symmetric: (Y V^-1)_i = V^-1 Y_i
    }
    float* Rd = rows + (size_t)(d * kRed) * P + p;
    int e = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j)
        Rd[(size_t)(e++) * P] = s.w[0] * s.jc[0][i] * s.jc[0][j] + s.w[1] * s.jc[1][i] * s.jc[1][j];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      Rd[(size_t)(e++) * P] = s.w[0] * s.jc[0][i] * s.r[0] + s.w[1] * s.jc[1][i] * s.r[1];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      Rd[(size_t)(e++) * P] = Ys[i][0] * z[0] + Ys[i][1] * z[1] + Ys[i][2] * z[2];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j)
        Rd[(size_t)(e++) * P] = YV[i][0] * Ys[j][0] + YV[i][1] * Ys[j][1] + YV[i][2] * Ys[j][2];
  }
}

// ---------------------------------------------------------------------------
// The per-camera segmented sum: block ca adds the N-lane rows of camera ca's
// pairs, rows (D*N, P) with the lanes of pair d*P + p at rows d*N .. d*N+N-1
// of column p, into out (C', N).
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(kSumThreads)
camera_sum_kernel(const float* __restrict__ rows, const int* __restrict__ pairs,
                  const int* __restrict__ offsets, int P, float* __restrict__ out) {
  __shared__ float part[(kSumThreads / 32) * N];
  const int ca = blockIdx.x;
  const int lo = offsets[ca], hi = offsets[ca + 1];
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  for (int e = lo + threadIdx.x; e < hi; e += kSumThreads) {
    const int pair = pairs[e];
    const int d = pair / P;
    const int p = pair - d * P;
    const float* src = rows + (size_t)(d * N) * P + p;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += src[(size_t)i * P];
  }
  const float s = block_sum<N, kSumThreads>(acc, part);
  if (threadIdx.x < N) out[(size_t)ca * N + threadIdx.x] = s;
}

// ---------------------------------------------------------------------------
// matvec and backsub share q = sum_d Y_d^T x_{cam(d)} and z = V^-1 q.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void coupling_z(const float* __restrict__ Y,
                                           const float* __restrict__ Vinv,
                                           const int* __restrict__ slot,
                                           const float* __restrict__ mask,
                                           const float* __restrict__ x, int C, int P, int D,
                                           int n_fixed, int p, float* z) {
  float q[3] = {0, 0, 0};
  for (int d = 0; d < D; ++d) {
    int c;
    float m;
    if (!slot_live(slot, mask, C, P, d, p, c, m) || c < n_fixed) continue;
    const float* xc = x + (size_t)(c - n_fixed) * 6;
    const float* Yd = Y + (size_t)(d * 18) * P + p;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float xi = xc[i];
#pragma unroll
      for (int l = 0; l < 3; ++l) q[l] += Yd[(size_t)(i * 3 + l) * P] * xi;
    }
  }
  float iv[6];
#pragma unroll
  for (int e = 0; e < 6; ++e) iv[e] = Vinv[(size_t)e * P + p];
  vinv_apply(iv, q, z);
}

__global__ void __launch_bounds__(kPointThreads)
matvec_points_kernel(const float* __restrict__ Y, const float* __restrict__ Vinv,
                     const int* __restrict__ slot, const float* __restrict__ mask,
                     const float* __restrict__ x, int C, int P, int D, int n_fixed,
                     float* __restrict__ w2) {
  const int p = blockIdx.x * kPointThreads + threadIdx.x;
  if (p >= P) return;
  float z[3];
  coupling_z(Y, Vinv, slot, mask, x, C, P, D, n_fixed, p, z);
  for (int d = 0; d < D; ++d) {
    int c;
    float m;
    if (!slot_live(slot, mask, C, P, d, p, c, m) || c < n_fixed) continue;
    const float* Yd = Y + (size_t)(d * 18) * P + p;
    float* Wd = w2 + (size_t)(d * 6) * P + p;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      Wd[(size_t)i * P] = Yd[(size_t)(i * 3) * P] * z[0] + Yd[(size_t)(i * 3 + 1) * P] * z[1] +
                          Yd[(size_t)(i * 3 + 2) * P] * z[2];
  }
}

__global__ void __launch_bounds__(kPointThreads)
backsub_points_kernel(const float* __restrict__ Y, const float* __restrict__ Vinv,
                      const float* __restrict__ zp, const int* __restrict__ slot,
                      const float* __restrict__ mask, const float* __restrict__ x, int C,
                      int P, int D, int n_fixed, float* __restrict__ dp) {
  const int p = blockIdx.x * kPointThreads + threadIdx.x;
  if (p >= P) return;
  float z[3];
  coupling_z(Y, Vinv, slot, mask, x, C, P, D, n_fixed, p, z);
#pragma unroll
  for (int l = 0; l < 3; ++l) dp[(size_t)l * P + p] = -(zp[(size_t)l * P + p] + z[l]);
}

// ---------------------------------------------------------------------------
// cost: per-block partial sums of rho and r^2 in a fixed order, then one
// block adds the blocks' partials in block order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kCostThreads)
cost_points_kernel(const float* __restrict__ camc, const float* __restrict__ pt,
                   const int* __restrict__ slot, const float* __restrict__ mask,
                   const float* __restrict__ uv, const float* __restrict__ scal, int C, int P,
                   int D, float* __restrict__ partial) {
  __shared__ float part[(kCostThreads / 32) * 2];
  const int p = blockIdx.x * kCostThreads + threadIdx.x;
  float acc[2] = {0.0f, 0.0f};
  if (p < P) {
    const Intrinsics k = {scal[0], scal[1], scal[2], scal[3]};
    const float delta = scal[5];
    const float X[3] = {pt[p], pt[(size_t)P + p], pt[(size_t)2 * P + p]};
    for (int d = 0; d < D; ++d) {
      int c;
      float m;
      if (!slot_live(slot, mask, C, P, d, p, c, m)) continue;
      const float* cr = camc + (size_t)c * kCamC;
      const float uvd[2] = {uv[(size_t)(2 * d) * P + p], uv[(size_t)(2 * d + 1) * P + p]};
      float Xc[3], inv_z, r[2];
      slot_residual(cr, cr + 9, X, uvd, m, k, Xc, inv_z, r);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float av = fabsf(r[q]);
        const float quad = r[q] * r[q];
        acc[0] += av <= delta ? quad : 2.0f * delta * av - delta * delta;
        acc[1] += quad;
      }
    }
  }
  const float s = block_sum<2, kCostThreads>(acc, part);
  if (threadIdx.x < 2) partial[(size_t)blockIdx.x * 2 + threadIdx.x] = s;
}

__global__ void __launch_bounds__(kCostThreads)
cost_final_kernel(const float* __restrict__ partial, int n_blocks, float* __restrict__ out) {
  __shared__ float part[(kCostThreads / 32) * 2];
  float acc[2] = {0.0f, 0.0f};
  for (int b = threadIdx.x; b < n_blocks; b += kCostThreads) {
    acc[0] += partial[(size_t)b * 2];
    acc[1] += partial[(size_t)b * 2 + 1];
  }
  const float s = block_sum<2, kCostThreads>(acc, part);
  if (threadIdx.x == 0) out[0] = 0.5f * s;
  if (threadIdx.x == 1) out[1] = s;
}

inline bool bad_shape(int C, int P, int D, int n_fixed) {
  // a pair index d*P + p is an int
  return C < 1 || P < 1 || D < 1 || n_fixed < 0 || n_fixed >= C ||
         (long long)D * P > 0x7fffffffLL;
}

inline int point_blocks(int P, int threads) { return (P + threads - 1) / threads; }

}  // namespace

// Per LM iteration: Y, V^-1, z_p and the (C', 54) camera reduction `red`.
// `rows` is scratch of D*54*P floats.
extern "C" int ba_global_setup(const void* cam, const void* pt, const void* slot,
                               const void* mask, const void* uv, const void* pmask,
                               const void* scal, const void* pairs, const void* offsets,
                               int C, int P, int D, int n_fixed, void* Y, void* Vinv,
                               void* zp, void* rows, void* red, void* stream) {
  if (bad_shape(C, P, D, n_fixed)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  setup_points_kernel<<<point_blocks(P, kPointThreads), kPointThreads, 0, st>>>(
      (const float*)cam, (const float*)pt, (const int*)slot, (const float*)mask,
      (const float*)uv, (const float*)pmask, (const float*)scal, C, P, D, n_fixed,
      (float*)Y, (float*)Vinv, (float*)zp, (float*)rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  camera_sum_kernel<kRed><<<C - n_fixed, kSumThreads, 0, st>>>(
      (const float*)rows, (const int*)pairs, (const int*)offsets, P, (float*)red);
  return (int)cudaGetLastError();
}

// Per CG iteration: out (C', 6) = W V^-1 W^T x.  `w2` is scratch of D*6*P
// floats.
extern "C" int ba_global_matvec(const void* Y, const void* Vinv, const void* slot,
                                const void* mask, const void* x, const void* pairs,
                                const void* offsets, int C, int P, int D, int n_fixed,
                                void* w2, void* out, void* stream) {
  if (bad_shape(C, P, D, n_fixed)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  matvec_points_kernel<<<point_blocks(P, kPointThreads), kPointThreads, 0, st>>>(
      (const float*)Y, (const float*)Vinv, (const int*)slot, (const float*)mask,
      (const float*)x, C, P, D, n_fixed, (float*)w2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  camera_sum_kernel<6><<<C - n_fixed, kSumThreads, 0, st>>>(
      (const float*)w2, (const int*)pairs, (const int*)offsets, P, (float*)out);
  return (int)cudaGetLastError();
}

// dp (3, P) = -(z_p + V^-1 W^T x).
extern "C" int ba_global_backsub(const void* Y, const void* Vinv, const void* zp,
                                 const void* slot, const void* mask, const void* x, int C,
                                 int P, int D, int n_fixed, void* dp, void* stream) {
  if (bad_shape(C, P, D, n_fixed)) return (int)cudaErrorInvalidValue;
  backsub_points_kernel<<<point_blocks(P, kPointThreads), kPointThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)Y, (const float*)Vinv, (const float*)zp, (const int*)slot,
      (const float*)mask, (const float*)x, C, P, D, n_fixed, (float*)dp);
  return (int)cudaGetLastError();
}

// out (2,) = 0.5 * sum rho(r), sum r^2.  `partial` is scratch of
// 2 * ceil(P / 256) floats.
extern "C" int ba_global_cost(const void* camc, const void* pt, const void* slot,
                              const void* mask, const void* uv, const void* scal, int C,
                              int P, int D, void* partial, void* out, void* stream) {
  if (bad_shape(C, P, D, 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = point_blocks(P, kCostThreads);
  cost_points_kernel<<<n_blocks, kCostThreads, 0, st>>>(
      (const float*)camc, (const float*)pt, (const int*)slot, (const float*)mask,
      (const float*)uv, (const float*)scal, C, P, D, (float*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cost_final_kernel<<<1, kCostThreads, 0, st>>>((const float*)partial, n_blocks, (float*)out);
  return (int)cudaGetLastError();
}
