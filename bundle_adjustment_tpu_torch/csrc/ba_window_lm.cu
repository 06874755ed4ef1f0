// Window bundle adjustment: the whole Schur-complement Levenberg-Marquardt
// solve of one BA window in one launch, for Hopper (sm_90a).
//
// Replaces: bundle_adjustment_tpu/ops/ba_pallas.py, _kernel -> _lm_solve_values
// (driven by ba_solve_grid_pallas).  Inputs are the observation grid of
// ops/ba_grid.py: C cameras (rvecs, tvecs; the first n_fixed are the gauge),
// P points, D observation slots per point (cam_slot, uv, mask), point_mask,
// K.  Per LM iteration, inside the kernel:
//
//   1. Rodrigues R and its analytic derivative per camera (small-angle
//      series below theta^2 = 1e-8), in shared memory;
//   2. per point: residuals and Jacobians of its live slots, Huber weights,
//      V (3x3) and g_p in registers, the 6x3 coupling block of each
//      adjustable camera to global scratch; V damped, inverted by the
//      adjugate (|det| < 1e-12 -> 1e-12, point mask folded into 1/det, an
//      inverse that is not finite -> 0);
//   3. per adjustable camera: U (6x6), g_c and B z_p summed over the points;
//   4. S = blockdiag(U) - sum_p B_c V^-1 B_c'^T, one pass per camera pair:
//      each point touches only the cameras that see it;
//   5. Gauss-Jordan without pivoting on [S | b] (n = 6C' <= 48) in shared
//      memory, pivots below 1e-20 clamped;
//   6. point back-substitution, trial cost, accept / reject, ftol / xtol,
//      stuck at lambda_max.
//
// The LM loop is inside the kernel: one launch, one thread block whose
// threads stride over the points, __syncthreads() between phases.  The loop
// state (lambda, cost, iteration, done, accept) is written by thread 0 to
// shared memory and read by every thread after a barrier, so all threads
// leave the loop together.
//
// No float atomics.  Every sum over points is: per-thread partials over a
// fixed stride, a butterfly of warp shuffles, then one thread per value
// adding the warps' partials in warp order.  Two launches on the same input
// give the same bits.
//
// Not carried over from the TPU kernel: the one-hot matrix and its MXU
// gathers, the (rows, P-lanes) transposes and the pad of P to 128, the dense
// (n, P) coupling stacks, the masked-iota assembly of S and of the stats.
// Cameras are indexed by cam_slot.  A slot whose camera index lies outside
// [0, C) is treated as dead (memory safety; the grid never holds one).
//
// What bounds it on this card: operations, and before them latency.  The
// bytes are small (the window is read once and the result written once,
// under 1 MB at P = 8192); the arithmetic per iteration is about 27 MFLOP at
// P = 8192, D = 5, C' = 3, most of it the Schur products of step 4.  One
// block runs on one of the card's 132 SMs, so the kernel sits two orders of
// magnitude above the card's bound by design; what it removes is the
// hundreds of small launches and the host round trip per LM iteration of the
// eager solver.  A cooperative multi-block grid is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCams = 16;   // C, fixed cameras included
constexpr int kMaxAdj = 8;     // C' = C - n_fixed
constexpr int kMaxN = 6 * kMaxAdj;
constexpr int kMaxRed = 36;    // widest block reduction (one 6x6 block)

struct Args {
  const float* rvecs;
  const float* tvecs;
  const float* points;
  const int* cam_slot;
  const float* uv;
  const float* mask;
  const unsigned char* point_mask;
  const float* K;
  int C, P, D, n_fixed, max_iterations;
  float delta, lambda_init, lambda_up, lambda_down, lambda_min, lambda_max;
  float ftol, xtol;
  float* rv_out;
  float* tv_out;
  float* pts_out;
  float* stats;
  float* scratch;
};

struct Shared {
  float rv[kMaxCams][3], tv[kMaxCams][3];      // current cameras
  float R[kMaxCams][9], dR[kMaxCams][27];      // dR[k*9 + i*3 + j] = dR_ij/dr_k
  float rv2[kMaxCams][3], tv2[kMaxCams][3];    // trial cameras
  float R2[kMaxCams][9];
  float U[kMaxAdj][36];
  float S[kMaxN][kMaxN + 1];                   // column n is the right-hand side
  float prow[kMaxN + 1], col[kMaxN];
  float warp_part[kWarps][kMaxRed];
  float red[kMaxRed];
  float lam, cost;
  int it, done, accept;
};

// Sum v[0..N) over the block in a fixed order; the sums land in sh.red.
template <int N>
__device__ void block_reduce(float (&v)[N], Shared& sh) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    v[i] = x;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) sh.warp_part[warp][i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += sh.warp_part[w][threadIdx.x];
    sh.red[threadIdx.x] = s;
  }
  __syncthreads();
}

// R (and dR, unless null) of one rotation vector.
__device__ void rodrigues(const float* w, float* R, float* dR) {
  const float eps = 1e-8f;
  const float wx = w[0], wy = w[1], wz = w[2];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float t = sqrtf(t2 + eps * eps);
  const bool small = t2 < eps;
  const float st = sinf(t);
  const float ct = cosf(t);
  const float a = small ? 1.0f - t2 / 6.0f : st / t;
  const float b = small ? 0.5f - t2 / 24.0f : (1.0f - ct) / fmaxf(t2, eps * eps);
  const float W[9] = {0.0f, -wz, wy, wz, 0.0f, -wx, -wy, wx, 0.0f};
  const float W2[9] = {-(wy * wy + wz * wz), wx * wy, wx * wz,
                       wx * wy, -(wx * wx + wz * wz), wy * wz,
                       wx * wz, wy * wz, -(wx * wx + wy * wy)};
#pragma unroll
  for (int m = 0; m < 9; ++m)
    R[m] = ((m % 4 == 0) ? 1.0f : 0.0f) + a * W[m] + b * W2[m];
  if (dR == nullptr) return;
  const float ra = small ? -1.0f / 3.0f + t2 / 30.0f
                         : (t * ct - st) / fmaxf(t2 * t, eps * eps * eps);
  const float rb = small ? -1.0f / 12.0f + t2 / 180.0f
                         : (t * st - 2.0f * (1.0f - ct)) /
                               fmaxf(t2 * t2, eps * eps * eps * eps);
  // E_k = hat(e_k), M_k = E_k W + W E_k
  const float E[3][9] = {{0, 0, 0, 0, 0, -1, 0, 1, 0},
                         {0, 0, 1, 0, 0, 0, -1, 0, 0},
                         {0, -1, 0, 1, 0, 0, 0, 0, 0}};
  const float M[3][9] = {{0, wy, wz, wy, -2 * wx, 0, wz, 0, -2 * wx},
                         {-2 * wy, wx, 0, wx, 0, wz, 0, wz, -2 * wy},
                         {-2 * wz, 0, wx, 0, -2 * wz, wy, wx, wy, 0}};
  const float wk[3] = {wx, wy, wz};
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int m = 0; m < 9; ++m)
      dR[k * 9 + m] = ra * wk[k] * W[m] + a * E[k][m] + rb * wk[k] * W2[m] + b * M[k][m];
}

struct Intrinsics {
  float fx, fy, cx, cy;
};

// Camera-frame point, the safe 1/z and the masked residual of one slot.
__device__ __forceinline__ void slot_residual(const float* R, const float* t,
                                              const float* X, const float* uv,
                                              float m, const Intrinsics& k,
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

__device__ __forceinline__ void slot_terms(const float* R, const float* dR,
                                           const float* t, const float* X,
                                           const float* uv, float m, float delta,
                                           const Intrinsics& k, SlotTerms& s) {
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

__device__ __forceinline__ bool slot_live(const Args& a, int p, int d, int& c, float& m) {
  m = a.mask[p * a.D + d];
  c = a.cam_slot[p * a.D + d];
  return m != 0.0f && (unsigned)c < (unsigned)a.C;
}

// Huber cost 0.5 * sum(rho) and squared cost sum(r^2) of the state
// (R, t, pts) over all live slots: sh.red[0], sh.red[1].
__device__ void cost_pass(const Args& a, const Intrinsics& k, const float (*R)[9],
                          const float (*t)[3], const float* pts, Shared& sh) {
  float acc[2] = {0.0f, 0.0f};
  for (int p = threadIdx.x; p < a.P; p += kThreads) {
    const float X[3] = {pts[3 * p], pts[3 * p + 1], pts[3 * p + 2]};
    for (int d = 0; d < a.D; ++d) {
      int c;
      float m;
      if (!slot_live(a, p, d, c, m)) continue;
      float Xc[3], inv_z, r[2];
      slot_residual(R[c], t[c], X, a.uv + 2 * (p * a.D + d), m, k, Xc, inv_z, r);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float av = fabsf(r[q]);
        const float quad = r[q] * r[q];
        acc[0] += av <= a.delta ? quad : 2.0f * a.delta * av - a.delta * a.delta;
        acc[1] += quad;
      }
    }
  }
  block_reduce(acc, sh);
}

__global__ void __launch_bounds__(kThreads) ba_window_lm_kernel(Args a) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int C = a.C, P = a.P, D = a.D;
  const int c_adj = C - a.n_fixed;
  const int n = 6 * c_adj;
  const Intrinsics k = {a.K[0], a.K[4], a.K[2], a.K[5]};

  // global scratch, point index fastest: coupling blocks B[c'][i*3+l][p],
  // V^-1 (6 unique values), g_p, the spare point buffer, camera bit masks
  float* Bc = a.scratch;
  float* Vi = Bc + (size_t)18 * c_adj * P;
  float* Gp = Vi + (size_t)6 * P;
  float* pt_other = Gp + (size_t)3 * P;
  int* cbits = reinterpret_cast<int*>(pt_other + (size_t)3 * P);
  float* pt_cur = a.pts_out;

  for (int i = tid; i < 3 * P; i += kThreads) pt_cur[i] = a.points[i];
  if (tid < C) {
    for (int j = 0; j < 3; ++j) {
      sh.rv[tid][j] = a.rvecs[3 * tid + j];
      sh.tv[tid][j] = a.tvecs[3 * tid + j];
    }
    rodrigues(sh.rv[tid], sh.R[tid], nullptr);
  }
  __syncthreads();

  cost_pass(a, k, sh.R, sh.tv, pt_cur, sh);
  const float init_cost = 0.5f * sh.red[0];
  const float init_sq = sh.red[1];
  if (tid == 0) {
    sh.lam = a.lambda_init;
    sh.cost = init_cost;
    sh.it = 0;
    sh.done = init_cost < 0.0f;
    sh.accept = 0;
  }
  __syncthreads();

  while (!sh.done && sh.it < a.max_iterations) {
    const float lam = sh.lam;

    // -- 1. rotations and their derivatives -------------------------------
    if (tid < C) rodrigues(sh.rv[tid], sh.R[tid], sh.dR[tid]);
    __syncthreads();

    // -- 2. per point: V, g_p, coupling blocks, V^-1 -----------------------
    for (int p = tid; p < P; p += kThreads) {
      const float X[3] = {pt_cur[3 * p], pt_cur[3 * p + 1], pt_cur[3 * p + 2]};
      float V[6] = {0, 0, 0, 0, 0, 0};        // 00 01 02 11 12 22
      float gp[3] = {0, 0, 0};
      int bits = 0;
      for (int d = 0; d < D; ++d) {
        int c;
        float m;
        if (!slot_live(a, p, d, c, m)) continue;
        SlotTerms s;
        slot_terms(sh.R[c], sh.dR[c], sh.tv[c], X, a.uv + 2 * (p * D + d), m,
                   a.delta, k, s);
        int e = 0;
#pragma unroll
        for (int l = 0; l < 3; ++l) {
#pragma unroll
          for (int lp = l; lp < 3; ++lp)
            V[e++] += s.w[0] * s.jp[0][l] * s.jp[0][lp] + s.w[1] * s.jp[1][l] * s.jp[1][lp];
          gp[l] += s.w[0] * s.jp[0][l] * s.r[0] + s.w[1] * s.jp[1][l] * s.r[1];
        }
        const int ca = c - a.n_fixed;
        if (ca < 0) continue;
        float* Bp = Bc + (size_t)18 * ca * P + p;
        const bool seen = (bits >> ca) & 1;   // a second slot of the same camera adds
        bits |= 1 << ca;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            const float y = s.w[0] * s.jc[0][i] * s.jp[0][l] + s.w[1] * s.jc[1][i] * s.jp[1][l];
            float* dst = Bp + (size_t)(i * 3 + l) * P;
            *dst = seen ? *dst + y : y;
          }
      }
      const float v00 = V[0] + lam * fabsf(V[0]) + lam * 1e-6f;
      const float v11 = V[3] + lam * fabsf(V[3]) + lam * 1e-6f;
      const float v22 = V[5] + lam * fabsf(V[5]) + lam * 1e-6f;
      const float v01 = V[1], v02 = V[2], v12 = V[4];
      // products and differences rounded one by one (no FMA contraction),
      // as the plain version rounds them: the determinant cancels heavily
      const float A_ = __fsub_rn(__fmul_rn(v11, v22), __fmul_rn(v12, v12));
      const float B_ = __fsub_rn(__fmul_rn(v02, v12), __fmul_rn(v01, v22));
      const float C_ = __fsub_rn(__fmul_rn(v01, v12), __fmul_rn(v02, v11));
      const float E_ = __fsub_rn(__fmul_rn(v00, v22), __fmul_rn(v02, v02));
      const float F_ = __fsub_rn(__fmul_rn(v01, v02), __fmul_rn(v00, v12));
      const float I_ = __fsub_rn(__fmul_rn(v00, v11), __fmul_rn(v01, v01));
      float det = __fadd_rn(__fadd_rn(__fmul_rn(v00, A_), __fmul_rn(v01, B_)),
                            __fmul_rn(v02, C_));
      if (fabsf(det) < 1e-12f) det = 1e-12f;
      const float inv_det = (a.point_mask[p] ? 1.0f : 0.0f) / det;
      float iv[6] = {A_ * inv_det, B_ * inv_det, C_ * inv_det,
                     E_ * inv_det, F_ * inv_det, I_ * inv_det};
      bool ok = true;
#pragma unroll
      for (int e = 0; e < 6; ++e) ok = ok && isfinite(iv[e]);
#pragma unroll
      for (int e = 0; e < 6; ++e) Vi[(size_t)e * P + p] = ok ? iv[e] : 0.0f;
#pragma unroll
      for (int l = 0; l < 3; ++l) Gp[(size_t)l * P + p] = gp[l];
      cbits[p] = bits;
    }
    __syncthreads();

    // -- 3. per adjustable camera: U, and b = -g_c + B z_p ------------------
    for (int ca = 0; ca < c_adj; ++ca) {
      const int c = ca + a.n_fixed;
      float acc[27];                          // U upper triangle (21), b (6)
#pragma unroll
      for (int e = 0; e < 27; ++e) acc[e] = 0.0f;
      for (int p = tid; p < P; p += kThreads) {
        if (!((cbits[p] >> ca) & 1)) continue;
        const float X[3] = {pt_cur[3 * p], pt_cur[3 * p + 1], pt_cur[3 * p + 2]};
        for (int d = 0; d < D; ++d) {
          int cd;
          float m;
          if (!slot_live(a, p, d, cd, m) || cd != c) continue;
          SlotTerms s;
          slot_terms(sh.R[c], sh.dR[c], sh.tv[c], X, a.uv + 2 * (p * D + d), m,
                     a.delta, k, s);
          int e = 0;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int j = i; j < 6; ++j)
              acc[e++] += s.w[0] * s.jc[0][i] * s.jc[0][j] + s.w[1] * s.jc[1][i] * s.jc[1][j];
            acc[21 + i] -= s.w[0] * s.jc[0][i] * s.r[0] + s.w[1] * s.jc[1][i] * s.r[1];
          }
        }
        float iv[6], gp[3];
#pragma unroll
        for (int e = 0; e < 6; ++e) iv[e] = Vi[(size_t)e * P + p];
#pragma unroll
        for (int l = 0; l < 3; ++l) gp[l] = Gp[(size_t)l * P + p];
        const float zp[3] = {iv[0] * gp[0] + iv[1] * gp[1] + iv[2] * gp[2],
                             iv[1] * gp[0] + iv[3] * gp[1] + iv[4] * gp[2],
                             iv[2] * gp[0] + iv[4] * gp[1] + iv[5] * gp[2]};
        const float* Bp = Bc + (size_t)18 * ca * P + p;
#pragma unroll
        for (int i = 0; i < 6; ++i)
          acc[21 + i] += Bp[(size_t)(i * 3) * P] * zp[0] + Bp[(size_t)(i * 3 + 1) * P] * zp[1] +
                         Bp[(size_t)(i * 3 + 2) * P] * zp[2];
      }
      block_reduce(acc, sh);
      if (tid < 36) {
        const int i = tid / 6, j = tid % 6;
        const int lo = i < j ? i : j, hi = i < j ? j : i;
        sh.U[ca][tid] = sh.red[lo * 6 - lo * (lo - 1) / 2 + (hi - lo)];
      } else if (tid < 42) {
        sh.S[ca * 6 + tid - 36][n] = sh.red[21 + tid - 36];
      }
      // sh.red is read above and next written after the next reduction's
      // first barrier; sh.U and sh.S are read after later barriers
    }

    // -- 4. S = blockdiag(U) - sum_p B_c1 V^-1 B_c2^T ----------------------
    for (int c1 = 0; c1 < c_adj; ++c1) {
      for (int c2 = c1; c2 < c_adj; ++c2) {
        const int need = (1 << c1) | (1 << c2);
        float acc[36];
#pragma unroll
        for (int e = 0; e < 36; ++e) acc[e] = 0.0f;
        for (int p = tid; p < P; p += kThreads) {
          if ((cbits[p] & need) != need) continue;
          float iv[6], b2[18];
#pragma unroll
          for (int e = 0; e < 6; ++e) iv[e] = Vi[(size_t)e * P + p];
          const float* B1 = Bc + (size_t)18 * c1 * P + p;
          const float* B2 = Bc + (size_t)18 * c2 * P + p;
#pragma unroll
          for (int e = 0; e < 18; ++e) b2[e] = B2[(size_t)e * P];
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const float x0 = B1[(size_t)(i * 3) * P], x1 = B1[(size_t)(i * 3 + 1) * P],
                        x2 = B1[(size_t)(i * 3 + 2) * P];
            const float t0 = x0 * iv[0] + x1 * iv[1] + x2 * iv[2];
            const float t1 = x0 * iv[1] + x1 * iv[3] + x2 * iv[4];
            const float t2 = x0 * iv[2] + x1 * iv[4] + x2 * iv[5];
#pragma unroll
            for (int j = 0; j < 6; ++j)
              acc[i * 6 + j] += t0 * b2[j * 3] + t1 * b2[j * 3 + 1] + t2 * b2[j * 3 + 2];
          }
        }
        block_reduce(acc, sh);
        if (tid < 36) {
          const int i = tid / 6, j = tid % 6;
          float val = -sh.red[tid];
          if (c1 == c2) {
            const float u = sh.U[c1][tid];
            val += u;
            if (i == j) val += lam * fabsf(u) + lam * 1e-6f + 1e-8f;
          }
          sh.S[c1 * 6 + i][c2 * 6 + j] = val;
          if (c1 != c2) sh.S[c2 * 6 + j][c1 * 6 + i] = val;
        }
      }
    }
    __syncthreads();

    // -- 5. Gauss-Jordan on [S | b], no pivoting ---------------------------
    for (int kk = 0; kk < n; ++kk) {
      float piv = sh.S[kk][kk];
      if (fabsf(piv) < 1e-20f) piv = 1e-20f;
      const float inv_piv = 1.0f / piv;
      if (tid <= n) sh.prow[tid] = sh.S[kk][tid] * inv_piv;
      if (tid < n) sh.col[tid] = tid == kk ? 0.0f : sh.S[tid][kk];
      __syncthreads();
      for (int e = tid; e < n * (n + 1); e += kThreads) {
        const int i = e / (n + 1), j = e % (n + 1);
        sh.S[i][j] = i == kk ? sh.prow[j] : sh.S[i][j] - sh.col[i] * sh.prow[j];
      }
      __syncthreads();
    }

    // -- 6. trial cameras, back-substitution, trial cost -------------------
    if (tid < C) {
      for (int j = 0; j < 3; ++j) {
        const bool adj = tid >= a.n_fixed;
        const int row = (tid - a.n_fixed) * 6 + j;
        sh.rv2[tid][j] = sh.rv[tid][j] + (adj ? sh.S[row][n] : 0.0f);
        sh.tv2[tid][j] = sh.tv[tid][j] + (adj ? sh.S[row + 3][n] : 0.0f);
      }
      rodrigues(sh.rv2[tid], sh.R2[tid], nullptr);
    }
    __syncthreads();

    float acc[3] = {0.0f, 0.0f, 0.0f};        // sum rho, |dp|^2, |points|^2
    for (int p = tid; p < P; p += kThreads) {
      const float X[3] = {pt_cur[3 * p], pt_cur[3 * p + 1], pt_cur[3 * p + 2]};
      float iv[6], rhs[3];
#pragma unroll
      for (int e = 0; e < 6; ++e) iv[e] = Vi[(size_t)e * P + p];
#pragma unroll
      for (int l = 0; l < 3; ++l) rhs[l] = -Gp[(size_t)l * P + p];
      const int bits = cbits[p];
      for (int ca = 0; ca < c_adj; ++ca) {
        if (!((bits >> ca) & 1)) continue;
        const float* Bp = Bc + (size_t)18 * ca * P + p;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float dci = sh.S[ca * 6 + i][n];
#pragma unroll
          for (int l = 0; l < 3; ++l) rhs[l] -= Bp[(size_t)(i * 3 + l) * P] * dci;
        }
      }
      const float dp[3] = {iv[0] * rhs[0] + iv[1] * rhs[1] + iv[2] * rhs[2],
                           iv[1] * rhs[0] + iv[3] * rhs[1] + iv[4] * rhs[2],
                           iv[2] * rhs[0] + iv[4] * rhs[1] + iv[5] * rhs[2]};
      float X2[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        X2[l] = X[l] + dp[l];
        pt_other[3 * p + l] = X2[l];
        acc[1] += dp[l] * dp[l];
        acc[2] += X[l] * X[l];
      }
      for (int d = 0; d < D; ++d) {
        int c;
        float m;
        if (!slot_live(a, p, d, c, m)) continue;
        float Xc[3], inv_z, r[2];
        slot_residual(sh.R2[c], sh.tv2[c], X2, a.uv + 2 * (p * D + d), m, k, Xc, inv_z, r);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float av = fabsf(r[q]);
          acc[0] += av <= a.delta ? r[q] * r[q] : 2.0f * a.delta * av - a.delta * a.delta;
        }
      }
    }
    block_reduce(acc, sh);

    if (tid == 0) {
      const float new_cost = 0.5f * sh.red[0];
      float step2 = sh.red[1], param2 = sh.red[2];
      for (int i = 0; i < n; ++i) step2 += sh.S[i][n] * sh.S[i][n];
      for (int c = 0; c < C; ++c)
        for (int j = 0; j < 3; ++j)
          param2 += sh.rv[c][j] * sh.rv[c][j] + sh.tv[c][j] * sh.tv[c][j];
      const float cost = sh.cost;
      const bool accept = new_cost < cost;
      const bool converged =
          accept && ((cost - new_cost) <= a.ftol * fmaxf(cost, 1e-12f) ||
                     sqrtf(step2) <= a.xtol * (sqrtf(param2) + a.xtol));
      const float lam2 = accept ? fmaxf(lam * a.lambda_down, a.lambda_min)
                                : fminf(lam * a.lambda_up, a.lambda_max);
      const bool stuck = !accept && lam2 >= a.lambda_max;
      if (accept) sh.cost = new_cost;
      sh.lam = lam2;
      sh.accept = accept;
      sh.it += 1;
      sh.done = converged || stuck;
    }
    __syncthreads();
    if (sh.accept) {
      float* t = pt_cur;
      pt_cur = pt_other;
      pt_other = t;
      if (tid < C) {
        for (int j = 0; j < 3; ++j) {
          sh.rv[tid][j] = sh.rv2[tid][j];
          sh.tv[tid][j] = sh.tv2[tid][j];
        }
      }
    }
    // every thread has read sh.accept, sh.done and sh.it before thread 0
    // writes them again: the next write lies behind the barriers below
    __syncthreads();
  }

  if (tid < C) rodrigues(sh.rv[tid], sh.R[tid], nullptr);
  __syncthreads();
  cost_pass(a, k, sh.R, sh.tv, pt_cur, sh);
  const float final_sq = sh.red[1];

  if (pt_cur != a.pts_out)
    for (int i = tid; i < 3 * P; i += kThreads) a.pts_out[i] = pt_cur[i];
  if (tid < C) {
    for (int j = 0; j < 3; ++j) {
      a.rv_out[3 * tid + j] = sh.rv[tid][j];
      a.tv_out[3 * tid + j] = sh.tv[tid][j];
    }
  }
  if (tid == 0) {
    a.stats[0] = init_cost;
    a.stats[1] = sh.cost;
    a.stats[2] = init_sq;
    a.stats[3] = final_sq;
    a.stats[4] = (float)sh.it;
    a.stats[5] = sh.cost < init_cost ? 1.0f : 0.0f;
    a.stats[6] = sh.lam;
    a.stats[7] = 0.0f;
  }
}

}  // namespace

extern "C" int ba_window_lm(const void* rvecs, const void* tvecs, const void* points,
                            const void* cam_slot, const void* uv, const void* mask,
                            const void* point_mask, const void* K, int C, int P, int D,
                            int n_fixed, int max_iterations, float huber_delta,
                            float lambda_init, float lambda_up, float lambda_down,
                            float lambda_min, float lambda_max, float ftol, float xtol,
                            void* rv_out, void* tv_out, void* pts_out, void* stats,
                            void* scratch, void* stream) {
  const int c_adj = C - n_fixed;
  if (C < 1 || C > kMaxCams || n_fixed < 0 || c_adj < 1 || c_adj > kMaxAdj || P < 1 ||
      D < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.rvecs = (const float*)rvecs;
  a.tvecs = (const float*)tvecs;
  a.points = (const float*)points;
  a.cam_slot = (const int*)cam_slot;
  a.uv = (const float*)uv;
  a.mask = (const float*)mask;
  a.point_mask = (const unsigned char*)point_mask;
  a.K = (const float*)K;
  a.C = C;
  a.P = P;
  a.D = D;
  a.n_fixed = n_fixed;
  a.max_iterations = max_iterations;
  a.delta = huber_delta;
  a.lambda_init = lambda_init;
  a.lambda_up = lambda_up;
  a.lambda_down = lambda_down;
  a.lambda_min = lambda_min;
  a.lambda_max = lambda_max;
  a.ftol = ftol;
  a.xtol = xtol;
  a.rv_out = (float*)rv_out;
  a.tv_out = (float*)tv_out;
  a.pts_out = (float*)pts_out;
  a.stats = (float*)stats;
  a.scratch = (float*)scratch;
  ba_window_lm_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
