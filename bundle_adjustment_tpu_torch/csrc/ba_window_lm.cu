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
//   2. per point, in one pass: residuals and Jacobians of its live slots,
//      each computed once, Huber weights, V (3x3) and g_p, the 6x3 coupling
//      block of each adjustable camera to global scratch, V damped and
//      inverted by the adjugate (|det| < 1e-12 -> 1e-12, point mask folded
//      into 1/det, an inverse that is not finite -> 0); the same pass adds
//      each slot's U (6x6) and -g_c, and each camera's B z_p, into per-thread
//      accumulators in shared memory;
//   3. S = blockdiag(U) - sum_p B_c V^-1 B_c'^T: per camera pair, each thread
//      over its own points (the blocks it wrote in step 2), a warp butterfly;
//   4. Gauss-Jordan without pivoting on [S | b] (n = 6C' <= 48), pivots below
//      1e-20 clamped, by one warp with the rows in registers;
//   5. point back-substitution, trial cost, accept / reject, ftol / xtol,
//      stuck at lambda_max.
//
// The launch is one thread-block cluster of kCluster = 16 CTAs (a
// non-portable size; 8, the portable one, was measured slower on an H100:
// 0.0725 against 0.0407 ms per LM iteration at C = 5, n_fixed = 2, P = 8192)
// of 256 threads (128 at C' = 8, where 256 threads' accumulators would not fit
// in shared memory), the LM loop inside.  CTA r owns one contiguous range of points; the scratch stays point-fastest, so its reads are coalesced, and
// a thread reads back only what it wrote itself.  Every sum over points is
// first reduced inside the CTA in a fixed order (per-thread partials, warp
// butterflies, warps or threads in order) into the CTA's own partial array
// in shared memory: all C' cameras' 27 lanes and all pairs' 36 lanes in one
// array (6 KB at C' = 8), the cost lanes in another phase.  One cluster
// barrier per phase; then every CTA reads all ranks' partials through
// distributed shared memory and adds them in rank order 0..15, so every CTA
// holds bit-identical U, b, S, costs and loop state, runs the Gauss-Jordan
// and the accept / reject itself and leaves the loop with the others: no
// broadcast, no atomics.  The partial arrays are double-buffered, so the next
// phase's barrier is the one that keeps a CTA from overwriting partials its
// neighbours may still be reading; a last cluster barrier keeps every CTA's
// shared memory alive until the others have read it.
//
// No float atomics, and the sums' order depends on the shape only: two
// launches on the same input give the same bits.
//
// Built with -DBA_WINDOW_PHASE_CLOCKS (a second library beside the shipped
// one, ops/ba_kernel.PHASES), thread 0 of CTA 0 writes clock64() at each
// phase boundary of each LM iteration, and %globaltimer at the first and the
// last stamp, to a device array that ba_window_lm_phase_clocks copies out:
// the launch's time by phase, which no profiler splits.  The stamps are
// stores of thread 0 alone; the arithmetic and its order are the shipped
// build's, so the two give the same bits.
//
// Not carried over from the TPU kernel: the one-hot matrix and its MXU
// gathers, the (rows, P-lanes) transposes and the pad of P to 128, the dense
// (n, P) coupling stacks, the masked-iota assembly of S and of the stats.
// Cameras are indexed by cam_slot.  A slot whose camera index lies outside
// [0, C) is treated as dead (memory safety; the grid never holds one).
//
// What bounds it on this card: latency.  The bytes are small (the window is
// read once and the result written once, under 1 MB at P = 8192), the
// arithmetic about 27 MFLOP per iteration at P = 8192, D = 5, C' = 3, a few
// microseconds of the card's float32 rate; what is left is the chain of
// dependent phases per LM iteration (two cluster barriers, the CTA
// reductions, the 6C' pivots of one warp).  Where the one-block design of the
// port's first version ran on one SM, computed each slot's Jacobians once
// more per camera and crossed a block barrier per camera pair and two per
// pivot, this one spreads the points over 16 SMs, computes the Jacobians once
// and keeps the Gauss-Jordan inside one warp.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;  // threads per CTA: 256, or 128 where the
constexpr int kMaxWarps = kMaxThreads / 32;   // accumulators need the room
constexpr int kMaxCams = 16;   // C, fixed cameras included
constexpr int kMaxAdj = 8;     // C' = C - n_fixed
constexpr int kMaxN = 6 * kMaxAdj;
constexpr int kCamLanes = 27;  // per adjustable camera: U's upper triangle (21), b (6)
constexpr int kPairLanes = 36; // per camera pair: one 6x6 block of sum B V^-1 B^T
constexpr int kMaxPairs = kMaxAdj * (kMaxAdj + 1) / 2;
constexpr int kMaxLanes = kMaxAdj * kCamLanes + kMaxPairs * kPairLanes;
constexpr int kCluster = 16;   // CTAs in the launch's one cluster

// the phase-clock build: stamps 0 (entry) and 1 (after the first cost pass),
// then kPhases per LM iteration for the first kStampIters iterations, then
// two (after the final cost pass; at exit)
constexpr int kPhases = 10;
constexpr int kStampIters = 64;
constexpr int kStamps = 2 + kPhases * kStampIters + 2;
#ifdef BA_WINDOW_PHASE_CLOCKS
__device__ long long g_phase_clock[kStamps];
__device__ unsigned long long g_phase_timer[2];
__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_STAMP(slot)                                        \
  do {                                                           \
    if (rank == 0 && tid == 0 && (slot) < kStamps)               \
      g_phase_clock[(slot)] = clock64();                         \
  } while (0)
#define ITER_STAMP(phase) \
  PHASE_STAMP(it < kStampIters ? 2 + kPhases * it + (phase) : kStamps)
#else
#define PHASE_STAMP(slot) \
  do {                    \
  } while (0)
#define ITER_STAMP(phase) \
  do {                    \
  } while (0)
#endif

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

// Shared memory of one CTA; behind it (dynamic) the per-thread camera
// accumulators acc[27 C'][threads + 1] (one column per thread; the odd row
// stride keeps a row's reads free of bank conflicts), which the warps' pair
// sums wpart[warps][36 * pairs] reuse once the accumulators are reduced.
struct __align__(16) Shared {
  float rv[kMaxCams][3], tv[kMaxCams][3];      // current cameras
  float R[kMaxCams][9], dR[kMaxCams][27];      // dR[k*9 + i*3 + j] = dR_ij/dr_k
  float rv2[kMaxCams][3], tv2[kMaxCams][3];    // trial cameras
  float R2[kMaxCams][9];
  float S[kMaxN][kMaxN + 1];                   // column n is the right-hand side
  float x[kMaxN];                              // the camera step
  float part[2][kMaxLanes];                    // this CTA's partials, double-buffered
  float tot[kMaxLanes];                        // the cluster's sums
  float wsum[kMaxWarps][4];                       // warps' partials of the small sums
};

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

// sh.part[buf][e] summed over the cluster's CTAs in rank order; the loads
// are all in flight before the first add
__device__ __forceinline__ float rank_sum(Shared& sh, int buf, int e,
                                          cg::cluster_group& cluster) {
  float v[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) v[r] = cluster.map_shared_rank(&sh.part[buf][0], r)[e];
  float x = v[0];
#pragma unroll
  for (int r = 1; r < kCluster; ++r) x += v[r];
  return x;
}

// Sum v[0..N) (N <= 4) over the CTA into sh.part[buf], then over the
// cluster: every thread of every CTA gets the same sums in out.
template <int kThreads, int N>
__device__ void cluster_sum_small(const float (&v)[N], Shared& sh, int buf,
                                  cg::cluster_group& cluster, float (&out)[N]) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    w[i] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) sh.wsum[warp][i] = w[i];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += sh.wsum[k][threadIdx.x];
    sh.part[buf][threadIdx.x] = s;
  }
  cluster.sync();
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = rank_sum(sh, buf, i, cluster);
}

// Huber cost sum(rho) and squared cost sum(r^2) of the state (R, t, pts)
// over all live slots of the CTA's points [lo, hi), summed over the cluster.
template <int kThreads>
__device__ void cost_pass(const Args& a, const Intrinsics& k, const float (*R)[9],
                          const float (*t)[3], const float* pts, int lo, int hi,
                          Shared& sh, int buf, cg::cluster_group& cluster,
                          float (&out)[2]) {
  float acc[2] = {0.0f, 0.0f};
  for (int p = lo + threadIdx.x; p < hi; p += kThreads) {
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
  cluster_sum_small<kThreads>(acc, sh, buf, cluster, out);
}

// Gauss-Jordan without pivoting on [S | b] (n = N), by one warp: lane l holds
// rows l and l + 32 in registers.  The eliminated column is dropped and the
// rest shifted left, so every register index is a constant; after N steps
// column 0 holds the solution.  Same operations as _gauss_jordan
// (ops/ba_kernel.py): pivot clamped to 1e-20, prow = row_k * (1 / piv),
// row_i -= row_i[k] * prow.
template <int N>
__device__ void gauss_jordan_warp(Shared& sh) {
  constexpr int R = (N + 31) / 32;
  const int lane = threadIdx.x & 31;
  float r[R][N + 1];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
#pragma unroll
    for (int j = 0; j <= N; ++j) r[q][j] = i < N ? sh.S[i][j] : 0.0f;
  }
  for (int k = 0; k < N; ++k) {
    const int owner = k & 31;
    const bool upper = R > 1 && k >= 32;
    float piv = __shfl_sync(0xffffffffu, upper ? r[R - 1][0] : r[0][0], owner);
    if (fabsf(piv) < 1e-20f) piv = 1e-20f;
    const float inv_piv = 1.0f / piv;
    float f[R];
    bool is_k[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      f[q] = r[q][0];
      is_k[q] = lane + 32 * q == k;
    }
#pragma unroll
    for (int j = 1; j <= N; ++j) {
      const float pj =
          __shfl_sync(0xffffffffu, upper ? r[R - 1][j] : r[0][j], owner) * inv_piv;
#pragma unroll
      for (int q = 0; q < R; ++q) r[q][j - 1] = is_k[q] ? pj : r[q][j] - f[q] * pj;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) r[q][N] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    if (i < N) sh.x[i] = r[q][0];
  }
}

__device__ void gauss_jordan(Shared& sh, int n) {
  switch (n) {
    case 6: gauss_jordan_warp<6>(sh); break;
    case 12: gauss_jordan_warp<12>(sh); break;
    case 18: gauss_jordan_warp<18>(sh); break;
    case 24: gauss_jordan_warp<24>(sh); break;
    case 30: gauss_jordan_warp<30>(sh); break;
    case 36: gauss_jordan_warp<36>(sh); break;
    case 42: gauss_jordan_warp<42>(sh); break;
    default: gauss_jordan_warp<48>(sh); break;
  }
}

// index of the pair (c1, c2), c1 <= c2, in the order c1 outer, c2 inner
__device__ __forceinline__ int pair_index(int c1, int c2, int c_adj) {
  return c1 * c_adj - c1 * (c1 - 1) / 2 + (c2 - c1);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1) ba_window_lm_kernel(Args a) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kAcc = kThreads + 1;          // row stride of the accumulators
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = a.C, P = a.P, D = a.D;
  const int c_adj = C - a.n_fixed;
  const int n = 6 * c_adj;
  const int pairs = c_adj * (c_adj + 1) / 2;
  const int cam_lanes = kCamLanes * c_adj;
  const int pair_lanes = kPairLanes * pairs;
  const int lanes = cam_lanes + pair_lanes;
  const Intrinsics k = {a.K[0], a.K[4], a.K[2], a.K[5]};
  float* acc = reinterpret_cast<float*>(smem + sizeof(Shared));   // [cam_lanes][kAcc]
  float* wpart = acc;                                             // [kWarps][pair_lanes]

  // this CTA's points
  const int chunk = (P + kCluster - 1) / kCluster;
  const int lo = min(P, rank * chunk), hi = min(P, lo + chunk);

  // global scratch, point index fastest: coupling blocks B[c'][i*3+l][p],
  // V^-1 (6 unique values), g_p, the spare point buffer, camera bit masks
  float* Bc = a.scratch;
  float* Vi = Bc + (size_t)18 * c_adj * P;
  float* Gp = Vi + (size_t)6 * P;
  float* pt_other = Gp + (size_t)3 * P;
  int* cbits = reinterpret_cast<int*>(pt_other + (size_t)3 * P);
  float* pt_cur = a.pts_out;
#ifdef BA_WINDOW_PHASE_CLOCKS
  if (rank == 0 && tid == 0) g_phase_timer[0] = global_timer();
#endif
  PHASE_STAMP(0);

  for (int i = 3 * lo + tid; i < 3 * hi; i += kThreads) pt_cur[i] = a.points[i];
  if (tid < C) {
    for (int j = 0; j < 3; ++j) {
      sh.rv[tid][j] = a.rvecs[3 * tid + j];
      sh.tv[tid][j] = a.tvecs[3 * tid + j];
    }
    rodrigues(sh.rv[tid], sh.R[tid], nullptr);
  }
  __syncthreads();

  int buf = 0;
  float c2[2];
  cost_pass<kThreads>(a, k, sh.R, sh.tv, pt_cur, lo, hi, sh, buf, cluster, c2);
  buf ^= 1;
  const float init_cost = 0.5f * c2[0];
  const float init_sq = c2[1];
  PHASE_STAMP(1);
  // the loop state: the same values in every thread of every CTA
  float lam = a.lambda_init, cost = init_cost;
  int it = 0, stop = 0;   // stop: ops/ba.STOP_TESTS' code of the test that ended it
  bool done = init_cost < 0.0f;

  while (!done && it < a.max_iterations) {
    // -- 1. rotations and their derivatives -------------------------------
    if (tid < C) rodrigues(sh.rv[tid], sh.R[tid], sh.dR[tid]);
    for (int e = 0; e < cam_lanes; ++e) acc[e * kAcc + tid] = 0.0f;
    __syncthreads();
    ITER_STAMP(0);

    // -- 2. per point: V, g_p, coupling blocks, V^-1, and the camera lanes --
    for (int p = lo + tid; p < hi; p += kThreads) {
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
        float* ac = acc + ca * kCamLanes * kAcc + tid;
        e = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j)
            ac[(e++) * kAcc] +=
                s.w[0] * s.jc[0][i] * s.jc[0][j] + s.w[1] * s.jc[1][i] * s.jc[1][j];
          ac[(21 + i) * kAcc] -= s.w[0] * s.jc[0][i] * s.r[0] + s.w[1] * s.jc[1][i] * s.r[1];
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
      for (int e = 0; e < 6; ++e) {
        iv[e] = ok ? iv[e] : 0.0f;
        Vi[(size_t)e * P + p] = iv[e];
      }
#pragma unroll
      for (int l = 0; l < 3; ++l) Gp[(size_t)l * P + p] = gp[l];
      cbits[p] = bits;
      // b_c += B_c z_p for every adjustable camera that sees the point
      const float zp[3] = {iv[0] * gp[0] + iv[1] * gp[1] + iv[2] * gp[2],
                           iv[1] * gp[0] + iv[3] * gp[1] + iv[4] * gp[2],
                           iv[2] * gp[0] + iv[4] * gp[1] + iv[5] * gp[2]};
      for (int ca = 0; ca < c_adj; ++ca) {
        if (!((bits >> ca) & 1)) continue;
        const float* Bp = Bc + (size_t)18 * ca * P + p;
        float* ac = acc + (ca * kCamLanes + 21) * kAcc + tid;
#pragma unroll
        for (int i = 0; i < 6; ++i)
          ac[i * kAcc] += Bp[(size_t)(i * 3) * P] * zp[0] + Bp[(size_t)(i * 3 + 1) * P] * zp[1] +
                              Bp[(size_t)(i * 3 + 2) * P] * zp[2];
      }
    }

    __syncthreads();
    ITER_STAMP(1);
    // the CTA's camera lanes: each thread sums one row over the threads, in
    // four interleaved partials
    for (int e = tid; e < cam_lanes; e += kThreads) {
      const float* row = acc + e * kAcc;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int t = 0; t < kThreads; t += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] += row[t + u];
      }
      sh.part[buf][e] = (x[0] + x[1]) + (x[2] + x[3]);
    }
    __syncthreads();   // the accumulators are read: wpart may reuse them
    ITER_STAMP(2);

    // -- 3. per camera pair: sum_p B_c1 V^-1 B_c2^T over this thread's points
    for (int c1 = 0, q = 0; c1 < c_adj; ++c1) {
      for (int c2 = c1; c2 < c_adj; ++c2, ++q) {
        const int need = (1 << c1) | (1 << c2);
        float pa[36];
#pragma unroll
        for (int e = 0; e < 36; ++e) pa[e] = 0.0f;
        for (int p = lo + tid; p < hi; p += kThreads) {
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
              pa[i * 6 + j] += t0 * b2[j * 3] + t1 * b2[j * 3 + 1] + t2 * b2[j * 3 + 2];
          }
        }
#pragma unroll
        for (int e = 0; e < 36; ++e) {
          float x = pa[e];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
          if (lane == 0) wpart[warp * pair_lanes + q * kPairLanes + e] = x;
        }
      }
    }
    __syncthreads();
    ITER_STAMP(3);

    // -- 4. the CTA's pair lanes, then the cluster's sums in rank order ----
    for (int e = tid; e < pair_lanes; e += kThreads) {
      float x = 0.0f;
      for (int w = 0; w < kWarps; ++w) x += wpart[w * pair_lanes + e];
      sh.part[buf][cam_lanes + e] = x;
    }
    cluster.sync();
    for (int e = tid; e < lanes; e += kThreads) sh.tot[e] = rank_sum(sh, buf, e, cluster);
    buf ^= 1;
    __syncthreads();
    ITER_STAMP(4);

    // -- 5. S = blockdiag(U) - sum B V^-1 B^T, damped; b; Gauss-Jordan -----
    for (int e = tid; e < n * n; e += kThreads) {
      const int i = e / n, j = e % n;
      const int c1 = i / 6, c2 = j / 6, ii = i % 6, jj = j % 6;
      float val = c1 <= c2
                      ? -sh.tot[cam_lanes + pair_index(c1, c2, c_adj) * kPairLanes + ii * 6 + jj]
                      : -sh.tot[cam_lanes + pair_index(c2, c1, c_adj) * kPairLanes + jj * 6 + ii];
      if (c1 == c2) {
        const int lo_ = ii < jj ? ii : jj, hi_ = ii < jj ? jj : ii;
        const float u = sh.tot[c1 * kCamLanes + lo_ * 6 - lo_ * (lo_ - 1) / 2 + (hi_ - lo_)];
        val += u;
        if (ii == jj) val += lam * fabsf(u) + lam * 1e-6f + 1e-8f;
      }
      sh.S[i][j] = val;
    }
    for (int i = tid; i < n; i += kThreads) sh.S[i][n] = sh.tot[(i / 6) * kCamLanes + 21 + i % 6];
    __syncthreads();
    ITER_STAMP(5);
    if (warp == 0) gauss_jordan(sh, n);
    __syncthreads();
    ITER_STAMP(6);

    // -- 6. trial cameras, back-substitution, trial cost -------------------
    if (tid < C) {
      for (int j = 0; j < 3; ++j) {
        const bool adj = tid >= a.n_fixed;
        const int row = (tid - a.n_fixed) * 6 + j;
        sh.rv2[tid][j] = sh.rv[tid][j] + (adj ? sh.x[row] : 0.0f);
        sh.tv2[tid][j] = sh.tv[tid][j] + (adj ? sh.x[row + 3] : 0.0f);
      }
      rodrigues(sh.rv2[tid], sh.R2[tid], nullptr);
    }
    __syncthreads();
    ITER_STAMP(7);

    float tc[3] = {0.0f, 0.0f, 0.0f};          // sum rho, |dp|^2, |points|^2
    for (int p = lo + tid; p < hi; p += kThreads) {
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
          const float dci = sh.x[ca * 6 + i];
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
        tc[1] += dp[l] * dp[l];
        tc[2] += X[l] * X[l];
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
          tc[0] += av <= a.delta ? r[q] * r[q] : 2.0f * a.delta * av - a.delta * a.delta;
        }
      }
    }
    float ts[3];
    cluster_sum_small<kThreads>(tc, sh, buf, cluster, ts);
    buf ^= 1;
    ITER_STAMP(8);

    // -- 7. accept / reject: every thread of every CTA decides alike -------
    const float new_cost = 0.5f * ts[0];
    float step2 = ts[1], param2 = ts[2];
    for (int i = 0; i < n; ++i) step2 += sh.x[i] * sh.x[i];
    for (int c = 0; c < C; ++c)
      for (int j = 0; j < 3; ++j)
        param2 += sh.rv[c][j] * sh.rv[c][j] + sh.tv[c][j] * sh.tv[c][j];
    const bool accept = new_cost < cost;
    const bool ftol_met = (cost - new_cost) <= a.ftol * fmaxf(cost, 1e-12f);
    const bool xtol_met = sqrtf(step2) <= a.xtol * (sqrtf(param2) + a.xtol);
    const bool converged = accept && (ftol_met || xtol_met);
    const float lam2 = accept ? fmaxf(lam * a.lambda_down, a.lambda_min)
                              : fminf(lam * a.lambda_up, a.lambda_max);
    const bool stuck = !accept && lam2 >= a.lambda_max;
    if (accept) cost = new_cost;
    lam = lam2;
    stop = converged ? (ftol_met ? 1 : 2) : (stuck ? 3 : 0);
    done = converged || stuck;
    // every thread has read sh.rv, sh.tv and sh.x before they are written
    __syncthreads();
    if (accept) {
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
    ITER_STAMP(9);
    it += 1;
  }

  if (tid < C) rodrigues(sh.rv[tid], sh.R[tid], nullptr);
  __syncthreads();
  cost_pass<kThreads>(a, k, sh.R, sh.tv, pt_cur, lo, hi, sh, buf, cluster, c2);
  const float final_sq = c2[1];
  PHASE_STAMP(kStamps - 2);

  if (pt_cur != a.pts_out)
    for (int i = 3 * lo + tid; i < 3 * hi; i += kThreads) a.pts_out[i] = pt_cur[i];
  if (rank == 0 && tid < C) {
    for (int j = 0; j < 3; ++j) {
      a.rv_out[3 * tid + j] = sh.rv[tid][j];
      a.tv_out[3 * tid + j] = sh.tv[tid][j];
    }
  }
  if (rank == 0 && tid == 0) {
    a.stats[0] = init_cost;
    a.stats[1] = cost;
    a.stats[2] = init_sq;
    a.stats[3] = final_sq;
    a.stats[4] = (float)it;
    a.stats[5] = cost < init_cost ? 1.0f : 0.0f;
    a.stats[6] = lam;
    a.stats[7] = (float)stop;
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
  PHASE_STAMP(kStamps - 1);
#ifdef BA_WINDOW_PHASE_CLOCKS
  if (rank == 0 && tid == 0) g_phase_timer[1] = global_timer();
#endif
}

size_t smem_bytes(int c_adj, int threads) {
  const size_t accs = (size_t)kCamLanes * c_adj * (threads + 1);
  const size_t pair_sums = (size_t)(threads / 32) * kPairLanes * (c_adj * (c_adj + 1) / 2);
  return sizeof(Shared) + sizeof(float) * (accs > pair_sums ? accs : pair_sums);
}

constexpr size_t kSmemLimit = 232448;   // what one CTA may use on sm_90

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
  // 256 threads per CTA where their accumulators fit (C' <= 7), else 128
  const int threads = smem_bytes(c_adj, 256) <= kSmemLimit ? 256 : 128;
  static bool attributes_set = false;
  if (!attributes_set) {
    cudaError_t err = cudaSuccess;
    void (*const fns[2])(Args) = {ba_window_lm_kernel<128>, ba_window_lm_kernel<256>};
    for (auto fn : fns) {
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemLimit);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return (int)err;
    attributes_set = true;
  }
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

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(c_adj, threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = threads == 256 ? cudaLaunchKernelEx(&cfg, ba_window_lm_kernel<256>, a)
                                         : cudaLaunchKernelEx(&cfg, ba_window_lm_kernel<128>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the CTAs of the launch's cluster, for the record of a run
extern "C" int ba_window_lm_cluster_size() { return kCluster; }

// the phase-clock build's layout: stamps, phases per LM iteration, iterations
// stamped (0 in the shipped build, which stamps nothing)
extern "C" int ba_window_lm_stamps() {
#ifdef BA_WINDOW_PHASE_CLOCKS
  return kStamps;
#else
  return 0;
#endif
}
extern "C" int ba_window_lm_phases() { return kPhases; }
extern "C" int ba_window_lm_stamp_iterations() { return kStampIters; }

#ifdef BA_WINDOW_PHASE_CLOCKS
// the last launch's stamps (kStamps clock64 values; a slot its iterations did
// not reach keeps an older launch's value) and
// its %globaltimer at entry and exit (ns), copied to host memory after the
// stream's work
extern "C" int ba_window_lm_phase_clocks(void* clocks, void* timer, void* stream) {
  cudaError_t err = cudaStreamSynchronize((cudaStream_t)stream);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(clocks, g_phase_clock, sizeof(long long) * kStamps);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(timer, g_phase_timer, sizeof(unsigned long long) * 2);
  return (int)err;
}
#endif
