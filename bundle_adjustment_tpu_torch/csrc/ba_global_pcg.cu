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
//   ba_global_cost     _cost_kernel_gather, _cost_kernel_skipg (_cost_body):
//                      one launch, a last-CTA ticket for the cross-CTA sum
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
// Per-camera sums over tiles of the pair list.  The TPU kernels move camera
// rows with one-hot matmuls.  Here the caller builds once per solve
// (ops/ba_global_kernel.camera_index) the camera-major list of the live
// (slot, point) pairs of adjustable cameras (`pairs`, entry d*P + p; a stable
// sort, since cam_slot and mask do not change during a solve) and a tile plan
// over it: segments of one camera each, in tiles of at most a fixed number of
// pairs.  A camera with more pairs than that is cut into near-equal
// segments, each a tile of its own; the others are whole segments, packed in
// camera order into tiles (`seg_start`, `seg_cam`; `tile_seg` lists each
// tile's segments, `cam_seg` each camera's).  One CTA of kTileThreads takes a
// tile.  For each of its segments in turn, thread i forms in registers the
// lanes of the segment's pairs i, i + kTileThreads, ... of the tile and adds
// them; the CTA sums the threads (lanes paired across bit 4 of the lane index
// first, then 3, 2, 1, 0 by warp shuffles, then the warps in warp order in
// shared memory).  A camera that lies in one segment is written at once.  For
// one that spans several, each segment's sum goes to `carry`, the CTA takes a
// ticket on the camera's counter, and the CTA that takes the last ticket adds
// the camera's partials in segment order and sets the counter back to 0.
// Which CTA does that depends on scheduling; the order of the sum does not.
// No float atomics: two launches on one input give the same bits.  Nothing is
// written per slot for the sums: no rows of lanes go out to memory and back.
//
// Each of setup and matvec is a per-point kernel and a per-tile kernel on the
// same stream, the second launched with programmatic stream serialization
// (Hopper's programmatic dependent launch): the first lets it launch at once
// (griddepcontrol.launch_dependents), the second waits (griddepcontrol.wait)
// before it reads anything, so its launch and CTA placement overlap the
// first's tail.
//
// Any number of slots D: the per-point passes loop over a point's slots at
// run time and nothing is sized by D; the per-tile passes see live pairs,
// not slots.  A pair index d*P + p is an int (bad_shape bounds D*P).
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
// P = 32,768, D = 4 setup writes Y, V^-1 and z_p (10.6 MB) and matvec,
// backsub and cost read 3 to 10 MB, a few microseconds of device-memory time
// per pass against roughly 1e8 operations at most (setup): each pass is a
// launch-and-latency-sized piece of work.  Setup's tile kernel forms each
// pair's 54 lanes again from the point's V^-1 and z_p (the slot's Jacobians
// are recomputed, not stored), so its scratch is the tiles' carries, a few
// hundred KB, where one row of 54 lanes per slot would be 28 MB out and back.
// Matvec's tile kernel reads Y again for the pairs (9.4 MB, from L2).  A
// camera of many pairs spreads over several CTAs, so no one camera's share
// decides the time of the pass.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPointThreads = 128;   // per-point passes
constexpr int kTileThreads = 256;    // per-tile pass
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kCostThreads = 256;
constexpr int kCostPairs = 2;        // (slot, point) pairs per thread of the cost
constexpr int kCam = 39;             // R 9, dR 27, t 3
constexpr int kCamC = 12;            // R 9, t 3
constexpr int kRed = 54;

struct Intrinsics {
  float fx, fy, cx, cy;
};

// The tile plan of one solve and its scratch (module comment).
struct Plan {
  const int* pairs;       // camera-major live pairs, entry d*P + p
  const int* seg_start;   // (n_seg + 1,): segment k is pairs[seg_start[k] .. seg_start[k+1])
  const int* seg_cam;     // (n_seg,): its adjustable camera
  const int* tile_seg;    // (n_tiles + 1,): tile t holds segments tile_seg[t] .. tile_seg[t+1]
  const int* cam_seg;     // (C' + 1,): camera a owns segments cam_seg[a] .. cam_seg[a+1]
  float* carry;           // (n_seg, N) the segments' sums of cameras that span several
  int* ticket;            // (C',) one counter per camera, 0 between launches
};

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

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

// One step of a butterfly reduce-scatter over a warp: the lanes that differ
// in bit `o` of the lane index swap halves of w[0..L), and each keeps the sum
// of the half it owns.
template <int L>
__device__ __forceinline__ void scatter_step(float* w, int o) {
  const bool upper = (threadIdx.x & o) != 0;
#pragma unroll
  for (int j = 0; j < L / 2; ++j) {
    const float send = upper ? w[j] : w[j + L / 2];
    const float keep = upper ? w[j + L / 2] : w[j];
    w[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// block_sum's tree for N <= 64 lanes over kTileThreads threads, with 62
// shuffles a thread instead of 5N: after the reduce-scatter, lane l holds the
// warp's sums of lanes 2l and 2l + 1 (padded to 64).  `part` holds
// kTileWarps * 64 floats.
template <int N>
__device__ float block_sum_scatter(const float (&v)[N], float* part) {
  static_assert(N <= 64, "at most 64 lanes");
  float w[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) w[i] = i < N ? v[i] : 0.0f;
  scatter_step<64>(w, 16);
  scatter_step<32>(w, 8);
  scatter_step<16>(w, 4);
  scatter_step<8>(w, 2);
  scatter_step<4>(w, 1);
  float* mine = part + (threadIdx.x >> 5) * 64 + 2 * (threadIdx.x & 31);
  mine[0] = w[0];
  mine[1] = w[1];
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < N)
    for (int wp = 0; wp < kTileWarps; ++wp) s += part[wp * 64 + threadIdx.x];
  return s;
}

// For each segment k of tile t in turn: each thread adds, through
// `lanes(pair, a, acc)`, the N lanes of its pairs of the segment (tile pairs
// threadIdx.x, threadIdx.x + kTileThreads, ...), the CTA sums the threads,
// and `done(k, a, s)` takes thread i's sum of lane i.  `part` is shared
// memory of kTileWarps * 64 floats.
template <int N, class Lanes, class Done>
__device__ void segment_sums(const Plan& pl, int t, float* part, Lanes lanes, Done done) {
  const int k0 = pl.tile_seg[t], k1 = pl.tile_seg[t + 1];
  int pos = pl.seg_start[k0] + threadIdx.x;
  for (int k = k0; k < k1; ++k) {
    const int hi = pl.seg_start[k + 1];
    const int a = pl.seg_cam[k];
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.0f;
    for (; pos < hi; pos += kTileThreads) lanes(pl.pairs[pos], a, acc);
    __syncthreads();                      // the last segment's shared memory is read
    float s;
    if constexpr (N > 8)
      s = block_sum_scatter<N>(acc, part);
    else
      s = block_sum<N, kTileThreads>(acc, part);
    done(k, a, s);
  }
}

// Segment k of camera a is summed: thread i < N holds lane i in v.  A camera
// in one segment is written to out (C', N) at once; otherwise the segment
// goes to carry, and the CTA that takes the camera's last ticket adds its
// segments in order.
template <int N>
__device__ void finish_segment(const Plan& pl, int k, int a, float v, float* __restrict__ out) {
  __shared__ int s_last;
  const int j0 = pl.cam_seg[a], j1 = pl.cam_seg[a + 1];
  if (j1 - j0 == 1) {
    if (threadIdx.x < N) out[(size_t)a * N + threadIdx.x] = v;
    return;
  }
  if (threadIdx.x < N) {
    pl.carry[(size_t)k * N + threadIdx.x] = v;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&pl.ticket[a], 1) == j1 - j0 - 1;
  __syncthreads();
  if (s_last) {                           // every other segment of camera a is in carry
    if (threadIdx.x < N) {
      __threadfence();
      float sum = 0.0f;
      for (int j = j0; j < j1; ++j) sum += __ldcg(&pl.carry[(size_t)j * N + threadIdx.x]);
      out[(size_t)a * N + threadIdx.x] = sum;
    }
    if (threadIdx.x == 0) pl.ticket[a] = 0;
  }
}

// Rows of out (C', N) of cameras with no live pair: zeros (no tile writes them).
__device__ __forceinline__ void zero_pairless(const int* __restrict__ cam_seg, int c_adj, int N,
                                              float* __restrict__ out) {
  for (int a = blockIdx.x * blockDim.x + threadIdx.x; a < c_adj; a += gridDim.x * blockDim.x)
    if (cam_seg[a] == cam_seg[a + 1])
      for (int i = 0; i < N; ++i) out[(size_t)a * N + i] = 0.0f;
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

// Y = the slot's coupling block w Jc^T Jp, (6, 3).
__device__ __forceinline__ void coupling_block(const SlotTerms& s, float (&Ys)[6][3]) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      Ys[i][l] = s.w[0] * s.jc[0][i] * s.jp[0][l] + s.w[1] * s.jc[1][i] * s.jp[1][l];
}

// y = V^-1 q with V^-1 packed as 00 01 02 11 12 22.
__device__ __forceinline__ void vinv_apply(const float* iv, const float* q, float* y) {
  y[0] = iv[0] * q[0] + iv[1] * q[1] + iv[2] * q[2];
  y[1] = iv[1] * q[0] + iv[3] * q[1] + iv[4] * q[2];
  y[2] = iv[2] * q[0] + iv[4] * q[1] + iv[5] * q[2];
}

// ---------------------------------------------------------------------------
// setup.  The per-point kernel: one thread per point, one loop over its
// slots (the slot's Jacobians once): V, g_p and Y; then V^-1 and z_p.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPointThreads)
setup_points_kernel(const float* __restrict__ cam, const float* __restrict__ pt,
                    const int* __restrict__ slot, const float* __restrict__ mask,
                    const float* __restrict__ uv, const float* __restrict__ pmask,
                    const float* __restrict__ scal, const int* __restrict__ cam_seg, int C,
                    int P, int D, int n_fixed, float* __restrict__ Y, float* __restrict__ Vinv,
                    float* __restrict__ zp, float* __restrict__ red) {
  pdl_launch_dependents();
  zero_pairless(cam_seg, C - n_fixed, kRed, red);
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
    float* Yd = Y + (size_t)(d * 18) * P + p;
    if (!slot_live(slot, mask, C, P, d, p, c, m)) {
#pragma unroll
      for (int e = 0; e < 18; ++e) Yd[(size_t)e * P] = 0.0f;
      continue;
    }
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
    float Ys[6][3];
    coupling_block(s, Ys);
    const bool adj = c >= n_fixed;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int l = 0; l < 3; ++l) Yd[(size_t)(i * 3 + l) * P] = adj ? Ys[i][l] : 0.0f;
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
}

// U (21) and g_c (6) of one pair from its slot's terms: lanes 0..26.
__device__ __forceinline__ void u_gc_lanes(const SlotTerms& s, float (&acc)[27]) {
  int e = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j)
      acc[e++] += s.w[0] * s.jc[0][i] * s.jc[0][j] + s.w[1] * s.jc[1][i] * s.jc[1][j];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    acc[e++] += s.w[0] * s.jc[0][i] * s.r[0] + s.w[1] * s.jc[1][i] * s.r[1];
}

// W V^-1 g_p (6) and the block-Jacobi W V^-1 W^T (21) of one pair from its
// Y block, V^-1 and z_p: lanes 27..53.
__device__ __forceinline__ void wz_do_lanes(const float (&Ys)[6][3], const float* iv,
                                            const float* z, float (&acc)[27]) {
  int e = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[e++] += Ys[i][0] * z[0] + Ys[i][1] * z[1] + Ys[i][2] * z[2];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float yv[3];
    vinv_apply(iv, Ys[i], yv);            // V^-1 is symmetric: (Y V^-1)_i = V^-1 Y_i
#pragma unroll
    for (int j = i; j < 6; ++j) acc[e++] += yv[0] * Ys[j][0] + yv[1] * Ys[j][1] + yv[2] * Ys[j][2];
  }
}

struct SetupArgs {
  const float* cam;
  const float* pt;
  const float* mask;
  const float* uv;
  const float* scal;
  int P, n_fixed;
  const float* Y;
  const float* Vinv;
  const float* zp;
  float* red;
};

__device__ __forceinline__ void pair_terms(const SetupArgs& g, int pair, int a, SlotTerms& s,
                                           int& d, int& p) {
  d = pair / g.P;
  p = pair - d * g.P;
  const int P = g.P;
  const Intrinsics k = {g.scal[0], g.scal[1], g.scal[2], g.scal[3]};
  const float X[3] = {g.pt[p], g.pt[(size_t)P + p], g.pt[(size_t)2 * P + p]};
  const float uvd[2] = {g.uv[(size_t)(2 * d) * P + p], g.uv[(size_t)(2 * d + 1) * P + p]};
  slot_terms(g.cam + (size_t)(a + g.n_fixed) * kCam, X, uvd, g.mask[pair], g.scal[5], k, s);
}

// The per-tile kernel: the 54 lanes of each pair from its slot's terms (the
// Jacobians again, which costs less than storing them), the point's V^-1 and
// z_p; reduced per camera over the tile.  Its registers are bounded for two
// CTAs per SM.
__global__ void __launch_bounds__(kTileThreads, 2)
setup_tiles_kernel(Plan pl, SetupArgs g) {
  __shared__ float part[kTileWarps * 64];
  pdl_wait();
  const int P = g.P;
  segment_sums<kRed>(pl, blockIdx.x, part,
      [&](int pair, int a, float (&acc)[kRed]) {
        SlotTerms s;
        int d, p;
        pair_terms(g, pair, a, s, d, p);
        float Ys[6][3];
        coupling_block(s, Ys);
        float iv[6], z[3];
#pragma unroll
        for (int e = 0; e < 6; ++e) iv[e] = __ldcg(g.Vinv + (size_t)e * P + p);
#pragma unroll
        for (int l = 0; l < 3; ++l) z[l] = __ldcg(g.zp + (size_t)l * P + p);
        float lo[27], hi[27];
#pragma unroll
        for (int i = 0; i < 27; ++i) lo[i] = hi[i] = 0.0f;
        u_gc_lanes(s, lo);
        wz_do_lanes(Ys, iv, z, hi);
#pragma unroll
        for (int i = 0; i < 27; ++i) {
          acc[i] += lo[i];
          acc[27 + i] += hi[i];
        }
      },
      [&](int k, int a, float v) { finish_segment<kRed>(pl, k, a, v, g.red); });
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

// The 6 lanes Y_d z_p of one pair added to acc.  z comes from the per-point
// kernel, which may still have been running when this CTA started: it is
// read from L2 (as everything the tile kernels read of the per-point
// kernel's output).
__device__ __forceinline__ void matvec_lanes(const float (&Yd)[18], const float* z, int P, int p,
                                             float (&acc)[6]) {
  const float z0 = __ldcg(z + p), z1 = __ldcg(z + (size_t)P + p),
              z2 = __ldcg(z + (size_t)2 * P + p);
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[i] += Yd[i * 3] * z0 + Yd[i * 3 + 1] * z1 + Yd[i * 3 + 2] * z2;
}

__device__ __forceinline__ void load_y(const float* __restrict__ Y, int P, int pair, float (&Yd)[18],
                                       int& p) {
  const int d = pair / P;
  p = pair - d * P;
  const float* src = Y + (size_t)(d * 18) * P + p;
#pragma unroll
  for (int e = 0; e < 18; ++e) Yd[e] = src[(size_t)e * P];
}

__global__ void __launch_bounds__(kPointThreads)
matvec_points_kernel(const float* __restrict__ Y, const float* __restrict__ Vinv,
                     const int* __restrict__ slot, const float* __restrict__ mask,
                     const float* __restrict__ x, const int* __restrict__ cam_seg, int C, int P,
                     int D, int n_fixed, float* __restrict__ z, float* __restrict__ out) {
  pdl_launch_dependents();
  zero_pairless(cam_seg, C - n_fixed, 6, out);
  const int p = blockIdx.x * kPointThreads + threadIdx.x;
  if (p >= P) return;
  float zz[3];
  coupling_z(Y, Vinv, slot, mask, x, C, P, D, n_fixed, p, zz);
#pragma unroll
  for (int l = 0; l < 3; ++l) z[(size_t)l * P + p] = zz[l];
}

__global__ void __launch_bounds__(kTileThreads)
matvec_tiles_kernel(Plan pl, const float* __restrict__ Y, const float* z, int P,
                    float* __restrict__ out) {
  __shared__ float part[kTileWarps * 64];
  pdl_wait();
  segment_sums<6>(pl, blockIdx.x, part,
      [&](int pair, int, float (&acc)[6]) {
        float yd[18];
        int p;
        load_y(Y, P, pair, yd, p);
        matvec_lanes(yd, z, P, p, acc);
      },
      [&](int k, int a, float v) { finish_segment<6>(pl, k, a, v, out); });
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
// cost: one launch.  Thread i of the grid takes the pairs i and i + (grid
// threads) of the (slot, point) list, entry d*P + p, so a warp reads a run of
// one slot row; it issues every load of its pairs (slot, mask, uv, point)
// before any arithmetic, then reads each live pair's camera row through the
// read-only path (a warp's pairs see a few cameras, whose rows stay in L1;
// staging the (C, 12) table in shared memory in every CTA measured 10 %
// slower on one H100 at C = 200).  Each CTA sums its threads' rho and r^2 in a fixed tree
// (block_sum), writes its two partials and takes a ticket; the CTA that takes
// the last ticket adds the partials in block order, writes out and sets the
// ticket back to 0.  No float atomics: two launches on one input give the
// same bits.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kCostThreads)
cost_kernel(const float* __restrict__ camc, const float* __restrict__ pt,
            const int* __restrict__ slot, const float* __restrict__ mask,
            const float* __restrict__ uv, const float* __restrict__ scal, int C, int P, int D,
            float* __restrict__ partial, int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float part[(kCostThreads / 32) * 2];
  __shared__ int s_last;
  const int n = D * P;
  const int stride = gridDim.x * kCostThreads;
  const int first = blockIdx.x * kCostThreads + threadIdx.x;
  int c[kCostPairs];
  float m[kCostPairs], uvd[kCostPairs][2] = {}, X[kCostPairs][3] = {};
#pragma unroll
  for (int k = 0; k < kCostPairs; ++k) {
    // 64-bit: first + stride may pass INT_MAX when D * P is near it
    const long long i = (long long)first + (long long)k * stride;
    m[k] = 0.0f;
    c[k] = 0;
    if (i < n) {
      const int d = (int)(i / P), p = (int)(i - (long long)d * P);
      m[k] = mask[i];
      c[k] = slot[i];
      uvd[k][0] = uv[i + (size_t)d * P];
      uvd[k][1] = uv[i + (size_t)(d + 1) * P];
      X[k][0] = pt[p];
      X[k][1] = pt[(size_t)P + p];
      X[k][2] = pt[(size_t)2 * P + p];
    }
  }
  const Intrinsics kk = {scal[0], scal[1], scal[2], scal[3]};
  const float delta = scal[5];
  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kCostPairs; ++k) {
    if (!(m[k] != 0.0f && (unsigned)c[k] < (unsigned)C)) continue;
    float cr[kCamC];
#pragma unroll
    for (int e = 0; e < kCamC; ++e) cr[e] = __ldg(camc + (size_t)c[k] * kCamC + e);
    float Xc[3], inv_z, r[2];
    slot_residual(cr, cr + 9, X[k], uvd[k], m[k], kk, Xc, inv_z, r);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float av = fabsf(r[q]);
      const float quad = r[q] * r[q];
      acc[0] += av <= delta ? quad : 2.0f * delta * av - delta * delta;
      acc[1] += quad;
    }
  }
  const float s = block_sum<2, kCostThreads>(acc, part);
  if (threadIdx.x < 2) {
    partial[(size_t)blockIdx.x * 2 + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();                        // every CTA's partials are in memory
  float tot[2] = {0.0f, 0.0f};
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kCostThreads) {
    tot[0] += __ldcg(partial + (size_t)b * 2);
    tot[1] += __ldcg(partial + (size_t)b * 2 + 1);
  }
  const float t = block_sum<2, kCostThreads>(tot, part);
  if (threadIdx.x == 0) {
    out[0] = 0.5f * t;
    *ticket = 0;
  }
  if (threadIdx.x == 1) out[1] = t;
}

inline bool bad_shape(int C, int P, int D, int n_fixed) {
  // a pair index d*P + p is an int
  return C < 1 || P < 1 || D < 1 || n_fixed < 0 || n_fixed >= C ||
         (long long)D * P > 0x7fffffffLL;
}

inline int point_blocks(int P, int threads) { return (P + threads - 1) / threads; }

// Launch `kernel` on `blocks` CTAs of `threads` after the kernel launched
// just before it on `st`, by programmatic dependent launch.
template <class... Params, class... Args>
cudaError_t launch_after(void (*kernel)(Params...), int blocks, int threads, cudaStream_t st,
                         Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

Plan make_plan(const void* pairs, const void* seg_start, const void* seg_cam,
               const void* tile_seg, const void* cam_seg, void* carry, void* ticket) {
  return Plan{(const int*)pairs, (const int*)seg_start, (const int*)seg_cam,
              (const int*)tile_seg, (const int*)cam_seg, (float*)carry, (int*)ticket};
}

}  // namespace

// Per LM iteration: Y, V^-1, z_p and the (C', 54) camera reduction `red`.
// The plan (pairs .. cam_seg, n_tiles) and its scratch (carry of n_seg * 54
// floats, ticket of C' zeros) come from camera_index.
extern "C" int ba_global_setup(const void* cam, const void* pt, const void* slot,
                               const void* mask, const void* uv, const void* pmask,
                               const void* scal, const void* pairs, const void* seg_start,
                               const void* seg_cam, const void* tile_seg, const void* cam_seg,
                               void* carry, void* ticket, int C, int P, int D, int n_fixed,
                               int n_tiles, void* Y, void* Vinv, void* zp,
                               void* red, void* stream) {
  if (bad_shape(C, P, D, n_fixed) || n_tiles < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  setup_points_kernel<<<point_blocks(P, kPointThreads), kPointThreads, 0, st>>>(
      (const float*)cam, (const float*)pt, (const int*)slot, (const float*)mask,
      (const float*)uv, (const float*)pmask, (const float*)scal, (const int*)cam_seg, C, P, D,
      n_fixed, (float*)Y, (float*)Vinv, (float*)zp, (float*)red);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return (int)err;
  const Plan pl = make_plan(pairs, seg_start, seg_cam, tile_seg, cam_seg, carry, ticket);
  const SetupArgs g = {(const float*)cam, (const float*)pt, (const float*)mask, (const float*)uv,
                       (const float*)scal, P, n_fixed, (const float*)Y, (const float*)Vinv,
                       (const float*)zp, (float*)red};
  err = launch_after(setup_tiles_kernel, n_tiles, kTileThreads, st, pl, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Per CG iteration: out (C', 6) = W V^-1 W^T x.  `z` is scratch of 3*P
// floats, `carry` of n_seg * 6, `ticket` C' zeros.
extern "C" int ba_global_matvec(const void* Y, const void* Vinv, const void* slot,
                                const void* mask, const void* x, const void* pairs,
                                const void* seg_start, const void* seg_cam,
                                const void* tile_seg, const void* cam_seg, void* carry,
                                void* ticket, int C, int P, int D, int n_fixed, int n_tiles,
                                void* z, void* out, void* stream) {
  if (bad_shape(C, P, D, n_fixed) || n_tiles < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  matvec_points_kernel<<<point_blocks(P, kPointThreads), kPointThreads, 0, st>>>(
      (const float*)Y, (const float*)Vinv, (const int*)slot, (const float*)mask,
      (const float*)x, (const int*)cam_seg, C, P, D, n_fixed, (float*)z, (float*)out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return (int)err;
  const Plan pl = make_plan(pairs, seg_start, seg_cam, tile_seg, cam_seg, carry, ticket);
  err = launch_after(matvec_tiles_kernel, n_tiles, kTileThreads, st, pl, (const float*)Y,
                     (const float*)z, P, (float*)out);
  if (err != cudaSuccess) return (int)err;
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

// out (2,) = 0.5 * sum rho(r), sum r^2, in one launch.  `partial` is scratch
// of 2 * n_partial floats, at least 2 per CTA (ba_global_cost_pairs_per_block
// pairs each); `ticket` one int, 0 between launches.
extern "C" int ba_global_cost(const void* camc, const void* pt, const void* slot,
                              const void* mask, const void* uv, const void* scal, int C,
                              int P, int D, int n_partial, void* partial, void* ticket,
                              void* out, void* stream) {
  if (bad_shape(C, P, D, 0)) return (int)cudaErrorInvalidValue;
  const int n_blocks = point_blocks(D * P, kCostThreads * kCostPairs);
  if (n_blocks > n_partial) return (int)cudaErrorInvalidValue;
  cost_kernel<<<n_blocks, kCostThreads, 0, (cudaStream_t)stream>>>(
      (const float*)camc, (const float*)pt, (const int*)slot, (const float*)mask,
      (const float*)uv, (const float*)scal, C, P, D, (float*)partial, (int*)ticket,
      (float*)out);
  return (int)cudaGetLastError();
}

// (Slot, point) pairs of one CTA of the cost: the size of its partials.
extern "C" int ba_global_cost_pairs_per_block() { return kCostThreads * kCostPairs; }

// Threads of a tile CTA: the order of the per-camera sums depends on it.
extern "C" int ba_global_tile_threads() { return kTileThreads; }
