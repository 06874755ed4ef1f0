// Host runtime of bundle_adjustment_tpu_torch: the port's own copy of the
// JAX package's native/ba_host.cpp (the same C API, unchanged).
//
// The card owns the heavy math; what remains on the host is the world-model
// bookkeeping that grows with sequence length.  The two hot paths are:
//
//  - observation-table window gathering: the numpy path scans the whole
//    table (np.isin over n_obs rows) on every bundle-adjustment call; here a
//    per-keyframe row index makes it O(rows in window),
//  - voxel-grid downsampling for point-cloud export (numpy's unique(axis=0)
//    is O(n log n) with a big constant; a hash grid is O(n)).
//
// Exposed as a plain C API consumed via ctypes
// (bundle_adjustment_tpu_torch/native.py), which builds this file with g++
// at first use (g++ only, no dependencies).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct ObsTable {
  std::vector<int64_t> kf, mp, kp;
  std::vector<double> uv;        // 2 per row
  std::vector<uint8_t> alive;
  // row index by keyframe id for O(window) gathers
  std::unordered_map<int64_t, std::vector<int64_t>> rows_by_kf;
};

struct VoxelKey {
  int64_t x, y, z;
  bool operator==(const VoxelKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct VoxelHash {
  size_t operator()(const VoxelKey& k) const {
    // large-prime mix (same family as open3d's voxel hash)
    return static_cast<size_t>(k.x * 73856093LL ^ k.y * 19349669LL ^
                               k.z * 83492791LL);
  }
};

}  // namespace

extern "C" {

void* obs_create() { return new ObsTable(); }

void obs_destroy(void* t) { delete static_cast<ObsTable*>(t); }

int64_t obs_size(void* t) {
  return static_cast<int64_t>(static_cast<ObsTable*>(t)->kf.size());
}

// Append n rows; returns the first new row id.
int64_t obs_append(void* tp, int64_t n, const int64_t* kf, const int64_t* mp,
                   const int64_t* kp, const double* uv) {
  ObsTable* t = static_cast<ObsTable*>(tp);
  int64_t base = static_cast<int64_t>(t->kf.size());
  t->kf.insert(t->kf.end(), kf, kf + n);
  t->mp.insert(t->mp.end(), mp, mp + n);
  t->kp.insert(t->kp.end(), kp, kp + n);
  t->uv.insert(t->uv.end(), uv, uv + 2 * n);
  t->alive.insert(t->alive.end(), n, 1);
  for (int64_t i = 0; i < n; ++i) t->rows_by_kf[kf[i]].push_back(base + i);
  return base;
}

void obs_kill_rows(void* tp, int64_t n, const int64_t* rows) {
  ObsTable* t = static_cast<ObsTable*>(tp);
  for (int64_t i = 0; i < n; ++i) t->alive[rows[i]] = 0;
}

// Kill all observations of the given (sorted or not) map-point ids.
void obs_kill_mps(void* tp, int64_t n, const int64_t* mps) {
  ObsTable* t = static_cast<ObsTable*>(tp);
  std::unordered_map<int64_t, char> dead;
  dead.reserve(n * 2);
  for (int64_t i = 0; i < n; ++i) dead.emplace(mps[i], 1);
  const int64_t total = static_cast<int64_t>(t->mp.size());
  for (int64_t r = 0; r < total; ++r)
    if (t->alive[r] && dead.count(t->mp[r])) t->alive[r] = 0;
}

// Gather live rows of the given window keyframes.  Fills out_rows (caller
// allocates >= capacity); returns the row count (clipped to capacity).
int64_t obs_gather_window(void* tp, int64_t n_window, const int64_t* wkf,
                          int64_t* out_rows, int64_t capacity) {
  ObsTable* t = static_cast<ObsTable*>(tp);
  int64_t n = 0;
  for (int64_t w = 0; w < n_window; ++w) {
    auto it = t->rows_by_kf.find(wkf[w]);
    if (it == t->rows_by_kf.end()) continue;
    for (int64_t r : it->second) {
      if (!t->alive[r]) continue;
      if (n < capacity) out_rows[n] = r;
      ++n;
    }
  }
  return n < capacity ? n : capacity;
}

// Copy row data for the given rows into the output arrays.
void obs_fetch_rows(void* tp, int64_t n, const int64_t* rows, int64_t* kf,
                    int64_t* mp, int64_t* kp, double* uv) {
  ObsTable* t = static_cast<ObsTable*>(tp);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = rows[i];
    kf[i] = t->kf[r];
    mp[i] = t->mp[r];
    kp[i] = t->kp[r];
    uv[2 * i] = t->uv[2 * r];
    uv[2 * i + 1] = t->uv[2 * r + 1];
  }
}

// Count live observations per map point into counts[0..n_points).
void obs_counts_per_point(void* tp, int64_t n_points, int64_t* counts) {
  ObsTable* t = static_cast<ObsTable*>(tp);
  std::memset(counts, 0, sizeof(int64_t) * n_points);
  const int64_t total = static_cast<int64_t>(t->mp.size());
  for (int64_t r = 0; r < total; ++r)
    if (t->alive[r] && t->mp[r] < n_points) ++counts[t->mp[r]];
}

int64_t obs_live_count(void* tp) {
  ObsTable* t = static_cast<ObsTable*>(tp);
  int64_t n = 0;
  for (uint8_t a : t->alive) n += a;
  return n;
}

// Voxel-grid average downsample.  points/colors: (n, 3) float64 (colors may
// be null).  Writes averaged output; returns the voxel count.
int64_t voxel_downsample(const double* points, const double* colors, int64_t n,
                         double voxel, double* out_points, double* out_colors) {
  std::unordered_map<VoxelKey, int64_t, VoxelHash> index;
  index.reserve(n * 2);
  std::vector<double> acc_p, acc_c;
  std::vector<int64_t> cnt;
  const double inv = 1.0 / voxel;
  for (int64_t i = 0; i < n; ++i) {
    VoxelKey k{static_cast<int64_t>(std::floor(points[3 * i] * inv)),
               static_cast<int64_t>(std::floor(points[3 * i + 1] * inv)),
               static_cast<int64_t>(std::floor(points[3 * i + 2] * inv))};
    auto [it, inserted] = index.try_emplace(k, static_cast<int64_t>(cnt.size()));
    if (inserted) {
      acc_p.insert(acc_p.end(), 3, 0.0);
      if (colors) acc_c.insert(acc_c.end(), 3, 0.0);
      cnt.push_back(0);
    }
    const int64_t v = it->second;
    for (int d = 0; d < 3; ++d) acc_p[3 * v + d] += points[3 * i + d];
    if (colors)
      for (int d = 0; d < 3; ++d) acc_c[3 * v + d] += colors[3 * i + d];
    ++cnt[v];
  }
  const int64_t n_vox = static_cast<int64_t>(cnt.size());
  for (int64_t v = 0; v < n_vox; ++v) {
    for (int d = 0; d < 3; ++d)
      out_points[3 * v + d] = acc_p[3 * v + d] / cnt[v];
    if (colors && out_colors)
      for (int d = 0; d < 3; ++d)
        out_colors[3 * v + d] = acc_c[3 * v + d] / cnt[v];
  }
  return n_vox;
}

}  // extern "C"
