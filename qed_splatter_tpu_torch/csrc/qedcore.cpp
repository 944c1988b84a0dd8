// qedcore: the host geometry core of the PyTorch port.
//
// Voxel-grid downsampling, nearest-neighbour distances and depth-map
// backprojection on the host, multithreaded: the pieces the reference
// delegated to Open3D's C++ core, used by the init-pointcloud tool and the
// point-cloud metrics. It computes what the JAX package's native/qedcore.cpp
// computes (this file is a copy of it), and is built at first use by
// qed_splatter_tpu_torch/native.py with g++ for the baseline of the host's
// architecture (no -march=native: the library must run on whichever host
// loads it). ops/voxel.py and ops/knn.py hold its plain PyTorch versions.
//
// C ABI only (consumed via ctypes).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
  int64_t x, y, z;
  bool operator==(const CellKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct CellHash {
  size_t operator()(const CellKey& k) const {
    // large-prime mix (same spirit as Open3D's voxel hash)
    uint64_t h = static_cast<uint64_t>(k.x) * 73856093ull ^
                 static_cast<uint64_t>(k.y) * 19349669ull ^
                 static_cast<uint64_t>(k.z) * 83492791ull;
    return static_cast<size_t>(h);
  }
};

inline int64_t cell_of(float v, float inv_voxel) {
  return static_cast<int64_t>(std::floor(v * inv_voxel));
}

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  int nt = std::min<int64_t>(hardware_threads(), std::max<int64_t>(n, 1));
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Average points (and optional colors) per voxel. Returns the number of
// output points written to out_positions/out_colors (capacity must be >= n).
// colors may be null. Matches ops/voxel.py semantics.
int64_t qed_voxel_downsample(const float* positions, const float* colors,
                             int64_t n, float voxel_size,
                             float* out_positions, float* out_colors) {
  if (n <= 0 || voxel_size <= 0.f) return 0;
  float inv = 1.0f / voxel_size;
  struct Acc {
    double px = 0, py = 0, pz = 0, cr = 0, cg = 0, cb = 0;
    int64_t count = 0;
  };
  std::unordered_map<CellKey, Acc, CellHash> cells;
  cells.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const float* p = positions + 3 * i;
    CellKey k{cell_of(p[0], inv), cell_of(p[1], inv), cell_of(p[2], inv)};
    Acc& a = cells[k];
    a.px += p[0]; a.py += p[1]; a.pz += p[2];
    if (colors) {
      const float* c = colors + 3 * i;
      a.cr += c[0]; a.cg += c[1]; a.cb += c[2];
    }
    a.count++;
  }
  int64_t m = 0;
  for (const auto& kv : cells) {
    const Acc& a = kv.second;
    out_positions[3 * m + 0] = static_cast<float>(a.px / a.count);
    out_positions[3 * m + 1] = static_cast<float>(a.py / a.count);
    out_positions[3 * m + 2] = static_cast<float>(a.pz / a.count);
    if (colors && out_colors) {
      out_colors[3 * m + 0] = static_cast<float>(a.cr / a.count);
      out_colors[3 * m + 1] = static_cast<float>(a.cg / a.count);
      out_colors[3 * m + 2] = static_cast<float>(a.cb / a.count);
    }
    m++;
  }
  return m;
}

// Nearest-neighbor distance from each query to the reference cloud via a
// uniform grid hash with expanding-ring search. Exact (the ring bound is
// grown until it provably contains the nearest neighbor). Multithreaded.
// Backs PDMetrics accuracy/completeness (reference metrics.py:35-63).
void qed_nn_distances(const float* queries, int64_t nq, const float* refs,
                      int64_t nr, float cell_size, float* out_dist) {
  if (nq <= 0) return;
  if (nr <= 0) {
    for (int64_t i = 0; i < nq; ++i) out_dist[i] = INFINITY;
    return;
  }
  if (cell_size <= 0.f) {
    // heuristic: bounding-box volume per point, cubed root
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int64_t i = 0; i < nr; ++i)
      for (int d = 0; d < 3; ++d) {
        lo[d] = std::min(lo[d], refs[3 * i + d]);
        hi[d] = std::max(hi[d], refs[3 * i + d]);
      }
    double vol = 1.0;
    for (int d = 0; d < 3; ++d)
      vol *= std::max(1e-6, static_cast<double>(hi[d] - lo[d]));
    cell_size = static_cast<float>(std::cbrt(vol / nr)) * 2.0f;
    if (!(cell_size > 0.f)) cell_size = 1.0f;
  }
  float inv = 1.0f / cell_size;
  std::unordered_map<CellKey, std::vector<int32_t>, CellHash> grid;
  grid.reserve(static_cast<size_t>(nr));
  int64_t cell_lo[3] = {INT64_MAX, INT64_MAX, INT64_MAX};
  int64_t cell_hi[3] = {INT64_MIN, INT64_MIN, INT64_MIN};
  for (int64_t i = 0; i < nr; ++i) {
    const float* p = refs + 3 * i;
    CellKey k{cell_of(p[0], inv), cell_of(p[1], inv), cell_of(p[2], inv)};
    grid[k].push_back(static_cast<int32_t>(i));
    int64_t kc[3] = {k.x, k.y, k.z};
    for (int d = 0; d < 3; ++d) {
      cell_lo[d] = std::min(cell_lo[d], kc[d]);
      cell_hi[d] = std::max(cell_hi[d], kc[d]);
    }
  }

  parallel_for(nq, [&](int64_t lo_i, int64_t hi_i) {
    for (int64_t i = lo_i; i < hi_i; ++i) {
      const float* q = queries + 3 * i;
      // search rings around the query cell CLAMPED into the occupied grid
      // bbox: rings around a far-away query cell would otherwise sweep an
      // unbounded sea of empty cells (observed multi-minute hangs on
      // disjoint clouds)
      int64_t qc[3] = {cell_of(q[0], inv), cell_of(q[1], inv),
                       cell_of(q[2], inv)};
      int64_t cx = std::clamp(qc[0], cell_lo[0], cell_hi[0]);
      int64_t cy = std::clamp(qc[1], cell_lo[1], cell_hi[1]);
      int64_t cz = std::clamp(qc[2], cell_lo[2], cell_hi[2]);
      // distance from the query to the clamped cell's center (loose bound
      // used in the termination rule)
      float ccx = (cx + 0.5f) * cell_size, ccy = (cy + 0.5f) * cell_size,
            ccz = (cz + 0.5f) * cell_size;
      float dq = std::sqrt((q[0] - ccx) * (q[0] - ccx) +
                           (q[1] - ccy) * (q[1] - ccy) +
                           (q[2] - ccz) * (q[2] - ccz));
      int64_t max_ring = 0;
      for (int d = 0; d < 3; ++d)
        max_ring = std::max(max_ring, cell_hi[d] - cell_lo[d] + 1);
      float best = INFINITY;
      for (int64_t ring = 0; ring <= max_ring; ++ring) {
        for (int64_t dx = -ring; dx <= ring; ++dx)
          for (int64_t dy = -ring; dy <= ring; ++dy)
            for (int64_t dz = -ring; dz <= ring; ++dz) {
              if (std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) !=
                  ring)
                continue;  // shell only
              auto it = grid.find({cx + dx, cy + dy, cz + dz});
              if (it == grid.end()) continue;
              for (int32_t j : it->second) {
                const float* r = refs + 3 * j;
                float ddx = q[0] - r[0], ddy = q[1] - r[1], ddz = q[2] - r[2];
                float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                best = std::min(best, d2);
              }
            }
        // every unexplored cell lies at Chebyshev > ring from the clamped
        // cell, i.e. at distance > ring*cell - dq - cell_diag from the query
        float safe = ring * cell_size - dq - 1.7321f * cell_size;
        if (safe > 0.0f && best <= safe * safe) break;
      }
      out_dist[i] = std::sqrt(best);
    }
  });
}

// Backproject a depth map to world points (OpenCV camera, row-major K and
// 4x4 c2w). Writes ceil(h/stride)*ceil(w/stride) points; invalid -> NaN.
// Matches ops/backproject.py (pixel centers at +0.5).
void qed_backproject(const float* depth, int64_t h, int64_t w, const float* K,
                     const float* c2w, float depth_max, int64_t stride,
                     float* out_points) {
  float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const float* R = c2w;  // rows of 4x4
  int64_t oh = (h + stride - 1) / stride, ow = (w + stride - 1) / stride;
  parallel_for(oh, [&](int64_t lo, int64_t hi) {
    for (int64_t oy = lo; oy < hi; ++oy) {
      for (int64_t ox = 0; ox < ow; ++ox) {
        int64_t sy = oy * stride, sx = ox * stride;
        float z = depth[sy * w + sx];
        float* out = out_points + 3 * (oy * ow + ox);
        if (!(z > 0.f) || !(z <= depth_max) || !std::isfinite(z)) {
          out[0] = out[1] = out[2] = NAN;
          continue;
        }
        float x = (sx + 0.5f - cx) / fx * z;
        float y = (sy + 0.5f - cy) / fy * z;
        out[0] = R[0] * x + R[1] * y + R[2] * z + R[3];
        out[1] = R[4] * x + R[5] * y + R[6] * z + R[7];
        out[2] = R[8] * x + R[9] * y + R[10] * z + R[11];
      }
    }
  });
}

int qed_version() { return 1; }

}  // extern "C"
